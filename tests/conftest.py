"""Test environment: CPU JAX with 8 virtual devices and x64 enabled (or the
GPU, for the ``gpu``-marked tests; see below).

The reference's accuracy bars (1e-12 sparse / 1e-10 dense,
/root/reference/test/runtests.jl:25-26) require float64, and multi-device
sharding tests run on a simulated CPU mesh (SURVEY.md §4 CI analogue).
Must run before jax is imported anywhere.
"""

import os

# The suite runs on the CPU. SPARSE_LU_TESTS_ON_GPU=1 leaves JAX's platform
# alone instead, for the ``gpu``-marked tests on a machine with a card:
#     SPARSE_LU_TESTS_ON_GPU=1 python -m pytest tests -m gpu
ON_GPU = os.environ.get("SPARSE_LU_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    # the config route wins even if jax was imported before this file, as
    # long as no backend has been initialized
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tpu_sparse_lu.utils.compile_cache import use_compile_cache  # noqa: E402

# persistent compile cache: repeated test shapes compile once across runs
use_compile_cache(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  min_compile_secs=0.2)


@pytest.fixture
def rng():
    # Seeded like the reference suite (MersenneTwister(47), runtests.jl:35)
    return np.random.default_rng(47)
