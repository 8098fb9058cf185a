"""Device-derived settings: the compile-cache placement, the device
refactorization's memory budget, and the card check of chip_smoke.py."""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

from tpu_sparse_lu import ParallelSparseLU, SolverConfig, api
from tpu_sparse_lu.models import poisson_2d
from tpu_sparse_lu.utils import compile_cache

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _record_config_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_compile_cache_env_dir_wins(monkeypatch, tmp_path):
    """With $JAX_COMPILATION_CACHE_DIR set, JAX keeps it and the helper
    sets no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    calls = _record_config_updates(monkeypatch)
    path = compile_cache.use_compile_cache(str(tmp_path), min_compile_secs=1)
    assert path == str(tmp_path / "env")
    assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 1


def test_compile_cache_default_in_checkout(monkeypatch, tmp_path):
    """Unset, the cache lands in the fixed in-checkout directory, which
    .gitignore lists."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_config_updates(monkeypatch)
    path = compile_cache.use_compile_cache(str(tmp_path))
    assert path == os.path.join(str(tmp_path), ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == path
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_memory_budget_reads_bytes_limit():
    assert api.device_memory_budget(_FakeDevice(
        {"bytes_limit": 60 * 1024**3, "bytes_in_use": 1})) == 60 * 1024**3
    # backends without a limit (the CPU) impose no device budget
    assert api.device_memory_budget(_FakeDevice(None)) is None
    assert api.device_memory_budget(_FakeDevice({"bytes_in_use": 1})) is None


def test_refactor_budget_follows_device_memory(rng, monkeypatch):
    """The guard's default ceiling is the device's own limit; a per-config
    budget still wins over it."""
    A = poisson_2d(12, 12)
    cfg = SolverConfig(chunk_size=16, tri_mode="inv", dtype="float32")
    monkeypatch.setattr(api, "device_memory_budget", lambda: 1024)
    F = ParallelSparseLU(A, config=cfg)
    with pytest.raises(RuntimeError, match="working set"):
        F.enable_device_refactor()
    assert not F.has_device_refactor
    G = ParallelSparseLU(A, config=SolverConfig(
        chunk_size=16, tri_mode="inv", dtype="float32",
        refactor_store_budget=8 * 1024**3))
    G.enable_device_refactor()
    assert G.has_device_refactor
    # no reported limit: no device budget applies
    monkeypatch.setattr(api, "device_memory_budget", lambda: None)
    F.enable_device_refactor()
    assert F.has_device_refactor


def test_refactor_footprint_is_the_guards_estimate(monkeypatch):
    """refactor_footprint() reports the estimate the guard checks and the
    budget it checks it against: a budget just below the estimate is
    refused, one at the estimate admitted."""
    A = poisson_2d(12, 12)
    cfg = SolverConfig(chunk_size=16, tri_mode="inv", dtype="float32")
    monkeypatch.setattr(api, "device_memory_budget", lambda: None)
    nbytes, budget = ParallelSparseLU(A, config=cfg).refactor_footprint()
    assert budget is None and nbytes > 0
    monkeypatch.setattr(api, "device_memory_budget", lambda: nbytes - 1)
    with pytest.raises(RuntimeError, match="working set"):
        ParallelSparseLU(A, config=cfg).enable_device_refactor()
    monkeypatch.setattr(api, "device_memory_budget", lambda: nbytes)
    F = ParallelSparseLU(A, config=cfg)
    assert F.refactor_footprint() == (nbytes, nbytes)
    assert not F.has_device_refactor  # reporting installs nothing
    F.enable_device_refactor()
    assert F.refactor_footprint() == (nbytes, nbytes)


def test_chip_smoke_refuses_without_gpu():
    """chip_smoke.py never times or checks the CPU in the card's place: on
    a machine with no GPU it exits non-zero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout
