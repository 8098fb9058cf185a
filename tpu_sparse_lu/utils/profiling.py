"""Benchmark-harness observability (SURVEY.md §5.1, §5.5).

The reference library is silent (no timers/logging anywhere in src); we
keep the library core silent too and confine observability to this
opt-in helper used by bench.py and profiling scripts.

The primitive here is SLOPE TIMING: the measured program is built at two
chain lengths (the solve applied N times inside one jit) and the marginal
cost ``(t(N2) - t(N1)) / (N2 - N1)`` is reported, so fixed per-call costs
(dispatch, the final host pull) cancel. Reps of the two chains are
interleaved so drift cannot masquerade as slope; a longer third chain is
used when the iteration is too fast for the default lengths to resolve.
Whether it agrees with plain ``block_until_ready`` timing on the GPU is
not yet measured.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

N1_CHAIN = 64
N2_CHAIN = 512
N3_CHAIN = 4096  # escalation length when the iteration is too fast for N2
MIN_SIGNAL = 15e-3  # seconds of slope signal required over timing noise


def slope_time(make_chain, reps: int = 5) -> float:
    """Marginal seconds/iteration of ``chain(x0)`` where
    ``make_chain(N) -> (chain, x0)`` builds an N-iteration program.

    The chain body must be LIVE at every iteration (renormalize the
    carry; beware while-loop invariant code motion hoisting
    loop-invariant work out of the body).
    """
    import jax
    import numpy as np

    def timed(c, x0):
        t0 = time.perf_counter()
        np.asarray(jax.tree.leaves(c(x0))[0])
        return time.perf_counter() - t0

    c1, x1 = make_chain(N1_CHAIN)
    c2, x2 = make_chain(N2_CHAIN)
    timed(c1, x1)  # compile + warmup
    timed(c2, x2)
    t1s, t2s = [], []
    for _ in range(reps):  # interleave so drift cannot masquerade as slope
        t1s.append(timed(c1, x1))
        t2s.append(timed(c2, x2))
    t1, t2 = min(t1s), min(t2s)
    if t2 - t1 >= MIN_SIGNAL:
        return (t2 - t1) / (N2_CHAIN - N1_CHAIN)
    c3, x3 = make_chain(N3_CHAIN)
    timed(c3, x3)
    t3s = [timed(c3, x3) for _ in range(reps)]
    slope = (min(t3s) - t1) / (N3_CHAIN - N1_CHAIN)
    if slope <= 0.0:
        # even the escalation chain produced no signal: the iteration is
        # below the measurement floor. NaN (not 0) so downstream ratios
        # (nnz/t, t_base/t) flag as unresolved instead of dividing by zero
        return float("nan")
    return slope


def chain_time(exe_args_fn, b, reps: int = 5) -> float:
    """Marginal steady-state seconds per solve: ``f(v, *args)`` chained
    inside one jit via ``lax.fori_loop`` (the PDE time-stepper pattern),
    renormalized each iteration so 4096-deep chains stay finite in f32
    and every iteration stays live against while-loop LICM. The extra
    two vector ops are billed to the measured program, not the baseline.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    f, args = exe_args_fn

    def make_chain(N):
        # args MUST travel as jit arguments, not closure captures: a
        # closure-captured device array becomes an HLO CONSTANT of the
        # chain program, baked into (and recompiled with) every chain
        @jax.jit
        def chain(b, *a):
            def body(i, v):
                w = f(v, *a)
                return w / (jnp.max(jnp.abs(w)) + 1e-30)
            return lax.fori_loop(0, N, body, b)

        return (lambda x0: chain(x0, *args)), b

    return slope_time(make_chain, reps=reps)


def nnz_per_second(nnz: int, seconds: float, nrhs: int = 1) -> float:
    """The BASELINE.json throughput metric: factor nonzeros per second,
    scaled by the RHS panel width."""
    return nnz * nrhs / seconds


@contextlib.contextmanager
def device_trace(dirname: Optional[str]):
    """jax.profiler trace context (no-op when dirname is None)."""
    import jax

    if dirname is None:
        yield
        return
    with jax.profiler.trace(dirname):
        yield
