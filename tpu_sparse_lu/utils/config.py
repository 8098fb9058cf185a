"""Solver configuration.

The reference keeps configuration minimal: a single ``chunk_size`` kwarg
(default 8, clamped to n — /root/reference/src/SharedMemSparseLU.jl:64-72)
plus type parameters ``{Tf, Ti}``. We mirror that restraint with one small
frozen dataclass; there is no global flag registry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static configuration for a :class:`ParallelSparseLU` factorization.

    Attributes:
      chunk_size: dense tile edge for the block decomposition of L and U
        (the reference's ``chunk_size``, src:64-72). ``None`` → size-based
        policy in :func:`default_chunk_size`.
      tri_mode: how per-level diagonal-tile triangular systems are solved.
        * ``"auto"``      — (default) the backend's pick
                            (:func:`backend_policy`; ``"trsm"`` on
                            every supported backend today). Mirrors the
                            reference's zero-boilerplate default
                            constructor (src:64-72).
        * ``"trsm"``      — batched ``lax.linalg.triangular_solve`` (exact;
                            matches the reference's BLAS ``trsv!``,
                            src:359/:384, to machine precision).
        * ``"inv"``       — multiply by precomputed tile inverses: the whole
                            solve becomes batched matmul.
        * ``"inv_refine"``— ``inv`` plus one residual-correction step per
                            tile solve (backward-stable at ~2x the matmuls).
      dtype: numeric dtype for factors and solves. ``None`` → inherit from
        the input matrix (float64 when x64 is enabled, else float32).
      matmul_precision: JAX matmul precision for all tile ops. Reduced-
        precision float32 products (TF32 tensor cores on the GPU keep ~3
        decimal digits) compound across hundreds of dependent levels of a
        level-scheduled solve, so the default is "highest" (full-f32
        products). "default" lets the backend pick its fast f32 mode for
        error-tolerant uses.
      schedule: level-schedule execution style.
        * ``"scan"``    — ``lax.scan`` over levels padded to the maximum
                          level width (compact program; best for long, thin
                          dependency chains such as banded matrices).
        * ``"unrolled"``— Python-unrolled levels with exact ragged widths
                          (no padding waste; best for wide, shallow DAGs).
        * ``"auto"``    — pick per-plan by a padding-waste heuristic.
    """

    chunk_size: Optional[int] = None
    tri_mode: str = "auto"
    dtype: Optional[str] = None
    matmul_precision: str = "highest"
    schedule: str = "auto"
    # Ordering: "colamd" (SuperLU default) or "nd" — chunk-aligned staged
    # nested dissection (ordering.py): embeds A with identity padding rows
    # so every chunk holds mutually-independent subdomain rows; measured on
    # 2D Poisson n=10k/cs=128: level depth 69 -> 9 with 6% row overhead and
    # less fill than COLAMD. "nd" factors WITHOUT row pivoting by default
    # (partial pivoting would scramble the alignment) — use
    # pivot_threshold to re-enable thresholded pivoting, and refine_steps
    # on ldiv for extra safety on non-diagonally-dominant matrices.
    ordering: str = "colamd"
    pivot_threshold: Optional[float] = None
    # nd base-subdomain size (default cs): larger -> fewer, denser
    # off-diagonal tiles and fewer levels at the price of more fill.
    # "auto" sweeps {cs, 2cs, 4cs} and keeps the candidate with the least
    # padded level-scan work (one trial factorization per candidate)
    nd_cutoff: object = None  # None | int | "auto"
    # device working-set ceiling (bytes) for enable_device_refactor's
    # memory guard; None -> the device's own memory limit
    # (api.device_memory_budget), or no limit where the backend reports none
    refactor_store_budget: Optional[int] = None

    # first-factorization backend: "host" (SuperLU via scipy, re-pivots;
    # the default) or "device" — skip SuperLU numeric entirely and run the
    # blocked device elimination (_refactor_pipeline) as the FIRST
    # factorization. "device" requires a static-diagonal-pivot ordering
    # ("nd", or "natural" with pivot_threshold=0.0): the pivot order is
    # then known from the pattern alone, so construction pays only
    # pattern planning + one device program instead of a full host
    # numeric factorization (the reference's construct-time C dependency,
    # src:74). "auto" picks "device" when the ordering is eligible,
    # else "host".
    factorize: str = "host"

    def __post_init__(self):
        if self.tri_mode not in ("auto", "trsm", "inv", "inv_refine"):
            raise ValueError(f"unknown tri_mode: {self.tri_mode!r}")
        if self.schedule not in ("scan", "unrolled", "auto"):
            raise ValueError(f"unknown schedule: {self.schedule!r}")
        if self.matmul_precision not in ("default", "high", "highest"):
            raise ValueError(
                f"unknown matmul_precision: {self.matmul_precision!r}"
            )
        if self.ordering not in ("colamd", "nd", "natural", "mmd"):
            raise ValueError(f"unknown ordering: {self.ordering!r}")
        if not (self.nd_cutoff is None or self.nd_cutoff == "auto"
                or isinstance(self.nd_cutoff, int)):
            raise ValueError(f"unknown nd_cutoff: {self.nd_cutoff!r}")
        if self.factorize not in ("host", "device", "auto"):
            raise ValueError(f"unknown factorize: {self.factorize!r}")


    @classmethod
    def from_dict(cls, d: dict) -> "SolverConfig":
        """Rebuild from ``dataclasses.asdict`` output, ignoring fields this
        version no longer has (files saved by older versions carry e.g.
        ``stream_dtype`` and ``use_pallas``)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class BackendPolicy:
    """Everything the solver decides from the JAX backend, in one place.

    Attributes:
      backend: ``"gpu"`` or ``"cpu"``.
      tri_mode: what ``tri_mode="auto"`` resolves to.
      scan_only: ``schedule="auto"`` always takes the ``lax.scan`` level
        executor (the unrolled one multiplies compile time by the level
        count; it only pays where per-op dispatch is cheap, on the CPU).
      tile_lu_kernel: the device refactorization may factor its diagonal
        tiles with the compiled tile-LU kernel (ops/pallas_factor.py)
        instead of the XLA rank-1 loop.
    """

    backend: str
    tri_mode: str
    scan_only: bool
    tile_lu_kernel: bool

    def use_tile_lu(self, cs: int, dtype) -> bool:
        """Whether the tile-LU kernel serves ``cs``-edge tiles of ``dtype``
        (a power-of-two edge up to 128, float32 or float64)."""
        from ..ops.pallas_factor import supports_lu_tile

        return self.tile_lu_kernel and supports_lu_tile(cs, dtype)


def backend_policy(backend: Optional[str] = None) -> BackendPolicy:
    """The :class:`BackendPolicy` of ``backend`` (default: JAX's default
    backend). Any backend other than ``"gpu"`` and ``"cpu"`` is an error:
    nothing in this package is tuned or tested for it."""
    if backend is None:
        import jax

        backend = jax.default_backend()
    if backend == "gpu":
        return BackendPolicy("gpu", tri_mode="trsm", scan_only=True,
                             tile_lu_kernel=True)
    if backend == "cpu":
        return BackendPolicy("cpu", tri_mode="trsm", scan_only=False,
                             tile_lu_kernel=False)
    raise ValueError(
        f"unsupported JAX backend {backend!r}: tpu_sparse_lu runs on "
        "'gpu' (CUDA) and 'cpu'"
    )


def default_chunk_size(n: int) -> int:
    """Chunk size the solver picks for an ``n``-row matrix when the user
    passes none: the reference defaults to 8 and clamps to n (src:67-72);
    larger problems get larger tiles."""
    if n <= 256:
        cs = 8
    elif n <= 4096:
        cs = 32
    else:
        cs = 64
    return max(1, min(cs, n))
