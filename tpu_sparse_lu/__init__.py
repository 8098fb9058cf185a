"""tpu-sparse-lu: a GPU sparse LU factorization + triangular-solve library
(JAX) with the capabilities of SharedMemSparseLU.jl.

Public API (reference parity, SURVEY.md §2):

* :class:`ParallelSparseLU` — factor once, solve many, refactor in place.
* :func:`cleanup_ParallelSparseLU` — buffer release (reference export, src:31).
* :func:`allocate_shared` — mesh-sharded device array allocation, the
  analogue of the reference's MPI shared-memory window export.
* Symbolic layer: :func:`factorize_host`, :class:`SymbolicPlan`.
"""

from .api import ParallelSparseLU, cleanup_ParallelSparseLU
from .symbolic import (
    HostFactors,
    SymbolicPlan,
    TriPlan,
    build_symbolic_plan,
    factorize_host,
    plan_triangular,
)
from .utils.config import SolverConfig, default_chunk_size
from .parallel.mesh import allocate_shared

__all__ = [
    "ParallelSparseLU",
    "cleanup_ParallelSparseLU",
    "allocate_shared",
    "HostFactors",
    "SymbolicPlan",
    "TriPlan",
    "build_symbolic_plan",
    "factorize_host",
    "plan_triangular",
    "SolverConfig",
    "default_chunk_size",
]

__version__ = "0.1.0"
