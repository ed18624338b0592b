"""Native JAX linear solvers: matrix-free Krylov methods over pytrees.

Replaces the reference's PETSc KSP / NVIDIA AmgX backends
(reference: src/linsolver/).  Operators are closures; dot products are
global reductions that XLA lowers to psum over the device mesh when the
operands are sharded.
"""

from .krylov import (  # noqa: F401
    SolveResult,
    SolverDivergedError,
    bicgstab,
    cg,
    make_solver,
)
from .probe_diag import extract_diagonal  # noqa: F401
