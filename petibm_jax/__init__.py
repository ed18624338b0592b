"""petibm_jax — immersed-boundary CFD framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the
reference PETSc/MPI toolbox (barbagroup/PetIBM): incompressible
Navier-Stokes on 2D/3D staggered stretched Cartesian grids via the
projection (fractional-step) method, plus the immersed-boundary projection
method (IBPM), its decoupled variant, and prescribed-kinematics moving
bodies.  Fields are dense (optionally pjit-sharded) arrays; operators are
fused stencil closures; linear solves are native matrix-free Krylov (+
multigrid) under jit.
"""

__version__ = "0.1.0"

from . import config, mesh, boundary, operators, linalg, timeintegration, ics  # noqa: F401
from .mesh import StaggeredMesh  # noqa: F401
from .boundary import BoundarySet  # noqa: F401
