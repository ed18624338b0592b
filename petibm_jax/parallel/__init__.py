"""Distribution over a jax device mesh.

Replaces the reference's MPI/PETSc DMDA domain decomposition
(reference: cartesianmesh.cpp:492-538, SURVEY.md §2 backend row).  Fields
are dense arrays sharded over a ``jax.sharding.Mesh``; XLA GSPMD inserts
the halo exchanges for the stencil slice arithmetic and lowers the Krylov
dot products to psum collectives — there is no hand-written halo code, exactly
as the reference has none (PETSc's DMGlobalToLocal fills the same role).
"""

from .multihost import (  # noqa: F401
    is_initialized,
    maybe_initialize,
    process_info,
)
from .dist import (  # noqa: F401
    FIELD_KEYS,
    constrain_fields,
    constrain_state,
    device_mesh,
    mesh_from_config,
    shard_state,
    sharded_step,
    state_shardings,
)
