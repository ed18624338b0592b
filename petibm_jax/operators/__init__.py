"""Discrete staggered-grid operators as pure stencil functions.

JAX re-design of the reference's operator factories
(reference: include/petibm/operators.h:103-365).  Instead of assembling
PETSc AIJ matrices, every operator is a closure over precomputed 1D metric
arrays applied to dense field arrays by slicing arithmetic — XLA fuses the
slices, and GSPMD inserts halo exchanges automatically when the arrays are
sharded over a device mesh.
"""

from .stencil import (  # noqa: F401
    make_divergence,
    make_gradient,
    make_laplacian,
)
from .convection import make_convection  # noqa: F401
from .diag import (  # noqa: F401
    convert_to_flux,
    convert_to_velocity,
    make_flux_areas,
    make_m,
    make_mhat,
    make_r,
    make_rinv,
)
from .bn import make_bn  # noqa: F401
