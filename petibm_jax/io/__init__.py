"""HDF5/XDMF/ASCII I/O with reference-compatible file layouts."""

from .hdf5 import (  # noqa: F401
    read_restart_histories,
    read_solution,
    read_time,
    require_h5py,
    write_grid,
    write_restart_histories,
    write_solution,
    write_time,
)
