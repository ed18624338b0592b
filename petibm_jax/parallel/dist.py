"""Device-mesh creation and state sharding.

Strategy (SURVEY.md §2 parallelism checklist): the only parallelism in this
problem class is spatial domain decomposition.  The pressure/velocity grids
are block-partitioned over a 2D device mesh (axes named "dy", "dx"
sharding the trailing two array axes); in 3D the z axis stays local, which
matches the bandwidth-optimal layout for x-fastest arrays.  Small per-face
BC arrays and solver scalars are replicated.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _factor2(n: int) -> tuple[int, int]:
    """Near-square factorization n = a*b with a <= b."""
    a = int(math.isqrt(n))
    while a > 1 and n % a != 0:
        a -= 1
    return a, n // a


def device_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A ("dy", "dx") mesh over the available (or given) devices."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    n = len(devices)
    a, b = _factor2(n)
    return Mesh(np.asarray(devices).reshape(a, b), ("dy", "dx"))


def _leaf_spec(leaf, mesh: Mesh | None = None) -> P:
    """PartitionSpec for one state leaf: shard the trailing two axes of
    field arrays over ("dy","dx") — plus the z axis over "dz" when the
    mesh carries that axis (3-axis meshes, see mesh_from_config) — and
    replicate 1D/scalar leaves (BC faces, stats).  2D arrays on a 3-axis
    mesh stay replicated along "dz"."""
    ndim = getattr(leaf, "ndim", 0)
    has_dz = mesh is not None and "dz" in mesh.axis_names
    if ndim >= 3 and has_dz:
        return P(*([None] * (ndim - 3) + ["dz", "dy", "dx"]))
    if ndim >= 2:
        return P(*([None] * (ndim - 2) + ["dy", "dx"]))
    return P()


def state_shardings(mesh: Mesh, state):
    return jax.tree_util.tree_map(
        lambda leaf: NamedSharding(mesh, _leaf_spec(leaf, mesh)), state)


def shard_state(mesh: Mesh, state):
    """Place a state pytree onto the device mesh (requires divisible dims —
    prefer :func:`constrain_state` inside jit for staggered grids, whose
    per-field sizes differ by one and cannot all divide the mesh)."""
    return jax.device_put(state, state_shardings(mesh, state))


def constrain_state(mesh: Mesh, state):
    """Annotate a state pytree with mesh shardings inside jit.

    Unlike explicit input shardings, ``with_sharding_constraint`` accepts
    uneven dimensions (GSPMD pads internally), which is exactly what the
    staggered grids need: u is (ny, nx-1) while p is (ny, nx).
    """
    return jax.tree_util.tree_map(
        lambda leaf: jax.lax.with_sharding_constraint(
            leaf, NamedSharding(mesh, _leaf_spec(leaf, mesh))), state)


# solver-state keys holding Eulerian grid fields (sharded); everything else
# (Lagrangian forces f/df, per-face BC arrays, scalars) stays replicated —
# the analogue of the reference's replicated body coordinates
# (singlebody.h:49-53) next to DMDA-decomposed fields
FIELD_KEYS = ("q", "p", "dP", "conv", "diff")


def constrain_fields(mesh: Mesh, state: dict) -> dict:
    """Sharding-constrain the grid-field entries of a solver state dict,
    leaving Lagrangian/BC leaves replicated."""
    fields = {k: state[k] for k in FIELD_KEYS if k in state}
    return dict(state, **constrain_state(mesh, fields))


def sharded_step(mesh: Mesh, step):
    """Wrap a state->(state, stats) step so grid fields carry mesh-sharding
    constraints on the way in and out: under jit, GSPMD partitions every
    stencil (inserting halo exchanges) and Krylov reduction (psum).
    Steady-state steps are sharded-in/sharded-out with no resharding."""

    def wrapped(state):
        state = constrain_fields(mesh, state)
        new_state, stats = step(state)
        return constrain_fields(mesh, new_state), stats

    return wrapped


def mesh_from_config(node: dict | None) -> Mesh | None:
    """Device mesh from the ``parameters.sharding`` config node.

    Keys (all optional): ``nDevices`` (default: all), ``platform`` (restrict
    to a backend, e.g. ``cpu`` for the virtual test mesh), ``shape``
    ([dy, dx] — or [dz, dy, dx] for a 3-axis mesh that decomposes the z
    direction too, the layout a >= 2-host 3D pod run wants).  Returns None
    when the node is absent or selects a single device (sharding then adds
    pure overhead)."""
    if not node:
        return None
    if node.get("platform"):
        devices = jax.devices(str(node["platform"]))
    else:
        devices = jax.devices()
    n = int(node.get("nDevices", len(devices)))
    if n > len(devices):
        raise ValueError(
            f"sharding.nDevices={n} but only {len(devices)} devices visible")
    devices = devices[:n]
    if len(devices) < 2:
        return None
    if node.get("shape"):
        dims = [int(v) for v in node["shape"]]
        if math.prod(dims) != len(devices):
            raise ValueError(
                f"sharding.shape {dims} != nDevices {len(devices)}")
        names = ("dy", "dx") if len(dims) == 2 else ("dz", "dy", "dx")
        if len(dims) not in (2, 3):
            raise ValueError("sharding.shape wants 2 or 3 entries")
    else:
        dims = list(_factor2(len(devices)))
        names = ("dy", "dx")
    return Mesh(np.asarray(devices).reshape(dims), names)
