"""Multi-host bring-up: jax.distributed initialization.

The reference's multi-node story is MPI: every rank calls PetscInitialize
(which runs MPI_Init) and DMDA decomposes grids across all ranks
(reference: cartesianmesh.cpp:492-538).  The JAX analogue is one process
per host calling ``jax.distributed.initialize``; afterwards
``jax.devices()`` spans every host's devices, and the existing
``parameters.sharding`` node shards fields over them with GSPMD routing
halo exchanges over the interconnect within a host (NVLink on GPUs) and
the network across hosts (docs/distributed.md).

Config (YAML or API dict):

  parameters:
    distributed: true            # auto-detect: only where a cluster
                                 # environment (e.g. SLURM) describes it
    # or explicit:
    distributed:
      coordinator: "10.0.0.1:1234"
      numProcesses: 4
      processId: 0               # or from env, see below

Environment fallbacks (useful for launchers that template env vars):
PETIBM_COORDINATOR, PETIBM_NUM_PROCESSES, PETIBM_PROCESS_ID.
A plain GPU host has no such environment: give all three explicitly.
"""

from __future__ import annotations

import os

_INITIALIZED = False


def is_initialized() -> bool:
    """Whether this (or any prior) call brought jax.distributed up."""
    if _INITIALIZED:
        return True
    try:
        from jax._src import distributed

        return distributed.global_state.client is not None
    except Exception:
        return False


def maybe_initialize(node=None) -> bool:
    """Initialize jax.distributed if requested and not already up.

    ``node`` is the ``parameters.distributed`` config value: absent/falsy
    means single-process (no-op) unless the PETIBM_DISTRIBUTED env var
    opts in; ``true`` means auto-detect; a dict supplies explicit
    coordinator/numProcesses/processId.  Returns True when jax.distributed
    is (now) initialized.
    """
    global _INITIALIZED
    if node is None and os.environ.get("PETIBM_DISTRIBUTED", "") not in (
            "", "0", "false"):
        node = True
    if not node:
        return is_initialized()
    if is_initialized():
        return True

    kwargs = {}
    explicit = node if isinstance(node, dict) else {}
    coord = explicit.get("coordinator",
                         os.environ.get("PETIBM_COORDINATOR"))
    nproc = explicit.get("numProcesses",
                         os.environ.get("PETIBM_NUM_PROCESSES"))
    pid = explicit.get("processId", os.environ.get("PETIBM_PROCESS_ID"))
    if coord is not None:
        kwargs["coordinator_address"] = str(coord)
    if nproc is not None:
        kwargs["num_processes"] = int(nproc)
    if pid is not None:
        kwargs["process_id"] = int(pid)

    import jax

    if kwargs.get("num_processes", None) in (None, 1) and not kwargs.get(
            "coordinator_address"):
        # single-process degenerate run: nothing to coordinate; initialize()
        # without cluster metadata would block on auto-detection, so treat
        # this as already-up (the weak-scaling harness exercises this path)
        _INITIALIZED = True
        return True
    jax.distributed.initialize(**kwargs)
    _INITIALIZED = True
    return True


def process_info() -> tuple[int, int]:
    """(process_id, num_processes) — (0, 1) when not distributed."""
    import jax

    return jax.process_index(), jax.process_count()
