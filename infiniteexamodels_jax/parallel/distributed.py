"""Multi-host (multi-process) distribution scaffolding.

The reference stack has no distributed communication layer at all (no
MPI/NCCL anywhere, SURVEY.md §2b); here it is ``jax.distributed`` process
initialization plus a global device mesh whose scenario axis spans hosts:
XLA hands the collectives to NCCL on GPUs, within a host over NVLink and
across hosts over the network.  All of the sharding machinery in
:mod:`.sharding` and the mesh-distributed KKT factorization are expressed against a ``Mesh`` and are
agnostic to whether its devices live on one process or many -- this module
only supplies the process bootstrap and the global mesh constructor.

Launch pattern (one command per host)::

    python -m infiniteexamodels_jax.parallel.distributed \
        --coordinator=HOST0:1234 --num-processes=2 --process-id=K \
        your_script.py

or call :func:`initialize` at the top of the driver script.  Validated in
CI by a 2-process CPU launch (tests/test_multihost.py) where each process
contributes 4 virtual devices to an 8-device global mesh.
"""
from __future__ import annotations

import numpy as np

import jax

from .sharding import make_mesh  # noqa: F401  (re-export convenience)


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None):
    """Bootstrap this process into the multi-host runtime
    (``jax.distributed.initialize``).  Pass the coordinator address
    (``host:port``), the process count and this process's id explicitly:
    nothing in a plain GPU or CPU environment lets JAX detect them.  Safe
    to call once per process, before any backend use."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def global_mesh(axis="sp"):
    """A 1-D mesh over ALL devices of ALL processes, scenario axis first.
    With multiple processes, ``jax.devices()`` already enumerates the
    global device set; ordering groups each process's devices together so
    a scenario-sharded axis keeps cross-host traffic to the Schur-corner
    reduction."""
    return jax.sharding.Mesh(np.array(jax.devices()), (axis,))


def process_info():
    """(process_index, process_count, local_device_count, global_devices)"""
    return (jax.process_index(), jax.process_count(),
            jax.local_device_count(), jax.device_count())
