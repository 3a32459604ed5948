"""Multi-host initialization helpers.

The reference has no distributed dimension (single-process Go); fennec-tpu
scales across GPUs and hosts the standard JAX way: jax.distributed +
jit/shard_map over a global Mesh.  XLA inserts the collectives and hands
them to NCCL, over NVLink between the GPUs of one host and over the
network between hosts (no custom transport).
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX (no-op on single-host setups).

    Pass the coordinator address (``host:port``), the number of
    processes and this process's id explicitly: a plain GPU host has no
    cluster environment for JAX to detect them from.

    Must run before any JAX call that initializes the XLA backend
    (including jax.devices()/jax.process_count() — querying those to
    decide whether to initialize would itself make initialization
    impossible, so the already-initialized check reads the distributed
    client state directly).
    """
    state = getattr(jax.distributed, "global_state", None)
    if state is not None and getattr(state, "client", None) is not None:
        return  # jax.distributed already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        if kwargs:
            # Explicit coordinator config that fails must surface —
            # silently degrading to single-host produces wrong sharded
            # results or collective hangs much later.
            raise
        # No-arg auto-detect on a plain single host (no cluster env, or
        # the backend was already touched in-process): run local.


def global_data_mesh():
    """1D 'data' mesh over all global devices (every host's chips; on a
    single host this equals mesh.data_mesh)."""
    from .mesh import data_mesh

    return data_mesh()
