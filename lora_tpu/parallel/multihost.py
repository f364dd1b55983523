"""Multi-host runtime glue (BASELINE.json config 5 scaffolding).

Single-controller JAX: every host runs the same program; jax.distributed
wires the hosts into one global device set, the ('time','channel') mesh
spans all hosts, and the halo/corner-turn collectives ride NCCL over
NVLink within a host and the network across hosts with no code changes
in the compute path
(SURVEY.md §2.2 "distributed comm backend").

Each ingest host feeds the time shards backed by its local devices
(`local_time_range`), so capture data never crosses hosts in raw form — only
the (small) halo edges and reduced metrics do.

This module cannot be exercised on the single-chip CI; it is the
documented, typed entry point the scaling runs use.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import make_mesh


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """jax.distributed.initialize.  Pass coordinator ("host:port"),
    num_processes and process_id explicitly where no cluster environment
    (e.g. SLURM) describes the job.

    Must run before anything touches the XLA backend — including
    jax.process_count()/jax.devices(); this wrapper therefore probes the
    distributed client state, not the backend.
    """
    is_init = getattr(jax.distributed, "is_initialized", None)
    if is_init is not None and is_init():
        return  # already initialized
    kw = {}
    if coordinator is not None:
        kw = dict(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    try:
        jax.distributed.initialize(**kw)
    except RuntimeError:
        # already-initialized race on jax versions without is_initialized()
        if is_init is None:
            return
        raise


def global_mesh(time: int | None = None) -> Mesh:
    """('time','channel') mesh over every device of every host.

    Defaults to one time shard per host (each ingest host owns a contiguous
    capture slice; its devices split that slice's channel work).
    """
    if time is None:
        time = jax.process_count()
    return make_mesh(time=time)


def local_time_range(mesh: Mesh, T_global: int) -> tuple[int, int]:
    """[start, end) of the capture slice this host must provide.

    With addressable devices grouped per host along the mesh's time axis
    (the make_mesh default ordering), host p ingests time shards whose
    devices it owns.
    """
    n_time = mesh.shape["time"]
    t_local = T_global // n_time
    rows = mesh.devices.reshape(n_time, -1)
    mine = [
        i
        for i in range(n_time)
        if any(d.process_index == jax.process_index() for d in rows[i])
    ]
    if not mine:
        return 0, 0
    return mine[0] * t_local, (mine[-1] + 1) * t_local


def host_array(global_shape, local_np, mesh: Mesh, spec) -> jax.Array:
    """Assemble a global sharded array from per-host local numpy blocks
    (jax.make_array_from_process_local_data)."""
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(local_np), global_shape
    )
