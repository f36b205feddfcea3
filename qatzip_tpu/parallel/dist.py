"""Multi-host distributed initialization and cross-host block scattering.

The reference scales across PCIe devices with up to NumProcesses=64
processes sharing instances via the driver config
(config_file/4xxx/multiple_process_opt/4xxx_dev0.conf:86-88).  The device
analog is one JAX process per host: `jax.distributed` wires the hosts,
blocks shard across the global device set, and per-block compressed
lengths all-gather over the device interconnect so every host can compute
global output offsets (SURVEY.md §5 "distributed communication backend").
"""
from __future__ import annotations

import os

_initialized = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize `jax.distributed` for multi-host runs.

    Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or the
    QATZIP_TPU_* equivalents).  A single-process run (no coordinator
    configured) is a no-op returning False — the library stays fully
    functional on one host, exactly like the reference without a
    multi-process driver section.
    """
    global _initialized
    if _initialized:
        return True
    coordinator_address = (coordinator_address
                           or os.environ.get("QATZIP_TPU_COORDINATOR")
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None:
        np_s = (os.environ.get("QATZIP_TPU_NUM_PROCESSES")
                or os.environ.get("JAX_NUM_PROCESSES"))
        num_processes = int(np_s) if np_s else None
    if process_id is None:
        pid_s = (os.environ.get("QATZIP_TPU_PROCESS_ID")
                 or os.environ.get("JAX_PROCESS_ID"))
        process_id = int(pid_s) if pid_s else None
    if coordinator_address is None and num_processes is None:
        return False

    import jax

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    _initialized = True
    return True


def global_mesh(axis: str = "block"):
    """1-D block-DP mesh over the GLOBAL device set (all hosts).  On a
    single host this equals `shard.make_mesh()`."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), axis_names=(axis,))


def host_block_range(total_blocks: int) -> tuple[int, int]:
    """[start, end) of the block indices this host owns under an even
    contiguous split — the per-host file-shard scatter (deterministic
    block order preserves the reference's seq reassembly invariant,
    src/qatzip.c:1641-1649)."""
    import jax

    pid = jax.process_index()
    nproc = jax.process_count()
    per = (total_blocks + nproc - 1) // nproc
    start = min(pid * per, total_blocks)
    return start, min(start + per, total_blocks)


def allgather_lengths(local_lengths, axis_name: str = "block"):
    """All-gather per-block compressed lengths over the mesh inside jit —
    every device learns every block's length so global output offsets are
    computable device-side (a collective; the reference has no analog
    because its blocks never leave one host)."""
    import jax

    return jax.lax.all_gather(local_lengths, axis_name)


def sharded_offsets(mesh, lengths):
    """Global exclusive prefix offsets of per-block lengths, computed with
    the block axis sharded and an all-gather collective."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    ax = mesh.axis_names[0]

    def step(ln):
        allv = jax.lax.all_gather(ln, ax, tiled=True)
        cum = jnp.cumsum(allv)
        excl = jnp.concatenate([jnp.zeros((1,), cum.dtype), cum[:-1]])
        # each shard keeps its own window of the global offsets
        i = jax.lax.axis_index(ax)
        return jax.lax.dynamic_slice(excl, (i * ln.shape[0],),
                                     (ln.shape[0],))

    fn = jax.jit(
        jax.shard_map(step, mesh=mesh, in_specs=P(ax), out_specs=P(ax)))
    row = NamedSharding(mesh, P(ax))
    ln = jax.device_put(jnp.asarray(lengths), row)
    return fn(ln)
