"""Block data-parallel sharding over a device mesh.

The device equivalent of the reference's parallelism stack (SURVEY.md §2.3):
request-level chunk parallelism (src/qatzip.c:1505-1594) becomes sharding of
the block batch axis over a `jax.sharding.Mesh`; process-level scaling over
PCIe devices (config_file NumProcesses) becomes multi-host data parallelism
with one JAX process per host; the seq-number reassembly invariant
(src/qatzip.c:1641-1649) is preserved because the block axis order is the
submission order.

Per-block compressed lengths travel with the sharded result; hosts gather
payload bytes in block order (the all-gather of lengths happens inside
jit when cross-block offsets are needed on device).
"""
from __future__ import annotations

import functools

import numpy as np


def make_mesh(n_devices: int | None = None, axis: str = "block"):
    """Build a 1-D data-parallel mesh over the first n devices."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.array(devs[:n_devices]), axis_names=(axis,))


_MESH_UNSET = object()
_MESH = _MESH_UNSET


def local_mesh():
    """One cached 1-D block-DP mesh over all local devices (None when the
    host has a single device — sharding has nothing to win there)."""
    global _MESH
    if _MESH is _MESH_UNSET:
        try:
            m = make_mesh()
            _MESH = m if m.devices.size > 1 else None
        except Exception:
            _MESH = None
    return _MESH


def compress_blocks_sharded(mesh, data_pad: np.ndarray, lengths: np.ndarray,
                            depth: int = 1, kwords: int = 16,
                            allow_dynamic: bool = True,
                            m_words: int | None = None):
    """Compress a [B, N+8] batch sharded over the mesh's block axis.

    B must be a multiple of the mesh size (callers pad).  Both device
    dispatches (K1 analyze, K2 pack) run sharded over the block axis; the
    host Huffman/header build between them operates on the gathered [B,286]
    histograms (a few KB).  Returns (words [B, m_words] sharded, bits [B],
    mode [B] numpy); conversion to host bytes walks blocks in order.
    """
    from qatzip_tpu.ops import deflate_encode as de

    n = data_pad.shape[1] - 8
    if m_words is None:
        m_words = de.words_bound(n)
    return de.encode_blocks(data_pad, lengths, depth, kwords, allow_dynamic,
                            m_words, mesh=mesh)


def scaling_report(mesh, block_bytes: int = 65536, blocks_per_device: int = 8,
                   reps: int = 5) -> dict:
    """Scaling-efficiency harness (the run_perf_test.sh analog): measures
    the flagship device kernel (the hybrid match-finder) at 1 device vs
    the full mesh."""
    import time

    from qatzip_tpu.ops import match_finder as mf

    n = block_bytes
    rng = np.random.default_rng(0)

    def run(m):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        ndev = m.devices.size
        b = ndev * blocks_per_device
        data = np.zeros((b, n + 8), np.uint8)
        data[:, :n] = rng.integers(0, 256, (b, n), dtype=np.uint8)
        lens = np.full((b,), n, np.int32)
        dj = jax.device_put(jnp.asarray(data), NamedSharding(m, P("block", None)))
        lj = jax.device_put(jnp.asarray(lens), NamedSharding(m, P("block")))
        jax.block_until_ready(mf.find_candidates(dj, lj))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = mf.find_candidates(dj, lj)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        return b * n / dt

    full = run(mesh)
    single = run(make_mesh(1))
    ndev = mesh.devices.size
    return {
        "devices": int(ndev),
        "single_device_Bps": single,
        "mesh_Bps": full,
        "speedup": full / single,
        "efficiency": full / (single * ndev),
    }
