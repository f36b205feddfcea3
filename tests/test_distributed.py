"""Distributed layer tests on the virtual 8-device CPU mesh."""
import numpy as np
import pytest


@pytest.fixture(scope="module")
def mesh8():
    from qatzip_tpu.parallel.shard import make_mesh
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


def test_sharded_compress_matches_single(mesh8, corpus_factory):
    import zlib
    from qatzip_tpu.parallel.shard import compress_blocks_sharded
    from qatzip_tpu.ops import deflate_encode as de

    n = 4096
    b = 16
    blob = corpus_factory(b * n)
    data = np.zeros((b, n + 8), np.uint8)
    data[:, :n] = np.frombuffer(blob, np.uint8).reshape(b, n)
    lens = np.full((b,), n, np.int32)

    words, bits, mode = compress_blocks_sharded(mesh8, data, lens)
    words = np.asarray(words)
    bits = np.asarray(bits)
    mode = np.asarray(mode)

    # every block decodes bit-exact through zlib, in block order
    out = bytearray()
    for i in range(b):
        if mode[i] == de.MODE_STORED:
            out += blob[i * n:(i + 1) * n]
        else:
            payload = words[i].tobytes()[: (int(bits[i]) + 7) // 8]
            out += zlib.decompressobj(-15).decompress(payload)
    assert bytes(out) == blob


def test_sharded_output_sharding(mesh8):
    from qatzip_tpu.parallel.shard import compress_blocks_sharded

    n = 1024
    b = 8
    data = np.zeros((b, n + 8), np.uint8)
    lens = np.full((b,), n, np.int32)
    words, bits, _ = compress_blocks_sharded(mesh8, data, lens)
    # output stays sharded over the block axis (one block per device)
    assert len(words.sharding.device_set) == 8


def test_scaling_report_runs(mesh8):
    from qatzip_tpu.parallel.shard import scaling_report
    rep = scaling_report(mesh8, block_bytes=1024, blocks_per_device=2, reps=2)
    assert rep["devices"] == 8
    assert rep["mesh_Bps"] > 0 and rep["single_device_Bps"] > 0


def test_sharded_offsets_collective(mesh8):
    """Per-block compressed lengths all-gather over the mesh inside jit;
    offsets come back as the exclusive prefix sum in block order (the
    seq-reassembly invariant, reference src/qatzip.c:1641-1649)."""
    from qatzip_tpu.parallel.dist import sharded_offsets

    lengths = np.array([100, 7, 0, 31, 8, 255, 1, 64], np.int32)
    off = np.asarray(sharded_offsets(mesh8, lengths))
    expect = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    assert (off == expect).all()


def test_init_distributed_noop_single_process(monkeypatch):
    """Without a coordinator configured, init is a safe no-op."""
    from qatzip_tpu.parallel import dist

    for var in ("QATZIP_TPU_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
                "QATZIP_TPU_NUM_PROCESSES", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    assert dist.init_distributed() is False


def test_host_block_range_partition():
    from qatzip_tpu.parallel.dist import host_block_range

    start, end = host_block_range(100)
    assert start == 0 and end == 100  # single-process: owns everything


def test_public_api_sharded_roundtrip(monkeypatch, corpus_factory):
    """Engine-level block-DP: a many-chunk request through the public API
    shards the batch axis over the local mesh."""
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    import qatzip_tpu as qz
    from qatzip_tpu.constants import QzDataFormat

    data = corpus_factory(96 * 1024)
    comp = qz.compress(data, "deflate", fmt=QzDataFormat.QZ_DEFLATE_GZIP_EXT,
                       level=1, hw_buff_sz=4096)
    assert qz.decompress(comp, "deflate", hw_buff_sz=4096) == data
