"""Match-finder v2 tests: the hybrid device stage vs the host oracle."""
import zlib

import numpy as np
import pytest

from qatzip_tpu.native import qzcore as native
from qatzip_tpu.ops import match_finder as mf


def _pack(datas, n=4096):
    data = np.zeros((len(datas), n + 8), np.uint8)
    lens = np.zeros((len(datas),), np.int32)
    for i, d in enumerate(datas):
        data[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return data, lens


@pytest.mark.parametrize("kind", ["text", "constant", "random", "iterative"])
def test_candidates_roundtrip_bit_exact(corpus_factory, kind):
    import jax.numpy as jnp

    datas = [corpus_factory(s, kind) for s in (100, 4000, 4096, 1)]
    arr, lens = _pack(datas)
    cand = np.asarray(mf.find_candidates(jnp.asarray(arr), jnp.asarray(lens)))
    for i, d in enumerate(datas):
        payload = native.deflate_candidates(d, cand[i], 1)
        assert zlib.decompress(payload, -15) == d


def test_candidates_ratio_at_least_zlib(corpus_factory):
    """Compressed size must stay <= zlib at the same level (the BASELINE
    correctness contract)."""
    import jax.numpy as jnp

    datas = [corpus_factory(4096, k) for k in
             ("text", "constant", "iterative")] * 2
    arr, lens = _pack(datas)
    cand = np.asarray(mf.find_candidates(jnp.asarray(arr), jnp.asarray(lens)))
    ours = zl = 0
    for i, d in enumerate(datas):
        ours += len(native.deflate_candidates(d, cand[i], 1))
        co = zlib.compressobj(1, zlib.DEFLATED, -15)
        zl += len(co.compress(d) + co.flush())
    assert ours <= zl * 1.01 + 64


def test_candidates_stride_mode_valid(corpus_factory):
    """QATZIP_TPU_MF_STRIDE>1 (experimental speed mode) must stay
    bit-exact even though ratio degrades."""
    import jax.numpy as jnp

    datas = [corpus_factory(4000, "text")]
    arr, lens = _pack(datas)
    cand = np.asarray(mf.find_candidates(jnp.asarray(arr), jnp.asarray(lens),
                                         stride=2))
    payload = native.deflate_candidates(datas[0], cand[0], 1)
    assert zlib.decompress(payload, -15) == datas[0]


def test_legacy_full_device_encoder_path(corpus_factory, monkeypatch):
    """QATZIP_TPU_ENCODER=device keeps the round-1/2 full-device K1/K2
    pipeline alive and bit-exact."""
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    monkeypatch.setenv("QATZIP_TPU_ENCODER", "device")
    import gzip

    import qatzip_tpu as qz
    from qatzip_tpu.constants import QzDataFormat

    data = corpus_factory(30_000, "text")
    comp = qz.compress(data, "deflate", fmt=QzDataFormat.QZ_DEFLATE_GZIP,
                       level=1, hw_buff_sz=4096)
    assert gzip.decompress(comp) == data
