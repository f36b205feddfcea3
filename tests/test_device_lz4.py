"""LZ4/LZ4s device-encode tests: the device match-finder + native byte
assembler must produce frames the CPU/byte-level oracles accept bit-safe
(reference HW LZ4 path src/qatzip_utils.c:264-341, qatzip_lz4.c)."""
import pytest

import qatzip_tpu as qz
import qatzip_tpu.session as S


@pytest.mark.parametrize("kind", ["text", "constant", "random"])
def test_lz4_device_roundtrip(monkeypatch, corpus_factory, kind):
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    from qatzip_tpu.engine import core as ec

    data = corpus_factory(100_000, kind)
    before = ec._engine.hw_requests
    comp = qz.compress(data, "lz4", hw_buff_sz=16384)
    assert ec._engine.hw_requests > before  # device path engaged
    assert qz.decompress(comp, "lz4", hw_buff_sz=16384, sw_only=True) == data


def test_lz4_device_matches_frame_magic(monkeypatch, corpus_factory):
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    data = corpus_factory(50_000, "text")
    comp = qz.compress(data, "lz4", hw_buff_sz=16384)
    assert comp[:4] == b"\x04\x22\x4d\x18"  # LZ4 frame magic


def test_lz4s_device_roundtrip(monkeypatch, corpus_factory):
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    data = corpus_factory(80_000, "text")
    sess = qz.QzSession()
    p = qz.QzSessionParamsLZ4S(
        common_params=S.QzSessionParamsCommon(comp_lvl=1, hw_buff_sz=16384))
    assert qz.qz_setup_session_lz4s(sess, p) == qz.QZ_OK
    res = qz.qz_compress(sess, data)
    assert res.rc == qz.QZ_OK
    s2 = qz.QzSession()
    qz.qz_setup_session_lz4s(s2, p)
    d = qz.qz_decompress(s2, res.data)
    assert d.rc == qz.QZ_OK and d.data == data


def test_lz4_device_tiny_and_incompressible(monkeypatch, corpus_factory):
    """End-of-block rules: tiny inputs are all-literal; incompressible
    chunks take the stored-block escape."""
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    for size in (1, 12, 13, 64, 4096):
        data = corpus_factory(size, "random")
        comp = qz.compress(data, "lz4", hw_buff_sz=4096)
        assert qz.decompress(comp, "lz4", sw_only=True,
                             hw_buff_sz=4096) == data


def test_device_lz4_decompress_roundtrip(corpus_factory, monkeypatch):
    """LZ4 frame decompress with the device forced (reference HW LZ4
    decode src/qatzip.c:2103-2355)."""
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    import qatzip_tpu as qz
    from qatzip_tpu.engine import core as ec
    from qatzip_tpu.constants import DataFormatInternal, QzDirection
    from qatzip_tpu.ops import registry
    from qatzip_tpu.session import InternalParams

    ip = InternalParams()
    ip.data_fmt = DataFormatInternal.LZ4_FH
    assert registry.supports(ip, QzDirection.QZ_DIR_DECOMPRESS)

    for kind, size in [("text", 150_000), ("constant", 70_000),
                       ("random", 50_000)]:
        data = corpus_factory(size, kind)
        comp = qz.compress(data, "lz4", level=1)
        before = ec._engine.hw_requests
        out = qz.decompress(comp, "lz4")
        assert out == data
    # at least one decompress batch must have hit the device route when the
    # engine has a hw backend on this platform (virtual mesh in tests)
    if ec._engine.hw_present:
        assert ec._engine.hw_requests > before


def test_device_lz4s_decompress_blocks(corpus_factory):
    """LZ4s 4B-framed blocks decode on device bit-exact vs the host
    decoder."""
    from qatzip_tpu.engine.lz4_block import (lz4s_block_compress,
                                             lz4s_block_decompress)
    from qatzip_tpu.ops import lz4_decode

    datas = [corpus_factory(s, k) for s, k in
             [(100, "text"), (30_000, "text"), (10_000, "constant"),
              (5_000, "random")]]
    blocks = [lz4s_block_compress(d, 3) for d in datas]
    res = lz4_decode.decode_blocks(blocks, mini_match=3)
    for d, blk, r in zip(datas, blocks, res):
        want = lz4s_block_decompress(blk, 1 << 22, 3)
        assert want == d
        assert r is not None and r == d


def test_device_lz4_decode_rejects_malformed():
    """Zero offsets / truncated blocks must flag, not mis-decode."""
    from qatzip_tpu.ops import lz4_decode

    good = b"\x54abcde\x05\x00\x50XYZWQ"   # valid: match offset 5
    bad_zero_off = b"\x54abcde\x00\x00\x50XYZWQ"
    res = lz4_decode.decode_blocks([good, bad_zero_off])
    assert res[0] == b"abcde" + b"abcdeabc" + b"XYZWQ"
    assert res[1] is None


def test_device_lz4_decode_high_ratio_block():
    """A tiny compressed block expanding to ~60KB must decode on device
    (outcap >= 128K regardless of compressed size)."""
    from qatzip_tpu.engine.lz4_block import lz4_block_compress
    from qatzip_tpu.ops import lz4_decode

    data = b"A" * 60000
    blk = lz4_block_compress(data)
    assert len(blk) < 2000
    res = lz4_decode.decode_blocks([blk])
    assert res[0] == data
