"""Boundary sweep: port of the reference bt.c bit-exactness fuzz loop
(test/bt.c:137-165): every input length in a range, three corpora,
compress+decompress+memcmp."""
import pytest

import qatzip_tpu as qz
from qatzip_tpu.constants import QzDataFormat
from conftest import make_corpus
import random


@pytest.mark.parametrize("kind", ["iterative", "random", "constant"])
@pytest.mark.parametrize("fmt", [QzDataFormat.QZ_DEFLATE_GZIP_EXT,
                                 QzDataFormat.QZ_DEFLATE_4B])
def test_boundary_sweep_deflate(kind, fmt):
    r = random.Random(1234)
    # small-length exhaustive region + strided larger region (bt.c defaults)
    lengths = list(range(0, 132)) + list(range(1000, 70000, 7321))
    for n in lengths:
        data = make_corpus(r, n, kind)
        comp = qz.compress(data, "deflate", fmt=fmt, hw_buff_sz=4096)
        out = qz.decompress(comp, "deflate", fmt=fmt, hw_buff_sz=4096)
        assert out == data, f"mismatch at len={n} kind={kind}"


@pytest.mark.parametrize("kind", ["iterative", "random", "constant"])
def test_boundary_sweep_lz4(kind):
    r = random.Random(99)
    lengths = list(range(0, 100, 7)) + list(range(500, 40000, 4999))
    for n in lengths:
        data = make_corpus(r, n, kind)
        comp = qz.compress(data, "lz4", hw_buff_sz=16384)
        out = qz.decompress(comp, "lz4", hw_buff_sz=16384)
        assert out == data, f"mismatch at len={n} kind={kind}"


def test_device_forced_boundary_sweep(corpus_factory, monkeypatch):
    """bt.c-style boundary sweep with the device path forced: every length
    through the hybrid encoder + device-capable decoder must round-trip
    bit-exact and stay gzip-interoperable (reference test/bt.c:137-165)."""
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    import gzip

    import qatzip_tpu as qz
    from qatzip_tpu.constants import QzDataFormat

    lengths = [0, 1, 2, 3, 4, 5, 11, 12, 13, 255, 256, 4095, 4096, 4097,
               8191, 12288]
    for kind in ("text", "random", "constant"):
        for n in lengths:
            data = corpus_factory(n, kind)
            comp = qz.compress(data, "deflate",
                               fmt=QzDataFormat.QZ_DEFLATE_GZIP,
                               level=1, hw_buff_sz=4096)
            assert qz.decompress(comp, "deflate", hw_buff_sz=4096) == data, \
                (kind, n)
            if n:
                assert gzip.decompress(comp) == data, (kind, n)


def test_native_deflate_64k_bitpack_sweep(corpus_factory):
    """64KB chunks across data classes at L1/L2, verified by zlib.

    Regression for the BitWriter nbits==64 flush path (`acc >>= 64` is
    UB and kept stale accumulator bits; exposed by fused literal-pair
    puts on mixed text) — bit-packing bugs appear only on specific
    code-length sequences, so sweep widely."""
    import zlib as _z

    import numpy as np

    from qatzip_tpu.native import qzcore as native

    rng = np.random.default_rng(20260821)
    words = [rng.integers(97, 123, rng.integers(2, 12), dtype=np.uint8)
             for _ in range(512)]
    for rep in range(12):
        kind = rep % 3
        if kind == 0:  # zipf-ish text (the class that caught the bug)
            idx = (rng.random(20000) ** 3 * len(words)).astype(int)
            parts = []
            for i in idx:
                parts.append(words[i])
                parts.append(np.array([32], np.uint8))
            data = np.concatenate(parts)[:65536].tobytes()
        elif kind == 1:  # skewed binary
            raw = rng.integers(0, 256, 65536, dtype=np.int64)
            data = ((raw * raw) // 256 % 256).astype(np.uint8).tobytes()
        else:  # structured records
            rows = [f"{i},{(i * 31) % 1013},item-{i % 50:04d}\n".encode()
                    for i in range(4000)]
            data = (b"".join(rows) * 3)[:65536]
        for lvl in (1, 2):
            payload = native.deflate_compress(data, lvl)
            assert _z.decompress(payload, -15) == data, (rep, kind, lvl)
