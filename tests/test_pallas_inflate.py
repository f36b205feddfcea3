"""Lockstep inflate engine tests: packed two-level tables, the shared
decode step via the XLA driver, the Pallas-Triton driver in interpreter
mode against it, token appliers (native vs python), and the packed
candidate D2H format.
"""
import zlib

import numpy as np
import pytest

import qatzip_tpu  # noqa: F401  (sys.path + platform setup via conftest)
from qatzip_tpu.ops import deflate_decode as dd
from qatzip_tpu.ops import pallas_inflate as PI


def _raw(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


def _one_block_args(payload: bytes, NW: int = 4096, lanes: int = 128):
    """Decoder inputs for a single-block stream whose first deflate block
    is a Huffman block, placed in lane 0."""
    s = dd._Stream(payload, 0, 0)
    kind = dd._parse_one_header(s)
    assert kind == "huff"
    tll, td = dd._lockstep_regions(s)
    byte0 = s.bits.pos >> 3
    pv = np.frombuffer(payload, np.uint8, len(payload) - byte0, byte0)
    stream8 = np.zeros((lanes, NW * 4), np.uint8)
    stream8[0, :len(pv)] = pv
    bit0 = np.zeros(lanes, np.int32)
    bit0[0] = s.bits.pos & 7
    nbits = np.zeros(lanes, np.int32)
    nbits[0] = len(pv) * 8
    tlls = np.zeros((lanes, PI.CELLS), np.uint32)
    tds = np.zeros((lanes, PI.CELLS), np.uint32)
    tlls[0], tds[0] = tll, td
    active = np.zeros(lanes, bool)
    active[0] = True
    return stream8.view("<u4"), bit0, nbits, tlls, tds, active


def _decode_one(payload: bytes, hint: int, max_steps: int = 16384):
    """Drive decode_blocks (this process's decoder) on one block."""
    return PI.decode_blocks(*_one_block_args(payload), max_steps)


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("kind", ["text", "iterative", "constant"])
def test_xla_driver_bit_exact(corpus_factory, kind, level):
    data = corpus_factory(3000, kind)
    payload = _raw(data, level)
    tokens, err, outcnt, end_bit, ns = _decode_one(payload, len(data))
    assert not err[0]
    out = dd._apply_tokens_py(tokens[:, 0], b"", int(outcnt[0]))
    assert out == data


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("kind", ["text", "iterative", "constant"])
def test_triton_driver_interpret_matches_xla(corpus_factory, kind, level):
    """The Pallas-Triton driver (interpreter mode) must return exactly the
    XLA reference's tokens, lane flags and step count, and the tokens must
    rebuild the data."""
    import jax

    data = corpus_factory(1500, kind)
    args = PI.device_args(*_one_block_args(_raw(data, level), NW=1024,
                                           lanes=2 * PI.GROUP))
    want = jax.device_get(PI._decode_xla(*args, max_steps=1024))
    got = jax.device_get(PI._decode_triton(*args, max_steps=1024,
                                           interpret=True))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tokens, err, outcnt = got[0], got[1], got[2]
    assert not err[0]
    assert dd._apply_tokens_py(tokens[:, 0], b"", int(outcnt[0])) == data


def test_triton_driver_rejects_ragged_lane_count():
    args = PI.device_args(*_one_block_args(_raw(b"abc" * 50), NW=1024,
                                           lanes=PI.GROUP + 1))
    with pytest.raises(ValueError, match="multiple"):
        PI._decode_triton(*args, max_steps=1024, interpret=True)


def test_decoder_choice_follows_platform():
    """The CPU test platform decodes with the XLA reference; a GPU with
    the Triton kernel."""
    assert PI.decode_fn() is PI._decode_xla


def test_readback_trims_to_steps_run(corpus_factory):
    data = corpus_factory(2000, "text")
    tokens, err, outcnt, end_bit, ns = _decode_one(_raw(data, 6), len(data))
    assert tokens.shape == (ns, 128)
    assert 0 < ns < 1024


@pytest.mark.parametrize("live,lanes", [(1, 32), (32, 32), (33, 64),
                                        (300, 512), (512, 512)])
def test_lane_count_is_bounded_power_of_two(live, lanes):
    assert PI.lane_count(live) == lanes


def test_round_uses_lanes_for_live_blocks(corpus_factory):
    """A small request decodes in a small call: the recorded round has
    lane_count(live) lanes, not LANES."""
    datas = [corpus_factory(3000, k) for k in ("text", "iterative", "constant")]
    rounds: list = []
    res = dd.inflate_batch([_raw(d, 6) for d in datas],
                           [len(d) for d in datas], rounds_out=rounds)
    assert [r[0] for r in res] == datas
    assert rounds and all(args[0].shape[0] == 32 for args, _ in rounds)


def test_native_and_python_appliers_agree(corpus_factory):
    from qatzip_tpu.native import qzcore as native

    data = corpus_factory(20000, "text")
    payload = _raw(data, 6)
    tokens, err, outcnt, end_bit, ns = _decode_one(payload, len(data))
    assert not err[0]
    t = np.ascontiguousarray(tokens)
    a = native.apply_tokens(t, 0, b"", 0, int(outcnt[0]))
    b = dd._apply_tokens_py(t[:, 0], b"", int(outcnt[0]))
    assert a == b == data


def test_region_builder_rejects_oversubscribed():
    lens = np.zeros(286, np.int32)
    lens[:4] = 1  # four 1-bit codes: Kraft violation
    with pytest.raises(ValueError):
        PI.build_ll_region(lens)


def test_invalid_symbol_codes_decode_to_error():
    """Static-code symbols 286/287 own code space but must error a lane."""
    llr, _ = PI.static_regions()
    # code for symbol 286 is 8 bits: 11000110 (RFC1951 static table)
    # decode entry for those stream bits must be the invalid entry 0
    code = 0b11000110
    rev = int(f"{code:08b}"[::-1], 2)
    cell = int(llr[rev >> 1])
    e16 = (cell >> (16 * (rev & 1))) & 0xFFFF
    assert e16 == 0


# ---------------------------------------------------------------------------
# Packed candidate D2H format (match_finder.find_candidates_packed)
# ---------------------------------------------------------------------------
def test_packed_candidates_bit_exact_and_bounded(corpus_factory):
    import jax.numpy as jnp

    from qatzip_tpu.native import qzcore as native
    from qatzip_tpu.ops import match_finder as mf

    n = 16384
    blocks = [corpus_factory(n, "text"), corpus_factory(n, "random"),
              corpus_factory(n, "constant")]
    arr = np.zeros((len(blocks), n + 8), np.uint8)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
    lens = np.full(len(blocks), n, np.int32)
    packed = np.asarray(mf.find_candidates_packed(jnp.asarray(arr),
                                                  jnp.asarray(lens)))
    assert packed.shape[1] == 3 * n // 4  # the 0.75 B/B contract
    unpacked = np.asarray(mf.find_candidates(jnp.asarray(arr),
                                             jnp.asarray(lens)))
    for i, src in enumerate(blocks):
        p1 = native.deflate_candidates_packed(src, packed[i], 1)
        p0 = native.deflate_candidates(src, unpacked[i], 1)
        assert zlib.decompress(p1, -15) == src, "packed path not bit-exact"
        # packing may cost a few % (dropped exception candidates) but must
        # stay in the same size class as the exact-candidate path
        assert len(p1) <= max(len(p0) * 1.35, len(p0) + 64)


def test_packed_candidates_through_public_api(corpus_factory, monkeypatch):
    import qatzip_tpu as qz
    from qatzip_tpu.constants import QzDataFormat

    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    monkeypatch.setenv("QATZIP_TPU_PACK", "1")
    data = corpus_factory(100_000, "text")
    comp = qz.compress(data, "deflate", fmt=QzDataFormat.QZ_DEFLATE_GZIP_EXT)
    assert qz.decompress(comp, "deflate") == data


def test_literal_pairing_engages_and_is_exact(corpus_factory):
    """Root-literal pairing (token bit 9 + byte in 10..17) must actually
    fire on literal-heavy input — it is ~8% of decode throughput — and the
    paired stream must reproduce the data byte-exactly through both
    appliers."""
    from qatzip_tpu.native import qzcore as native

    data = corpus_factory(20000, "text")
    payload = _raw(data, 1)
    tokens, err, outcnt, end_bit, ns = _decode_one(payload, len(data))
    assert not err[0]
    lane = np.ascontiguousarray(tokens)[:, 0]
    lits = lane[(lane & 1) == 1]
    paired = int(((lits & 0x200) != 0).sum())
    assert paired > 0, "pairing never engaged on literal-heavy text"
    # steps < symbols proves the pairing saved steps
    nlit = int(((lane & 1) == 1).sum()) + paired
    nmatch = int(((lane & 3) == 2).sum())
    assert int(ns) < nlit + nmatch + 1
    t = np.ascontiguousarray(tokens)
    a = native.apply_tokens(t, 0, b"", 0, int(outcnt[0]))
    b = dd._apply_tokens_py(t[:, 0], b"", int(outcnt[0]))
    assert a == b == data
