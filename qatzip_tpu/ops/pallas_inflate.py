"""Lockstep DEFLATE entropy decoder — the device half of the hybrid
inflate pipeline.

Design (mirrors the hybrid ENCODER's device/host split): the device decodes
the serial Huffman/entropy half of DEFLATE for many independent blocks in
lockstep — one block per lane, every step decoding one symbol per block —
and emits fixed-width token records at regular [step, block] slots.
The host then applies tokens (the LZ77 window-copy half the QAT ASIC has
dedicated silicon for: native qz_apply_tokens, qzcore.cpp) and carries the
32KB history between rounds.  Reference HW decompress role:
src/qatzip.c:2103-2355.

Two drivers share one step function (`decode_step`) and one table layout:
  * XLA driver (`_decode_xla`): lax.while_loop + take_along_axis — the
    plain reference, and the decoder on the CPU.
  * Pallas-Triton driver (`_decode_triton`): the step loop runs inside one
    kernel, one lane per GPU thread, table and stream fetches as gather
    loads — the decoder on a GPU, where the XLA loop launches its kernels
    and reads its predicate back once per step.

Wire knowledge (RFC1951): per-block two-level Huffman tables — 9-bit root
+ subtables for codes >9 bits — built host-side per deflate block.  Entries
are u16, packed two per u32 cell:

  region: u32[512] cells = root u16[512] (cells 0..255)
                         + subtable area u16[512] (cells 256..511)
  litlen u16:  clen[0:4] kind[4:6] payload[6:14]
     kind 0 literal : payload = byte (low 8 of [6:14])
     kind 1 length  : payload = length symbol index 0..28
     kind 2 EOB
     kind 3 subptr  : clen field = subbits, payload = sub_base/2
  dist u16:    clen[0:4] kind[4:6] payload[6:11] = dist symbol 0..29
     kind 3 subptr as above
  u16 == 0 -> invalid (corrupt stream; lane errors, CPU fallback)
  length/dist (base, extra) resolve arithmetically from RFC1951's
  geometric closed forms (no constant-table gathers; see decode_step).

Token format (shared with qz_apply_tokens, qzcore.cpp):
  0                  inactive (lane done / padding)
  bit0=1             literal, byte in bits 1..8; bit9=1 marks a PAIRED
                     second literal (byte in bits 10..17) decoded in the
                     same lockstep step (root-resolved pairs only)
  bit0=0,bit1=1      match, len(3..258) in bits 2..10, dist-1 in bits 11..25
"""
from __future__ import annotations

import functools

import numpy as np

from qatzip_tpu.ops import deflate_tables as T

# At most LANES blocks per device call (one lane each).  On the H100 the
# kernel's time per call barely grows with lanes (each lane runs on its own
# thread), so 512 lanes decode a pass over 512 64 KB chunks in a quarter of
# the device time that 128 take (PERF.md, PR 1).
LANES = 512
CELLS = 512          # u32 cells per table region (root 256 + sub 256)
ROOT_BITS = 9        # root-table bits
SUB_ENTRIES = 512    # sub-area entries (256 cells)


# ---------------------------------------------------------------------------
# Host: two-level packed table build
# ---------------------------------------------------------------------------
def _bitrev_vec(v: np.ndarray, l: np.ndarray) -> np.ndarray:
    """Bit-reverse each v[i] over its own length l[i] (vectorized)."""
    out = np.zeros_like(v)
    work = v.copy()
    maxl = int(l.max()) if l.size else 0
    for _ in range(maxl):
        out = (out << 1) | (work & 1)
        work >>= 1
    return out >> (maxl - l)


def _pack_cells(u16: np.ndarray) -> np.ndarray:
    """u16[1024] -> u32[512] cells (little-endian pair packing)."""
    return (u16[0::2].astype(np.uint32)
            | (u16[1::2].astype(np.uint32) << 16))


def _build_twolevel(lens: np.ndarray, entry16: np.ndarray,
                    valid: np.ndarray) -> np.ndarray:
    """Build the packed region from per-symbol code lengths and u16 entries
    (clen/kind/payload already packed; clen filled in here).  ``valid``
    marks symbols legal in a stream — invalid ones (286/287, dist 30/31)
    may own code space (the static code assigns them lengths) but decode to
    the 0 entry, erroring the lane per RFC1951.  Raises ValueError on
    over-subscribed codes or subtable overflow (caller falls back to the
    CPU path).  Vectorized per code length — one build per dynamic deflate
    block is on the round-trip hot path."""
    root_bits, sub_entries = ROOT_BITS, SUB_ENTRIES
    lens = lens.astype(np.int64)
    codes = T.canonical_codes(lens.astype(np.int32)).astype(np.int64)
    if ((codes >> np.maximum(lens, 1)) != 0).any():
        raise ValueError("over-subscribed Huffman code")
    entries = np.where((lens > 0) & valid, entry16 | lens.astype(np.uint16),
                       0).astype(np.uint16)
    root = np.zeros(1 << root_bits, np.uint16)
    sub = np.zeros(sub_entries, np.uint16)
    for l in range(1, root_bits + 1):
        syms = np.nonzero(lens == l)[0]
        if syms.size == 0:
            continue
        rc = _bitrev_vec(codes[syms], np.full(syms.size, l, np.int64))
        fills = np.arange(1 << (root_bits - l), dtype=np.int64) << l
        idx = (rc[:, None] | fills[None, :]).reshape(-1)
        root[idx] = np.repeat(entries[syms], 1 << (root_bits - l))
    long_syms = np.nonzero(lens > root_bits)[0]
    if long_syms.size:
        rcf = _bitrev_vec(codes[long_syms], lens[long_syms])
        slots = rcf & ((1 << root_bits) - 1)
        next_free = 0
        for slot in np.unique(slots):
            sel = slots == slot
            syms = long_syms[sel]
            rcs = rcf[sel]
            subbits = int(lens[syms].max()) - root_bits
            size = 1 << subbits
            if next_free + size > sub_entries:
                raise ValueError("subtable overflow")
            if root[slot] != 0:
                raise ValueError("root/sub collision")  # over-subscription
            root[slot] = np.uint16(subbits | (3 << 4) | ((next_free >> 1) << 6))
            for l in range(root_bits + 1, 16):
                lsel = lens[syms] == l
                if not lsel.any():
                    continue
                rc = rcs[lsel] >> root_bits
                fills = (np.arange(1 << (subbits - (l - root_bits)),
                                   dtype=np.int64) << (l - root_bits))
                idx = next_free + (rc[:, None] | fills[None, :]).reshape(-1)
                sub[idx] = np.repeat(entries[syms[lsel]], fills.size)
            next_free += size
    return np.concatenate([_pack_cells(root), _pack_cells(sub)])


def build_ll_region(lens: np.ndarray) -> np.ndarray:
    """Packed litlen region from code lengths (hlit entries)."""
    nsym = len(lens)
    e = np.zeros(nsym, np.uint16)
    sym = np.arange(nsym)
    lit = sym < 256
    e[lit] = (sym[lit].astype(np.uint16)) << 6
    if nsym > 256:
        e[256] = 2 << 4  # EOB
    hi = min(nsym, 286)
    for s in range(257, hi):
        e[s] = (1 << 4) | ((s - 257) << 6)
    return _build_twolevel(lens, e, sym < 286)


def build_d_region(lens: np.ndarray) -> np.ndarray:
    """Packed distance region from code lengths (hdist entries)."""
    nsym = len(lens)
    e = np.zeros(nsym, np.uint16)
    hi = min(nsym, 30)
    e[:hi] = (np.arange(hi, dtype=np.uint16)) << 6
    return _build_twolevel(lens, e, np.arange(nsym) < 30)


@functools.lru_cache(maxsize=1)
def static_regions() -> tuple[np.ndarray, np.ndarray]:
    return (build_ll_region(T.STATIC_LITLEN_LEN),
            build_d_region(T.STATIC_DIST_LEN))


# ---------------------------------------------------------------------------
# Shared step arithmetic (jnp; shapes chosen by the driver)
# ---------------------------------------------------------------------------
def _mask(nbits):
    import jax.numpy as jnp

    return (jnp.uint32(1) << nbits.astype(jnp.uint32)) - jnp.uint32(1)


def _root_entry(root_fetch, bits, root_bits):
    """Root-level u16 entry for the low root_bits of ``bits``."""
    import jax.numpy as jnp

    _u = jnp.uint32
    idx = (bits & _u((1 << root_bits) - 1)).astype(jnp.int32)
    cell = root_fetch(idx >> 1)
    return (cell >> ((idx.astype(_u) & _u(1)) << _u(4))) & _u(0xFFFF)


def _resolve(root_fetch, sub_fetch, bits, root_bits):
    """Root+sub lookup through the packed region.  Returns (entry u32,
    resolved_at_root bool)."""
    import jax.numpy as jnp

    _u = jnp.uint32
    e = _root_entry(root_fetch, bits, root_bits)
    is_sub = ((e >> _u(4)) & _u(3)) == _u(3)
    subbits = e & _u(15)
    sidx = (((e >> _u(6)) & _u(0xFF)) << _u(1)).astype(jnp.int32) + \
        ((bits >> _u(root_bits)) & _mask(subbits)).astype(jnp.int32)
    cell2 = sub_fetch(sidx >> 1)
    e2 = (cell2 >> ((sidx.astype(_u) & _u(1)) << _u(4))) & _u(0xFFFF)
    return jnp.where(is_sub, e2, e), ~is_sub


def decode_step(peek2, ll_root, ll_sub, d_root, d_sub, st):
    """One lockstep symbol decode.  ``st`` = (bitpos i32, done b, err b,
    outcnt i32, end_bit i32); ``peek2(bitpos) -> (u32, u32)`` returns the
    next 64 stream bits as two words (ONE gather level per step — the
    distance code's bits derive arithmetically); ``*_root/*_sub(cell_idx)
    -> u32`` fetch packed table cells from the root/sub areas.
    Length/distance base+extra come from closed forms (RFC1951's tables
    are geometric), removing two dependent gather levels.  Returns
    (token u32, new_st)."""
    import jax.numpy as jnp

    bitpos, done, err, outcnt, end_bit = st
    _u = jnp.uint32

    b0, b1 = peek2(bitpos)
    e, at_root = _resolve(ll_root, ll_sub, b0, ROOT_BITS)
    clen = (e & _u(15)).astype(jnp.int32)
    kind = ((e >> _u(4)) & _u(3)).astype(jnp.int32)
    bad = (e == _u(0)) | (kind == 3)  # unresolved subptr = corrupt stream
    islit = (kind == 0) & ~bad
    islen = kind == 1
    iseob = kind == 2
    sym = ((e >> _u(6)) & _u(0xFF)).astype(jnp.int32)
    # length base/extra closed form: sym 0..27 -> e=(max(sym,4)-4)>>2,
    # base = sym<4 ? sym+3 : ((4+(sym&3))<<e)+3; sym 28 -> 258, e=0
    # clamp: literal lanes flow a byte through sym; an unclamped shift
    # count >= 32 is undefined
    e_len = jnp.minimum(jnp.maximum(sym - 4, 0) >> 2, 5)
    lbase = jnp.where(sym < 4, sym + 3, ((4 + (sym & 3)) << e_len) + 3)
    e_len = jnp.where(sym >= 28, 0, e_len)
    lbase = jnp.where(sym >= 28, 258, lbase)
    eb = jnp.where(islen, e_len, 0)
    lex = ((b0 >> clen.astype(_u)) & _mask(eb)).astype(jnp.int32)
    mlen = lbase + lex
    used1 = clen + eb  # <= 20 bits

    u1 = used1.astype(_u)
    bits2 = (b0 >> u1) | ((b1 << (_u(31) - u1)) << _u(1))
    ed, _ = _resolve(d_root, d_sub, bits2, ROOT_BITS)
    dclen = (ed & _u(15)).astype(jnp.int32)
    dbad = (ed == _u(0)) | (((ed >> _u(4)) & _u(3)) != 0)
    ds = ((ed >> _u(6)) & _u(31)).astype(jnp.int32)
    # dist base closed form: s<4 -> base-1=s, e=0; else e=(s-2)>>1,
    # base-1 = (2+(s&1))<<e
    e_d = jnp.maximum(ds - 2, 0) >> 1
    dbase1 = jnp.where(ds < 4, ds, (2 + (ds & 1)) << e_d)
    deb = jnp.where(ds < 4, 0, e_d)
    dex = ((bits2 >> dclen.astype(_u)) & _mask(deb)).astype(jnp.int32)
    dist1 = dbase1 + dex

    bad = bad | (islen & dbad)
    islen = islen & ~bad
    islit = islit & ~bad

    active = ~done & ~err
    lit_tok = _u(1) | (sym.astype(_u) << _u(1))
    len_tok = _u(2) | (mlen.astype(_u) << _u(2)) | (dist1.astype(_u) << _u(11))
    token = ((active & islit).astype(_u) * lit_tok
             + (active & islen).astype(_u) * len_tok)

    # literal pairing: when this symbol is a root-resolved literal
    # (clen <= root_bits, so b0 >> clen still holds >= 23 valid bits) and
    # the NEXT code is also a root literal, decode it in the same step and
    # pack its byte into the token's spare bits (bit 9 flag, byte in
    # 10..17) — steps drop ~20-35% on literal-heavy corpora at the cost of
    # one extra root fetch, and token D2H per byte shrinks.  Any other
    # second symbol (match, EOB, subtable, invalid) simply defers to the
    # next step.
    pair = active & islit & at_root
    e2 = _root_entry(ll_root, b0 >> clen.astype(_u), ROOT_BITS)
    lit2 = pair & (e2 != _u(0)) & (((e2 >> _u(4)) & _u(3)) == _u(0))
    clen2 = (e2 & _u(15)).astype(jnp.int32)
    sym2 = (e2 >> _u(6)) & _u(0xFF)
    token = token + lit2.astype(_u) * (_u(0x200) | (sym2 << _u(10)))

    bp2 = bitpos + used1
    new_end = jnp.where(active & iseob, bp2, end_bit)
    new_err = err | (active & bad)
    new_done = done | (active & (iseob | bad))
    new_outcnt = outcnt + (active & islit) + lit2 \
        + (active & islen) * mlen
    adv = used1 + islen * (dclen + deb) + lit2 * clen2
    new_bitpos = bitpos + active * adv
    return token, (new_bitpos, new_done, new_err, new_outcnt, new_end)


# ---------------------------------------------------------------------------
# XLA driver (plain reference; the CPU path)
# ---------------------------------------------------------------------------
@functools.partial(
    __import__("jax").jit, static_argnames=("max_steps",))
def _decode_xla(stream_words, bit0, nbits, tll, td, active0, max_steps: int):
    """stream_words u32[B, NW]; bit0/nbits i32[B]; tll/td u32[B, CELLS];
    active0 bool[B].  Returns (tokens u32[max_steps, B], err, outcnt,
    end_bit, nsteps)."""
    import jax
    import jax.numpy as jnp

    B, NW = stream_words.shape
    _u = jnp.uint32

    def peek2(bitpos):
        wi = jnp.clip(bitpos >> 5, 0, NW - 3)
        sh = (bitpos & 31).astype(_u)
        w0 = jnp.take_along_axis(stream_words, wi[:, None], axis=1)[:, 0]
        w1 = jnp.take_along_axis(stream_words, wi[:, None] + 1, axis=1)[:, 0]
        w2 = jnp.take_along_axis(stream_words, wi[:, None] + 2, axis=1)[:, 0]
        b0 = (w0 >> sh) | ((w1 << (_u(31) - sh)) << _u(1))
        b1 = (w1 >> sh) | ((w2 << (_u(31) - sh)) << _u(1))
        return b0, b1

    def mk_cell(tbl, base):
        def f(idx):
            return jnp.take_along_axis(
                tbl, jnp.clip(base + idx, 0, CELLS - 1)[:, None],
                axis=1)[:, 0]
        return f

    tokens0 = jnp.zeros((max_steps, B), _u)

    def cond(carry):
        step, st, tokens = carry
        _, done, err, _, _ = st
        return (step < max_steps) & ~jnp.all(done | err)

    def body(carry):
        step, st, tokens = carry
        tok, st2 = decode_step(peek2, mk_cell(tll, 0), mk_cell(tll, 256),
                               mk_cell(td, 0), mk_cell(td, 256), st)
        tokens = jax.lax.dynamic_update_index_in_dim(tokens, tok, step,
                                                     axis=0)
        return step + 1, st2, tokens

    st0 = (bit0, ~active0, jnp.zeros((B,), jnp.bool_),
           jnp.zeros((B,), jnp.int32), jnp.full((B,), -1, jnp.int32))
    nsteps, st, tokens = jax.lax.while_loop(cond, body, (0, st0, tokens0))
    return (tokens,) + _finish(st, active0, nbits) + (nsteps,)


def _finish(st, active0, nbits):
    """(err, outcnt, end_bit) from the final lane state: a lane still
    undone at max_steps, that ran past its stream, or that never reached
    its EOB is decoded on the CPU instead."""
    bitpos, done, err, outcnt, end_bit = st
    err = err | (active0 & ~done) | (active0 & (bitpos > nbits))
    err = err | (active0 & ~err & (end_bit < 0))
    return err, outcnt, end_bit


# ---------------------------------------------------------------------------
# Pallas-Triton driver (GPU): the whole step loop inside one kernel
# ---------------------------------------------------------------------------
GROUP = 32   # lanes per Triton program: one lane per thread of one warp


def lane_count(live: int) -> int:
    """Lanes for a call with ``live`` blocks: a power of two from GROUP to
    LANES, so a small request does not pay for LANES lanes of tokens and
    each (lanes, buckets) shape compiles once."""
    b = GROUP
    while b < live:
        b <<= 1
    return min(b, LANES)


def _triton_kernel(stream_ref, bit0_ref, nbits_ref, tll_ref, td_ref,
                   active_ref, _tokens_in, tok_ref, err_ref, cnt_ref,
                   end_ref, ns_ref, *, max_steps: int):
    """One program decodes GROUP lanes until all of them are done.  Table
    and stream fetches are per-lane gather loads; each step stores one
    token row.  Token rows past a program's last step keep the zeros of
    the aliased input."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    NW = stream_ref.shape[1]
    _u = jnp.uint32
    lo = pl.program_id(0) * GROUP
    span = pl.ds(lo, GROUP)
    lanes = lo + jnp.arange(GROUP, dtype=jnp.int32)

    def peek2(bitpos):
        wi = jnp.clip(bitpos >> 5, 0, NW - 3)
        sh = (bitpos & 31).astype(_u)
        w0 = plt.load(stream_ref.at[lanes, wi])
        w1 = plt.load(stream_ref.at[lanes, wi + 1])
        w2 = plt.load(stream_ref.at[lanes, wi + 2])
        b0 = (w0 >> sh) | ((w1 << (_u(31) - sh)) << _u(1))
        b1 = (w1 >> sh) | ((w2 << (_u(31) - sh)) << _u(1))
        return b0, b1

    def mk_cell(ref, base):
        def f(idx):
            return plt.load(ref.at[lanes, jnp.clip(base + idx, 0, CELLS - 1)])
        return f

    fetch = (mk_cell(tll_ref, 0), mk_cell(tll_ref, 256),
             mk_cell(td_ref, 0), mk_cell(td_ref, 256))
    active0 = plt.load(active_ref.at[span]) != 0

    def cond(carry):
        step, _bp, done, err, _oc, _eb = carry
        return (step < max_steps) & (jnp.min(done | err) == 0)

    def body(carry):
        step, bitpos, done, err, outcnt, end_bit = carry
        tok, st2 = decode_step(peek2, *fetch,
                               (bitpos, done != 0, err != 0, outcnt, end_bit))
        plt.store(tok_ref.at[step, span], tok)
        bp2, done2, err2, oc2, eb2 = st2
        return (step + 1, bp2, done2.astype(jnp.int32),
                err2.astype(jnp.int32), oc2, eb2)

    zeros = jnp.zeros((GROUP,), jnp.int32)
    carry0 = (0, plt.load(bit0_ref.at[span]), (~active0).astype(jnp.int32),
              zeros, zeros, jnp.full((GROUP,), -1, jnp.int32))
    step, bitpos, done, err, outcnt, end_bit = jax.lax.while_loop(
        cond, body, carry0)
    err, outcnt, end_bit = _finish(
        (bitpos, done != 0, err != 0, outcnt, end_bit), active0,
        plt.load(nbits_ref.at[span]))
    plt.store(err_ref.at[span], err.astype(jnp.int32))
    plt.store(cnt_ref.at[span], outcnt)
    plt.store(end_ref.at[span], end_bit)
    plt.store(ns_ref.at[span], jnp.full((GROUP,), step, jnp.int32))


@functools.partial(
    __import__("jax").jit, static_argnames=("max_steps", "interpret"))
def _decode_triton(stream_words, bit0, nbits, tll, td, active0,
                   max_steps: int, interpret: bool = False):
    """Same contract as ``_decode_xla``; B must be a multiple of GROUP."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    B = stream_words.shape[0]
    if B % GROUP:
        raise ValueError(f"lane count {B} is not a multiple of {GROUP}")
    lane = jax.ShapeDtypeStruct((B,), jnp.int32)
    tokens, err, outcnt, end_bit, ns = pl.pallas_call(
        functools.partial(_triton_kernel, max_steps=max_steps),
        out_shape=(jax.ShapeDtypeStruct((max_steps, B), jnp.uint32),
                   lane, lane, lane, lane),
        grid=(B // GROUP,),
        input_output_aliases={6: 0},
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="lockstep_inflate",
    )(stream_words, bit0, nbits, tll, td, active0.astype(jnp.int32),
      jnp.zeros((max_steps, B), jnp.uint32))
    return tokens, err != 0, outcnt, end_bit, jnp.max(ns)


# ---------------------------------------------------------------------------
# Driver dispatch
# ---------------------------------------------------------------------------
_READBACK_ROWS = 1024   # token rows are read back in whole multiples of this


def decode_fn():
    """The decoder for this process's device: the Triton kernel on a GPU,
    the XLA reference elsewhere."""
    import jax

    return _decode_triton if jax.devices()[0].platform == "gpu" \
        else _decode_xla


def device_args(stream_words: np.ndarray, bit0: np.ndarray,
                nbits: np.ndarray, tll: np.ndarray, td: np.ndarray,
                active: np.ndarray) -> tuple:
    """Upload one round's host arrays (the decoder's device inputs)."""
    import jax.numpy as jnp

    return tuple(jnp.asarray(a) for a in (stream_words, bit0, nbits, tll,
                                          td, active))


def decode_blocks(stream_words: np.ndarray, bit0: np.ndarray,
                  nbits: np.ndarray, tll: np.ndarray, td: np.ndarray,
                  active: np.ndarray, max_steps: int):
    """Decode one deflate block per lane.  Host numpy in; host numpy out:
    (tokens[S, B], err[B], outcnt[B], end_bit[B], nsteps)."""
    tokens, err, outcnt, end_bit, nsteps = decode_fn()(
        *device_args(stream_words, bit0, nbits, tll, td, active),
        max_steps=max_steps)
    ns = int(nsteps)
    # whole multiples of _READBACK_ROWS: slicing at every distinct ns
    # would compile one slice per ns
    rows = min(max_steps, -(-ns // _READBACK_ROWS) * _READBACK_ROWS)
    return (np.asarray(tokens[:rows])[:ns], np.asarray(err),
            np.asarray(outcnt), np.asarray(end_bit), ns)


def time_rounds(rounds, fn=None, reps: int = 3) -> float:
    """Device-only seconds per pass over recorded decoder calls
    (``inflate_batch(rounds_out=...)``): inputs are uploaded first, and
    each pass ends in block_until_ready.  ``fn`` defaults to this
    device's decoder."""
    import time

    import jax

    fn = fn or decode_fn()
    calls = [(device_args(*args), ms) for args, ms in rounds]
    jax.block_until_ready([fn(*a, max_steps=ms) for a, ms in calls])
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready([fn(*a, max_steps=ms) for a, ms in calls])
    return (time.perf_counter() - t0) / reps
