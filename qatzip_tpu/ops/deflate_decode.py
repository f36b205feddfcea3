"""DEFLATE decoder on device (JAX/XLA) — the device analog of the reference's
HW decompress path (cpaDcDecompressData, reference src/qatzip.c:2103-2355,
:2446-2671).

Serial entropy decode is hostile to a vector machine, so the kernel decodes
*speculatively at every bit position* and then extracts the one true symbol
chain:

  1. Host parses block headers (tiny: 3 bits + at most ~300 code lengths)
     and builds flat 15-bit lookup tables per block — the two-level-table
     role collapsed into one 32768-entry direct table per stream
     (128-aligned minor dim: gathers from it run at full speed, PERF.md).
  2. Device: for EVERY bit position p of the block, decode one
     (symbol, consumed-bits, match-len, dist) record via table gathers and
     compute the successor position f(p).  All elementwise + minor-axis
     gathers; no scatters.
  3. The true chain 0 -> f(0) -> f(f(0)) -> ... -> EOB is materialized with
     the segment-entry recurrence + parallel segment walks (the same
     pattern as the encoder's greedy parse, ops/deflate_encode.py), giving
     the symbol list in output order.
  4. Output reconstruction: records ride a merge sort onto the output
     grid (scatter-free interval stabbing), then LZ77 back-references are
     resolved with pointer doubling over the source map — log2(n) gathers
     resolve arbitrarily chained/overlapping copies, with the 32KB history
     window prepended for cross-block references.

Bit-exactness contract: decompressed output must match system zlib/gzip
exactly (BASELINE.md).  Any stream the kernel cannot prove correct
(over-subscribed code, invalid symbol, window underrun, output overflow)
reports an error and the caller falls back to the CPU path — mirroring the
reference's HW->SW failover (src/qatzip_sw.c:792-846).
"""
from __future__ import annotations

import functools
import os

import numpy as np

from qatzip_tpu.ops import deflate_tables as T

try:  # native token applier (qz_apply_tokens); python fallback below
    from qatzip_tpu.native import qzcore as _native
except Exception:  # pragma: no cover - native build optional
    _native = None

MAX_PAYLOAD = 1 << 20     # payloads larger than 1 MB route to the CPU path
MAX_OUTCAP = 1 << 20
SEG = 512                 # chain-walk segment width (bits)

_LL_ENTRY_INVALID = 0

# ---------------------------------------------------------------------------
# Host side: bit reader, header parsing, flat table build
# ---------------------------------------------------------------------------


class _Bits:
    """LSB-first bit reader over bytes (deflate bit order, RFC1951 3.1.1)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos  # absolute bit position

    def read(self, n: int) -> int:
        v = 0
        for i in range(n):
            p = self.pos + i
            byi = p >> 3
            if byi >= len(self.data):
                raise EOFError("deflate stream truncated")
            v |= ((self.data[byi] >> (p & 7)) & 1) << i
        self.pos += n
        return v


def _pack_ll_entries(lens: np.ndarray) -> np.ndarray:
    """Per-symbol packed entry: sym|len<<9|extra_bits<<13|len_base<<16."""
    nsym = len(lens)
    sym = np.arange(nsym, dtype=np.uint32)
    entry = sym | (lens.astype(np.uint32) << 9)
    lbase = np.zeros(nsym, np.uint32)
    leb = np.zeros(nsym, np.uint32)
    hi = min(nsym, 286)
    for s in range(257, hi):
        i = s - 257
        lbase[s] = T._LENGTH_BASE[i]
        leb[s] = T._LENGTH_EXTRA[i]
    entry |= (leb << 13) | (lbase << 16)
    entry[lens == 0] = _LL_ENTRY_INVALID
    return entry


def _pack_d_entries(lens: np.ndarray) -> np.ndarray:
    """Per-distance-symbol packed entry: len|extra_bits<<4|dist_base<<8."""
    nsym = len(lens)
    entry = lens.astype(np.uint32)
    deb = np.zeros(nsym, np.uint32)
    dbase = np.zeros(nsym, np.uint32)
    hi = min(nsym, 30)
    dbase[:hi] = np.asarray(T._DIST_BASE[:hi], np.uint32)
    deb[:hi] = np.asarray(T._DIST_EXTRA[:hi], np.uint32)
    entry |= (deb << 4) | (dbase << 8)
    entry[lens == 0] = 0
    if nsym > 30:  # symbols 30/31 are invalid in a stream
        entry[30:] = 0
    return entry


def _bitrev_vec(v: np.ndarray, l: np.ndarray) -> np.ndarray:
    out = np.zeros_like(v)
    work = v.copy()
    maxl = int(l.max()) if l.size else 0
    for _ in range(maxl):
        out = (out << 1) | (work & 1)
        work >>= 1
    # codes shorter than maxl got over-rotated; shift back
    return out >> (maxl - l)


def build_flat_table(lens: np.ndarray, entries: np.ndarray) -> np.ndarray:
    """Flat 2^15-entry decode table: index = next 15 raw stream bits.

    For a code of length l the low l bits select it (deflate packs the
    MSB-first Huffman code into LSB-first stream order, so the table is
    filled at the bit-reversed code for every junk-fill of the top bits).
    Unassigned slots stay 0 (invalid -> len field 0).
    Raises ValueError on an over-subscribed code (kernel would mis-decode).
    """
    lens = lens.astype(np.int64)
    codes = T.canonical_codes(lens.astype(np.int32)).astype(np.int64)
    if ((codes >> np.maximum(lens, 1)) != 0).any():
        raise ValueError("over-subscribed Huffman code")
    table = np.zeros(1 << 15, np.uint32)
    for l in range(1, 16):
        syms = np.nonzero(lens == l)[0]
        if syms.size == 0:
            continue
        rc = _bitrev_vec(codes[syms], np.full(syms.size, l, np.int64))
        fills = np.arange(1 << (15 - l), dtype=np.int64) << l
        idx = (rc[:, None] | fills[None, :]).reshape(-1)
        table[idx] = np.repeat(entries[syms], 1 << (15 - l))
    return table


@functools.lru_cache(maxsize=1)
def static_tables() -> tuple[np.ndarray, np.ndarray]:
    ll_lens = T.STATIC_LITLEN_LEN
    d_lens = T.STATIC_DIST_LEN
    tll = build_flat_table(ll_lens, _pack_ll_entries(ll_lens))
    td = build_flat_table(d_lens, _pack_d_entries(d_lens))
    return tll, td


def parse_dynamic_header(br: _Bits) -> tuple[np.ndarray, np.ndarray]:
    """Parse the BTYPE=10 code-length section (RFC1951 3.2.7).  Returns
    (litlen lens[hlit], dist lens[hdist])."""
    hlit = br.read(5) + 257
    hdist = br.read(5) + 1
    hclen = br.read(4) + 4
    cl_lens = np.zeros(19, np.int32)
    for i in range(hclen):
        cl_lens[T.CLCODE_ORDER[i]] = br.read(3)
    cl_codes = T.canonical_codes(cl_lens)
    # host decode of the ~300 code lengths via a dict keyed by (len, code)
    dec = {}
    for s in range(19):
        if cl_lens[s]:
            dec[(int(cl_lens[s]), int(cl_codes[s]))] = s
    lens = np.zeros(hlit + hdist, np.int32)
    i = 0
    while i < hlit + hdist:
        code = 0
        clen = 0
        while True:
            code = (code << 1) | br.read(1)
            clen += 1
            if clen > 15:
                raise ValueError("bad code-length code")
            if (clen, code) in dec:
                sym = dec[(clen, code)]
                break
        if sym < 16:
            lens[i] = sym
            i += 1
        elif sym == 16:
            if i == 0:
                raise ValueError("repeat with no previous length")
            rep = 3 + br.read(2)
            lens[i:i + rep] = lens[i - 1]
            i += rep
        elif sym == 17:
            i += 3 + br.read(3)
        else:
            i += 11 + br.read(7)
    if i != hlit + hdist:
        raise ValueError("code-length overrun")
    return lens[:hlit], lens[hlit:]


# ---------------------------------------------------------------------------
# Device kernel
# ---------------------------------------------------------------------------


def _ffill_key24(marker, vals):
    """Forward-fill 24-bit vals from marker positions: uint32 cummax over
    three 8-bit value planes, each packed under a 24-bit position key —
    supports grid indices to 2^24 (the 20-bit two-plane packing silently
    lost markers past index 2^20)."""
    import jax
    import jax.numpy as jnp

    B, M = marker.shape
    idx = (jnp.arange(M, dtype=jnp.uint32)[None, :] + 1)
    key = jnp.where(marker, idx, jnp.uint32(0))
    out = jnp.zeros((B, M), jnp.uint32)
    for plane in range(3):
        part = (vals >> jnp.uint32(8 * plane)) & jnp.uint32(0xFF)
        packed = jnp.where(marker, (key << 8) | part, jnp.uint32(0))
        filled = jax.lax.cummax(packed, axis=1)
        out = out | ((filled & jnp.uint32(0xFF)) << jnp.uint32(8 * plane))
    return out


def _decode_kernel_impl(pay, bit0, tll, td, window, wlen, nbits, outcap):
    import jax
    import jax.numpy as jnp
    from qatzip_tpu.ops.deflate_encode import _take, _vsort

    _U32 = jnp.uint32
    B, PB = pay.shape
    q = jnp.arange(nbits, dtype=jnp.int32)[None, :]
    p = bit0[:, None] + q                       # absolute bit positions
    payi = pay.astype(_U32)

    def bits_at(pp):
        """25 valid low bits of the stream starting at absolute bit pp."""
        byi = pp >> 3
        w = _take(payi, jnp.clip(byi, 0, PB - 1))
        w = w | (_take(payi, jnp.clip(byi + 1, 0, PB - 1)) << 8)
        w = w | (_take(payi, jnp.clip(byi + 2, 0, PB - 1)) << 16)
        w = w | (_take(payi, jnp.clip(byi + 3, 0, PB - 1)) << 24)
        return w >> (pp & 7).astype(_U32)

    # --- speculative decode at every bit position -------------------------
    e = _take(tll, (bits_at(p) & _U32(0x7FFF)).astype(jnp.int32))
    sym = (e & _U32(511)).astype(jnp.int32)
    clen = ((e >> 9) & _U32(15)).astype(jnp.int32)
    leb = ((e >> 13) & _U32(7)).astype(jnp.int32)
    lbase = ((e >> 16) & _U32(511)).astype(jnp.int32)
    lex = (bits_at(p + clen)
           & ((_U32(1) << leb.astype(_U32)) - 1)).astype(jnp.int32)
    mlen = lbase + lex
    p2 = p + clen + leb

    ed = _take(td, (bits_at(p2) & _U32(0x7FFF)).astype(jnp.int32))
    dlen = (ed & _U32(15)).astype(jnp.int32)
    deb = ((ed >> 4) & _U32(15)).astype(jnp.int32)
    dbase = (ed >> 8).astype(jnp.int32)
    dex = (bits_at(p2 + dlen)
           & ((_U32(1) << deb.astype(_U32)) - 1)).astype(jnp.int32)
    dist = dbase + dex

    valid = clen > 0
    iseob = valid & (sym == 256)
    islen = valid & (sym > 256) & (sym <= 285)
    islit = valid & (sym < 256)
    bad = (~valid) | (valid & (sym > 285)) | (islen & (dlen == 0))
    f_abs = jnp.where(islen, p2 + dlen + deb, p + clen)
    adv = jnp.where(islit, 1, jnp.where(islen, mlen, 0))

    n = nbits
    f = jnp.clip(f_abs - bit0[:, None], 0, n)
    f = jnp.where(iseob | bad, n, f)
    f = jnp.maximum(f, q + 1)  # guarantee progress even on garbage entries

    # --- materialize the true chain (segment-entry recurrence + walks,
    #     same pattern as the encoder's greedy parse) ----------------------
    nseg = n // SEG
    seg_end = ((q // SEG) + 1) * SEG
    X = f
    hops = 1
    while hops < SEG:
        nxt = _take(X, jnp.clip(X, 0, n - 1))
        X = jnp.where(X >= seg_end, X, jnp.where(X >= n, n, nxt))
        hops <<= 1

    def entry_step(e_, s_):
        bound = (s_ + 1) * SEG
        nxt = _take(X, jnp.clip(e_, 0, n - 1))[:, 0]
        e2 = jnp.where(e_[:, 0] >= bound, e_[:, 0],
                       jnp.where(e_[:, 0] >= n, n, nxt))
        return e2[:, None], e_[:, 0]

    _, entries = jax.lax.scan(entry_step, jnp.zeros((B, 1), jnp.int32),
                              jnp.arange(nseg, dtype=jnp.int32))
    entries = jnp.moveaxis(entries, 0, 1)       # [B, nseg]

    seg_hi = (jnp.arange(nseg, dtype=jnp.int32) + 1)[None, :] * SEG

    def walk_step(pp, _):
        out = pp
        nxt = _take(f, jnp.clip(pp, 0, n - 1))
        pp2 = jnp.where(pp < seg_hi, nxt, pp)
        return pp2, out

    _, visited = jax.lax.scan(walk_step, entries, None, length=SEG)
    visited = jnp.moveaxis(visited, 0, 2)       # [B, nseg, SEG]
    seg_lo3 = (jnp.arange(nseg, dtype=jnp.int32) * SEG)[None, :, None]
    ok_slot = ((visited >= seg_lo3) & (visited < seg_lo3 + SEG)
               & (visited < n)).reshape(B, n)
    vlist = visited.reshape(B, n)               # chain positions, in order

    # per-chain-record fields (gathers in chain order)
    vl = jnp.clip(vlist, 0, n - 1)
    sym_v = _take(sym, vl)
    adv_v = jnp.where(ok_slot, _take(adv, vl), 0)
    dist_v = _take(dist, vl)
    bad_v = ok_slot & _take(bad, vl)
    eob_v = ok_slot & _take(iseob, vl)
    end_v = _take(p + clen, vl)                 # bit after this symbol

    cum = jnp.cumsum(adv_v, axis=-1)
    off_v = cum - adv_v
    out_len = cum[:, -1]
    err = jnp.any(bad_v, axis=-1)
    err = err | ~jnp.any(eob_v, axis=-1)
    err = err | (out_len > outcap)
    end_bit = jnp.max(jnp.where(eob_v, end_v, -1), axis=-1)

    # --- place records onto the output grid (merge sort + forward fill) --
    isrec = ok_slot & (adv_v > 0)
    rec_lit = isrec & (sym_v < 256)
    # value: islit | byte<<1 | (dist-1)<<9  (24 bits; dist can reach 32768)
    rval = (rec_lit.astype(_U32)
            | (jnp.where(rec_lit, sym_v, 0).astype(_U32) << 1)
            | (jnp.where(isrec & ~rec_lit, dist_v - 1, 0).astype(_U32) << 9))
    okey = jnp.clip(off_v, 0, outcap - 1).astype(_U32)
    rkey = jnp.where(isrec, okey << 1, _U32(0xFFFFFFFF))
    j = jnp.arange(outcap, dtype=jnp.int32)[None, :]
    gkey = ((j.astype(_U32) << 1) | 1)
    keys = jnp.concatenate([rkey, jnp.broadcast_to(gkey, (B, outcap))],
                           axis=-1)
    vals = jnp.concatenate([rval, jnp.zeros((B, outcap), _U32)], axis=-1)
    ident = jnp.concatenate(
        [jnp.full((B, n), outcap, jnp.int32),
         jnp.broadcast_to(j, (B, outcap))], axis=-1).astype(_U32)
    sk, sv, sid = _vsort(keys, vals, ident)
    ismark = ((sk & 1) == 0)
    filled = _ffill_key24(ismark, sv)
    _, per_j = _vsort(sid, filled)
    per_j = per_j[:, :outcap]

    in_out = j < out_len[:, None]
    islit_j = ((per_j & 1) == 1) | ~in_out
    byte_j = ((per_j >> 1) & _U32(0xFF)).astype(jnp.int32)
    dist_j = ((per_j >> 9) & _U32(0x7FFF)).astype(jnp.int32) + 1

    # --- resolve LZ77 copies: pointer doubling over the source map -------
    W = 32768
    g = j + W
    src = jnp.where(islit_j, g, g - dist_j)
    err = err | jnp.any(in_out & ~islit_j
                        & (src < (W - wlen[:, None])), axis=-1)
    src_full = jnp.concatenate(
        [jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :], (B, W)),
         src], axis=-1)
    val_full = jnp.concatenate(
        [window.astype(jnp.int32),
         jnp.where(islit_j, byte_j, 0)], axis=-1)
    res_full = jnp.concatenate(
        [jnp.ones((B, W), jnp.bool_), islit_j], axis=-1)
    total = W + outcap
    steps = 1
    while steps < total:
        sc = jnp.clip(src_full, 0, total - 1)
        rs = _take(res_full, sc)
        vs = _take(val_full, sc)
        ss = _take(src_full, sc)
        newly = (~res_full) & rs
        val_full = jnp.where(newly, vs, val_full)
        src_full = jnp.where(res_full | newly, src_full, ss)
        res_full = res_full | rs
        steps <<= 1
    err = err | ~jnp.all(res_full, axis=-1)
    out = jnp.where(in_out, val_full[:, W:], 0).astype(jnp.uint8)
    return out, out_len, end_bit, err


_kernel_cache: dict = {}


def _decode_kernel(nbits: int, outcap: int):
    key = (nbits, outcap)
    fn = _kernel_cache.get(key)
    if fn is None:
        import jax

        fn = jax.jit(functools.partial(_decode_kernel_impl,
                                       nbits=nbits, outcap=outcap))
        _kernel_cache[key] = fn
    return fn


# ---------------------------------------------------------------------------
# Host orchestration: multi-block inflate over a batch of streams
# ---------------------------------------------------------------------------


class _Stream:
    __slots__ = ("payload", "hint", "bits", "out", "window", "done", "failed",
                 "final_block", "index", "_lens", "kind", "crc", "crc_len")

    def __init__(self, payload: bytes, hint: int, index: int,
                 kind: str = "crc32"):
        self.payload = payload
        self.hint = hint
        self.bits = _Bits(payload)
        self.out = bytearray()
        self.window = b""
        self.done = False
        self.failed = False
        self.final_block = False
        self.index = index
        self.kind = kind
        self.crc: int | None = None  # running checksum of self.out
        self.crc_len = 0

    def push(self, data: bytes, part_crc: int | None = None) -> None:
        """Append decoded bytes; fold ``part_crc`` (device-computed checksum
        of this part) into the running stream checksum.  Host computes the
        part only for host-handled stored blocks."""
        import zlib as _z

        from qatzip_tpu.utils import checksum as _ck

        if self.kind:
            if part_crc is None:
                part_crc = (_z.adler32(data) if self.kind == "adler32"
                            else _z.crc32(data)) & 0xFFFFFFFF
            if self.crc is None or self.crc_len == 0:
                self.crc = part_crc
            elif self.kind == "adler32":
                self.crc = _ck.adler32_combine(self.crc, part_crc, len(data))
            else:
                self.crc = _ck.crc32_combine(self.crc, part_crc, len(data))
            self.crc_len += len(data)
        self.out += data
        w = self.window + data
        self.window = w[-32768:] if len(w) > 32768 else w


def _next_pow2(x: int, lo: int) -> int:
    p = lo
    while p < x:
        p <<= 1
    return p


def inflate_batch(payloads, hints, max_rounds: int = 64,
                  kind: str | None = None, ran_out: list | None = None,
                  rounds_out: list | None = None):
    """Inflate complete raw-deflate streams on device.

    Returns a list of (data: bytes, end_of_stream: bool, checksum) entries
    (checksum per ``kind`` — "crc32"/"adler32" — computed by the device
    kernels, or None when kind is unset), or None for streams that must
    fall back to the CPU path (unsupported size, malformed-but-
    recoverable-by-zlib constructs, kernel error flags).

    ``rounds_out``, when given, collects each lockstep decoder call as
    (host input arrays, max_steps), so the decoder alone can be timed on
    the same inputs (pallas_inflate.time_rounds).
    """
    if kind == "xxh32":
        kind = None  # not device-combinable; caller computes on host
    streams = []
    for i, (pl, hint) in enumerate(zip(payloads, hints)):
        s = _Stream(bytes(pl), int(hint), i, kind=kind or "")
        if len(s.payload) == 0 or len(s.payload) > MAX_PAYLOAD:
            s.failed = True
        if hint is not None and hint > MAX_OUTCAP:
            s.failed = True
        # the chain-resolve grid packs a position key in the top 24 bits
        # of uint32; streams whose nbits+outcap could exceed 2^24 would
        # decode the tail to wrong bytes — route them to the CPU instead
        cap = int(hint) if (hint is not None and hint > 0) else (1 << 16)
        if len(s.payload) * 8 + cap >= (1 << 24):
            s.failed = True
        streams.append(s)

    if ran_out is not None:
        ran_out.clear()
    for _ in range(max_rounds):
        batch = []
        for s in streams:
            if s.done or s.failed:
                continue
            # parse as many host-handled (stored) blocks as possible and
            # stop at a Huffman block or stream end
            try:
                while not s.done:
                    kind = _parse_one_header(s)
                    if kind == "huff":
                        batch.append(s)
                        break
            except (EOFError, ValueError):
                s.failed = True
        if not batch:
            break
        if ran_out is not None and not ran_out:
            ran_out.append(True)  # at least one real device round executed
        _run_device_round(batch, rounds_out)

    results = []
    for s in streams:
        if s.failed or not s.done:
            results.append(None)
        else:
            crc = s.crc if s.kind else None
            if s.kind and s.crc_len == 0:  # empty stream
                crc = 1 if s.kind == "adler32" else 0
            results.append((bytes(s.out), True, crc))
    return results


def _parse_one_header(s: _Stream) -> str:
    """Advance past one block header.  Returns 'huff' (device decode needed;
    tables stashed on the stream), or handles a stored block / stream end
    inline and returns 'stored' / 'end'."""
    br = s.bits
    bfinal = br.read(1)
    btype = br.read(2)
    s.final_block = bool(bfinal)
    if btype == 0:
        br.pos = (br.pos + 7) & ~7  # byte-align
        byi = br.pos >> 3
        if byi + 4 > len(s.payload):
            raise EOFError("truncated stored block")
        ln = int.from_bytes(s.payload[byi:byi + 2], "little")
        nlen = int.from_bytes(s.payload[byi + 2:byi + 4], "little")
        if ln != (~nlen & 0xFFFF):
            raise ValueError("stored block LEN/NLEN mismatch")
        data = s.payload[byi + 4:byi + 4 + ln]
        if len(data) != ln:
            raise EOFError("truncated stored block data")
        s.push(data)
        br.pos = (byi + 4 + ln) << 3
        if bfinal:
            s.done = True
            return "end"
        return "stored"
    if btype == 1:
        s._lens = None  # static tables; engines cache their builds
        return "huff"
    if btype == 2:
        # stash the code lengths; each decode engine (lockstep regions /
        # speculative flat tables) builds its own table form at round time
        s._lens = parse_dynamic_header(br)  # type: ignore[attr-defined]
        return "huff"
    raise ValueError("reserved BTYPE")


def _run_device_round(batch, rounds_out: list | None = None) -> None:
    """Dispatch one device decode round.  Default engine: the lockstep
    token decoder (ops/pallas_inflate.py).  QATZIP_TPU_INFLATE=spec keeps
    the round-3 speculative per-bit kernel selectable for comparison."""
    if os.environ.get("QATZIP_TPU_INFLATE", "lockstep") == "spec":
        return _run_device_round_spec(batch)
    # lockstep rounds take up to LANES blocks; sort by remaining payload so
    # similar-sized blocks share a round (lockstep runs to the slowest lane)
    from qatzip_tpu.ops import pallas_inflate as PI

    order = sorted(batch, key=lambda s: len(s.payload) - (s.bits.pos >> 3))
    for i in range(0, len(order), PI.LANES):
        _run_device_round_lockstep(order[i:i + PI.LANES], rounds_out)


# -- lockstep engine (round 4) ----------------------------------------------
_LOCKSTEP_NW = (1024, 4096, 16896)       # stream words per lane (buckets)
_LOCKSTEP_STEPS = (1024, 4096, 16384, 65664)


def _lockstep_regions(s):
    """Packed table regions for one block (pallas_inflate layout)."""
    from qatzip_tpu.ops import pallas_inflate as PI

    if getattr(s, "_lens", None) is None:
        return PI.static_regions()
    ll_lens, d_lens = s._lens
    return PI.build_ll_region(ll_lens), PI.build_d_region(d_lens)


def _apply_tokens_py(lane_tokens: np.ndarray, window: bytes,
                     cap: int) -> bytes:
    """Python fallback for qz_apply_tokens (native absent)."""
    out = bytearray()
    wl = len(window)
    for t in lane_tokens:
        t = int(t)
        if t == 0:
            continue
        if t & 1:
            if len(out) >= cap:
                raise ValueError("token overflow")
            out.append((t >> 1) & 0xFF)
            if t & 0x200:  # paired second literal (bits 10..17)
                if len(out) >= cap:
                    raise ValueError("token overflow")
                out.append((t >> 10) & 0xFF)
            continue
        if not t & 2:
            raise ValueError("bad token")
        ln = (t >> 2) & 0x1FF
        d = ((t >> 11) & 0x7FFF) + 1
        if ln < 3 or ln > 258 or len(out) + ln > cap:
            raise ValueError("bad token")
        for _ in range(ln):
            p = len(out) - d
            if p >= 0:
                out.append(out[p])
            elif wl + p >= 0:
                out.append(window[wl + p])
            else:
                raise ValueError("window underrun")
    return bytes(out)


def _run_device_round_lockstep(batch, rounds_out: list | None) -> None:
    from qatzip_tpu.ops import pallas_inflate as PI

    live: list[tuple] = []
    for s in batch:
        try:
            regions = _lockstep_regions(s)
        except ValueError:
            s.failed = True  # over-subscribed/invalid code: CPU decides
            continue
        byte0 = s.bits.pos >> 3
        words = (len(s.payload) - byte0 + 3) // 4 + 2
        if words > _LOCKSTEP_NW[-1]:
            s.failed = True  # beyond the largest per-lane stream bucket
            continue
        rem = (s.hint - len(s.out)) if (s.hint and s.hint > 0) else (1 << 16)
        rem = max(1, min(rem, MAX_OUTCAP))
        live.append((s, regions, byte0, rem, words))
    if not live:
        return

    B = PI.lane_count(len(live))
    NW = next(b for b in _LOCKSTEP_NW if b >= max(t[4] for t in live))
    need = min(65537, max(t[3] for t in live) + 2)
    MS = next(b for b in _LOCKSTEP_STEPS if b >= need)

    stream8 = np.zeros((B, NW * 4), np.uint8)
    bit0 = np.zeros((B,), np.int32)
    nbits = np.zeros((B,), np.int32)
    tll = np.zeros((B, PI.CELLS), np.uint32)
    td = np.zeros((B, PI.CELLS), np.uint32)
    active = np.zeros((B,), bool)
    for i, (s, regions, byte0, rem, words) in enumerate(live):
        pv = np.frombuffer(s.payload, np.uint8, len(s.payload) - byte0,
                           byte0)
        stream8[i, :len(pv)] = pv
        bit0[i] = s.bits.pos & 7
        nbits[i] = len(pv) * 8
        tll[i], td[i] = regions
        active[i] = True

    args = (stream8.view("<u4"), bit0, nbits, tll, td, active)
    if rounds_out is not None:
        rounds_out.append((args, MS))
    tokens, err, outcnt, end_bit, _ns = PI.decode_blocks(*args, MS)
    tokens = np.ascontiguousarray(tokens)

    for i, (s, regions, byte0, rem, words) in enumerate(live):
        if err[i] or end_bit[i] < 0 or outcnt[i] > rem:
            s.failed = True
            continue
        try:
            if _native is not None:
                data = _native.apply_tokens(tokens, i, s.window,
                                            len(s.window), int(outcnt[i]))
            else:
                data = _apply_tokens_py(tokens[:, i], s.window,
                                        int(outcnt[i]))
        except ValueError:
            s.failed = True
            continue
        if len(data) != int(outcnt[i]):
            s.failed = True
            continue
        s.push(data)
        s.bits.pos = (byte0 << 3) + int(end_bit[i])
        if s.final_block:
            s.done = True


def _spec_tables(s):
    if getattr(s, "_lens", None) is None:
        return static_tables()
    ll_lens, d_lens = s._lens
    return (build_flat_table(ll_lens, _pack_ll_entries(ll_lens)),
            build_flat_table(d_lens, _pack_d_entries(d_lens)))


def _run_device_round_spec(batch) -> None:
    import jax.numpy as jnp

    pb = max(len(s.payload) - (s.bits.pos >> 3) for s in batch)
    nbits = _next_pow2(max(pb * 8 + 64, SEG * 2), 4096)
    if nbits // SEG < 2:
        nbits = SEG * 2
    outcap = _next_pow2(
        max(max((s.hint if s.hint and s.hint > 0 else 1 << 16)
                for s in batch), 1 << 12), 4096)
    outcap = min(outcap, MAX_OUTCAP)

    # _ffill_key24 packs grid index+1 into the top 24 bits of a uint32;
    # a round whose sorted record+grid array (nbits + outcap entries) would
    # overflow that key loses markers and corrupts the output tail — fail
    # the whole round to the CPU path instead (unreachable at current
    # MAX_PAYLOAD/MAX_OUTCAP: 2^23 + 2^20 < 2^24; kept as a guard)
    if nbits + outcap >= (1 << 24):
        for s in batch:
            s.failed = True
        return

    # block-DP decode: pad the batch to the local mesh size and shard the
    # batch axis (padding rows decode garbage and are dropped).  Batch
    # shape is pinned to {1, 8, k*ndev} so kernel compiles stay bounded
    # (the reference's two NUM_BUFF shapes, internal.h:65-70).
    from qatzip_tpu.parallel.shard import local_mesh

    mesh = local_mesh()
    B = len(batch)
    if mesh is not None and B > 1:
        ndev = mesh.devices.size
        B = ((B + ndev - 1) // ndev) * ndev
    elif B == 1:
        mesh = None
    else:
        # round up (not clamp): inflate_batch is a public entry point and
        # may carry more than MAX_DECODE_BATCH streams
        B = ((B + 7) // 8) * 8
    pbytes = max(len(s.payload) for s in batch)
    PB = ((pbytes + 4 + 127) // 128) * 128 + 128
    pay = np.zeros((B, PB), np.uint8)
    bit0 = np.zeros((B,), np.int32)
    tll = np.zeros((B, 1 << 15), np.uint32)
    td = np.zeros((B, 1 << 15), np.uint32)
    window = np.zeros((B, 32768), np.uint8)
    wlen = np.zeros((B,), np.int32)
    for i, s in enumerate(batch):
        pay[i, :len(s.payload)] = np.frombuffer(s.payload, np.uint8)
        bit0[i] = s.bits.pos
        try:
            tll[i], td[i] = _spec_tables(s)
        except ValueError:
            s.failed = True  # invalid code set: zero tables flag as err
            continue
        w = s.window
        if w:
            window[i, 32768 - len(w):] = np.frombuffer(w, np.uint8)
        wlen[i] = len(s.window)

    if mesh is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        mat = NamedSharding(mesh, P("block", None))
        row = NamedSharding(mesh, P("block"))

        def up(a):
            return jax.device_put(jnp.asarray(a),
                                  mat if a.ndim == 2 else row)
    else:
        up = jnp.asarray

    fn = _decode_kernel(nbits, outcap)
    out, out_len, end_bit, err = fn(
        up(pay), up(bit0), up(tll), up(td), up(window), up(wlen))
    # checksum fused on the device output before it ever reaches the host
    # (reference HW returns the checksum with the chunk, qatzip.c:1699)
    kinds = {s.kind for s in batch if s.kind}
    cks = {}
    if kinds:
        from qatzip_tpu.ops import checksums as cksum

        for k in kinds:
            f = (cksum.adler32_blocks if k == "adler32"
                 else cksum.crc32_blocks)
            cks[k] = np.asarray(f(out, out_len, outcap))
    out = np.asarray(out)
    out_len = np.asarray(out_len)
    end_bit = np.asarray(end_bit)
    err = np.asarray(err)

    for i, s in enumerate(batch):
        if err[i] or end_bit[i] < 0:
            s.failed = True
            continue
        part_crc = int(cks[s.kind][i]) if s.kind else None
        s.push(out[i, :int(out_len[i])].tobytes(), part_crc)
        s.bits.pos = int(end_bit[i])
        if s.final_block:
            s.done = True
