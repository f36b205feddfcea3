"""DEFLATE block encoder on device (JAX/XLA; the device analog of the QAT
compression engine's deflate path, reference src/qatzip.c:1483-1764).

The pipeline is built almost entirely from sorts, prefix scans and
elementwise passes, with no random-access gathers or scatters, and small
histograms as int8 one-hot matmuls:

  K1 ``analyze_blocks``  (device):
    * hash-chain candidates from ONE variadic key sort whose payloads carry
      the 4 shifted prefix words of every position, so match verification
      and exact match lengths (to 19 bytes) are elementwise payload
      compares in sorted order — zero random reads;
    * a second variadic sort inverts the permutation (payload packed with
      the key) back to position order;
    * exact dist-1 run lengths via log-doubling (covers RLE data to the
      full 258);
    * the greedy parse is the one irreducibly random-access stage: the
      chain 0 -> f(0) -> ... is materialized by a segment-entry recurrence
      plus parallel segment walks (lax.scan), then one scatter builds the
      selected-position mask;
    * litlen/dist histograms as int8 one-hot matmuls.
  Host ``qz_huff_build_batch`` (native C++): true length-limited Huffman,
    RLE-compressed dynamic headers, stored/static/dynamic mode decision
    from exact bit costs (the CPA auto-select-best behavior, reference
    src/qatzip_utils.c:284-341).
  K2 ``pack_blocks``  (device): per-position fields (literal-or-length at
    p, distance at p+1 — always inside the match it belongs to), per-block
    code-table lookups via sort-merge-forward-fill, and scatter-free bit
    packing via prefix sums whose values ride a merge sort to the word
    boundaries.

Length/distance codes are computed arithmetically (ops/codes.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from qatzip_tpu.ops.codes import dist_code, length_code

MODE_DYNAMIC = 0
MODE_STATIC = 1
MODE_STORED = 2

WINDOW = 32767  # dist rides 15 payload bits of the unscramble key
SEG = 256       # greedy-parse segment width
HDR_MAX = 672   # 4 + 19 + 2*316 header fields + slack
MAX_BLOCK = 1 << 17  # keys pack pos into 17 bits

_U32 = jnp.uint32
_INVALID = jnp.uint32(0xFFFFFFFF)
_OB = jax.lax.optimization_barrier


def words_bound(n: int) -> int:
    """Output words per block: static-mode worst case plus slack, padded to
    the 128-lane tile (the host mode decision guarantees dynamic/static
    blocks fit; stored blocks are emitted on the host)."""
    return ((9 * n + n // 4 + 8192) // 32 + 127) & ~127


def level_params(level: int) -> tuple[int, int]:
    """Map compression level to (hash-chain depth, payload words for the
    depth-1 exact extension) — the analog of the reference's
    level->HW-search-depth table (README.md:133-148).  Depths are deeper
    than zlib's chain walks because sorted-neighbour candidate evaluation
    is elementwise (the sorts dominate): depth 8 at L1 measured +5%% ratio
    on text vs depth 4 at unchanged device time."""
    if level <= 3:
        return 8, 16
    if level <= 6:
        return 12, 24
    return 16, 32


def _take(a: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    a, idx = _OB((a, idx))
    return _OB(jnp.take_along_axis(a, idx, axis=-1, mode="clip"))


def _vsort(key: jnp.ndarray, *payloads: jnp.ndarray, chunk: int = 5):
    """Variadic ascending sort by key (sorts are the cheap primitive).

    Payloads are carried in groups of ``chunk`` through separate stable
    sorts of the same key — identical permutations, but XLA's sort
    expansion compiles quadratically in operand count, so many small sorts
    compile far faster than one wide one."""
    if len(payloads) <= chunk:
        return jax.lax.sort((key,) + payloads, num_keys=1, is_stable=True)
    outs = [None]
    collected = []
    for i in range(0, len(payloads), chunk):
        grp = payloads[i:i + chunk]
        res = jax.lax.sort((key,) + grp, num_keys=1, is_stable=True)
        outs[0] = res[0]
        collected.extend(res[1:])
    return (outs[0], *collected)


def _shift_right(a: jnp.ndarray, k: int, fill) -> jnp.ndarray:
    pad = jnp.full(a.shape[:-1] + (k,), fill, a.dtype)
    return jnp.concatenate([pad, a[..., :-k]], axis=-1)


def _shift_left(a: jnp.ndarray, k: int, fill) -> jnp.ndarray:
    pad = jnp.full(a.shape[:-1] + (k,), fill, a.dtype)
    return jnp.concatenate([a[..., k:], pad], axis=-1)


def _hist_onehot(idx: jnp.ndarray, valid: jnp.ndarray, nbins: int,
                 hi_w: int = 32) -> jnp.ndarray:
    """Histogram as factorized int8 one-hot matmuls (scatter-free)."""
    nb_hi = (nbins + hi_w - 1) // hi_w
    hi = idx // hi_w
    lo = idx - hi * hi_w
    oh_hi = ((hi[..., None] == jnp.arange(nb_hi)[None, None, :])
             & valid[..., None]).astype(jnp.int8)
    oh_lo = (lo[..., None] == jnp.arange(hi_w)[None, None, :]).astype(jnp.int8)
    counts = jax.lax.dot_general(
        oh_hi, oh_lo,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32)        # [B, nb_hi, hi_w]
    return counts.reshape(idx.shape[0], nb_hi * hi_w)[:, :nbins]


def _pos_bits(n: int) -> int:
    b = 17
    while (1 << b) < n:
        b += 1
    return b


@functools.partial(jax.jit, static_argnames=("depth", "kwords", "lz4_rules"))
def analyze_blocks(data: jnp.ndarray, lengths: jnp.ndarray, depth: int,
                   kwords: int, lz4_rules: bool = False):
    """K1: LZ77 + greedy parse + histograms for a batch of blocks.

    data: uint8[B, N+8] zero-padded; lengths: int32[B]; N <= 128K,
    N % SEG == 0.  Returns (sel bool[B,N], take bool[B,N], mlen int32[B,N],
    mdist int32[B,N], freq_ll int32[B,286], freq_d int32[B,30]).

    With ``lz4_rules`` the parse obeys the LZ4 block contract instead of
    deflate's (reference src/qatzip_utils.c:264-341 maps both onto the same
    HW search): min match 4 (no len-3 matches), and the end-of-block
    restrictions — the last 5 bytes are literals and no match begins within
    the final 12 bytes (lz4 frame format spec; reference README.md:164).
    """
    B = data.shape[0]
    n = data.shape[1] - 8
    assert n <= MAX_BLOCK and n % SEG == 0
    pos_bits = _pos_bits(n)
    pos_mask = (1 << pos_bits) - 1
    hash_bits = min(15, 32 - pos_bits)

    d32 = data.astype(_U32)
    b4 = (d32[:, 0:n] | (d32[:, 1:n + 1] << 8)
          | (d32[:, 2:n + 2] << 16) | (d32[:, 3:n + 3] << 24))
    pos = jnp.arange(n, dtype=jnp.int32)[None, :]
    L = lengths[:, None]
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]

    # shifted prefix words ride the sort as payloads: in sorted order the
    # candidate's words are one-element shifts — match extension becomes
    # elementwise payload compares instead of random reads
    b4s = [b4]
    for k in range(4, 4 * kwords, 4):
        b4s.append(jnp.concatenate(
            [b4[:, k:], jnp.zeros((B, k), _U32)], axis=-1))

    h = (b4 * _U32(2654435761)) >> _U32(32 - hash_bits)
    valid = (pos + 3) < L
    keys = jnp.where(valid, (h << pos_bits) | pos.astype(_U32), _INVALID)
    sorted_all = _vsort(keys, *b4s)
    sk = sorted_all[0]
    pw_sorted = sorted_all[1:]
    cur_pos = (sk & pos_mask).astype(jnp.int32)
    cur_ok = sk != _INVALID
    cur_hash = sk >> pos_bits

    def _matchlen_sorted(dd, nwords):
        """Exact match length (<= 4*nwords+3) of each sorted entry vs its
        dd-back neighbour, via payload word compares only."""
        cand = _shift_right(sk, dd, _INVALID)
        cand_pos = (cand & pos_mask).astype(jnp.int32)
        dist = cur_pos - cand_pos
        ok = (cur_ok & (cand != _INVALID) & ((cand >> pos_bits) == cur_hash)
              & (dist >= 1) & (dist <= WINDOW))
        mlen = jnp.zeros((B, n), jnp.int32)
        alive = ok
        for pw in pw_sorted[:nwords]:
            cw = _shift_right(pw, dd, _U32(0))
            x = pw ^ cw
            eq = x == 0
            part = (((x & 0xFF) == 0).astype(jnp.int32)
                    + ((x & 0xFFFF) == 0).astype(jnp.int32)
                    + ((x & 0xFFFFFF) == 0).astype(jnp.int32))
            mlen = mlen + jnp.where(alive, jnp.where(eq, 4, part), 0)
            alive = alive & eq
        return jnp.where(ok & (mlen >= 4), mlen, 0), dist

    # nearest chain entry gets the full extension; deeper entries get a
    # short scored extension (their emitted length is the verified prefix,
    # possibly truncated — the next parse position re-matches the tail)
    ml_s, dist_s = _matchlen_sorted(1, kwords)
    best = jnp.where(ml_s > 0, (ml_s << 15) | (32767 - (dist_s - 1)), 0)
    for dd in range(2, depth + 1):
        ml_s, dist_s = _matchlen_sorted(dd, 4)
        cand = jnp.where(ml_s > 0, (ml_s << 15) | (32767 - (dist_s - 1)), 0)
        best = jnp.maximum(best, cand)

    # unscramble to position order with a second sort; invalid entries sort
    # past all real positions, and positions >= length-3 (masked from the
    # first sort) cannot have matches — the sorted prefix aligns 1:1 with
    # positions [0, length-3)
    keys2 = jnp.where(cur_ok, (cur_pos.astype(_U32) << 15)
                      | (32767 - (best & 0x7FFF)).astype(_U32), _INVALID)
    (sk2, ml_pay) = _vsort(keys2, best >> 15)
    in_range = (pos + 3 < L) & (sk2 != _INVALID)
    low15 = (sk2 & _U32(0x7FFF)).astype(jnp.int32)  # dist-1, 32767 = none
    dist_p = jnp.where(in_range & (low15 != 32767), low15 + 1, 0)
    mlen_h = jnp.where(dist_p > 0, ml_pay, 0)
    maxm = jnp.minimum(jnp.int32(258), L - pos)
    mlen_h = jnp.minimum(mlen_h, maxm)

    # --- len-3 matches (deflate min match) from a 3-byte-hash chain; only
    # near distances are worthwhile (zlib's too_far heuristic)
    b3 = b4 & _U32(0xFFFFFF)
    h3 = (b3 * _U32(2654435761)) >> _U32(32 - hash_bits)
    valid3 = (pos + 2) < L
    keys3 = jnp.where(valid3, (h3 << pos_bits) | pos.astype(_U32), _INVALID)
    sk3, q3 = _vsort(keys3, b3)
    c3 = _shift_right(sk3, 1, _INVALID)
    c3q = _shift_right(q3, 1, _U32(0))
    d3 = (sk3 & pos_mask).astype(jnp.int32) - (c3 & pos_mask).astype(jnp.int32)
    ok3 = ((sk3 != _INVALID) & (c3 != _INVALID)
           & ((c3 >> pos_bits) == (sk3 >> pos_bits)) & (q3 == c3q)
           & (d3 >= 1) & (d3 < 4096))
    key3b = jnp.where(sk3 != _INVALID,
                      (((sk3 & pos_mask)) << 15)
                      | jnp.where(ok3, d3 - 1, 32767).astype(_U32), _INVALID)
    (sk3b,) = _vsort(key3b)
    low3 = (sk3b & _U32(0x7FFF)).astype(jnp.int32)
    dist3_p = jnp.where((pos + 2 < L) & (sk3b != _INVALID) & (low3 != 32767),
                        low3 + 1, 0)
    has3 = (dist3_p > 0) & (dist_p == 0) & (maxm >= 3)

    # exact dist-1 runs via log-doubling (elementwise): covers RLE data
    # beyond the 19-byte payload cap, up to the full 258
    eq_prev = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.bool_), data[:, 1:n] == data[:, 0:n - 1]],
        axis=-1)
    r = eq_prev.astype(jnp.int16)
    s = 1
    while s < 258:
        r_sh = _shift_left(r, s, jnp.int16(0))
        r = jnp.where(r >= s, jnp.minimum(s + r_sh, jnp.int16(258)), r)
        s <<= 1
    mlen_rle = jnp.minimum(r.astype(jnp.int32), jnp.minimum(maxm, 258))

    use_rle = (mlen_rle >= 4) & (mlen_rle >= mlen_h)
    mlen = jnp.where(use_rle, mlen_rle, mlen_h)
    mdist = jnp.where(use_rle, 1, dist_p)
    take = (mlen >= 4) & (mdist >= 1)
    if not lz4_rules:
        # deflate's min match is 3: use near len-3 matches where nothing
        # longer is available
        m3 = has3 & ~take
        mlen = jnp.where(m3, 3, mlen)
        mdist = jnp.where(m3, dist3_p, mdist)
        take = take | m3
    else:
        # LZ4 end-of-block: last 5 bytes literal, no match start in the
        # final 12 bytes; matches may not extend into the last 5 bytes
        take = take & (pos <= L - 13) & (pos + mlen <= L - 5)
    if depth >= 6:
        # one-step lazy matching (zlib levels >= 4): prefer the longer
        # match starting one byte later
        nxt_len = _shift_left(mlen, 1, 0)
        take = take & ~(nxt_len > mlen)
    mlen = jnp.where(take, mlen, 0)
    mdist = jnp.where(take, mdist, 0)

    # --- greedy parse: chain membership is the one random-access stage
    step = jnp.where(take, mlen, 1)
    f = jnp.minimum(pos + step, n)
    nseg = n // SEG
    seg_end = ((pos // SEG) + 1) * SEG

    # X(i) = first chain position >= seg_end(i), via clamped doubling
    X = f
    hops = 1
    while hops < SEG:
        nxt = _take(X, jnp.clip(X, 0, n - 1))
        X = jnp.where(X >= seg_end, X, jnp.where(X >= n, n, nxt))
        hops <<= 1

    def entry_step(e, s_):
        bound = (s_ + 1) * SEG
        nxt = _take(X, jnp.clip(e, 0, n - 1))[:, 0]
        e2 = jnp.where(e[:, 0] >= bound, e[:, 0],
                       jnp.where(e[:, 0] >= n, n, nxt))
        return e2[:, None], e[:, 0]

    _, entries = jax.lax.scan(entry_step, jnp.zeros((B, 1), jnp.int32),
                              jnp.arange(nseg, dtype=jnp.int32))
    entries = jnp.moveaxis(entries, 0, 1)  # [B, nseg]

    seg_hi = (jnp.arange(nseg, dtype=jnp.int32) + 1)[None, :] * SEG

    def walk_step(p, _):
        out = p
        nxt = _take(f, jnp.clip(p, 0, n - 1))
        p2 = jnp.where(p < seg_hi, nxt, p)
        return p2, out

    _, visited = jax.lax.scan(walk_step, entries, None, length=SEG)
    visited = jnp.moveaxis(visited, 0, 2)  # [B, nseg, SEG]
    seg_lo3 = (jnp.arange(nseg, dtype=jnp.int32) * SEG)[None, :, None]
    ok_slot = ((visited >= seg_lo3) & (visited < seg_lo3 + SEG)
               & (visited < L[:, :, None]))
    slots = jnp.where(ok_slot, visited, n).reshape(B, n)

    # one scatter builds the chain-membership mask in position order
    slots_b, ones_b = _OB((slots, jnp.ones((B, n), jnp.bool_)))
    selpad = jnp.zeros((B, n + 128), jnp.bool_)
    sel = _OB(selpad.at[rows, slots_b].set(ones_b))[:, :n]
    sel = sel & (pos < L)
    take = sel & take

    # --- histograms (position space, elementwise symbols + one-hot matmul)
    lc, _, _ = length_code(mlen)
    lit = data[:, :n].astype(jnp.int32)
    sym = jnp.where(take, lc, lit)
    freq_ll = _hist_onehot(jnp.clip(sym, 0, 285), sel, 286)
    freq_ll = freq_ll.at[:, 256].add(1)  # EOB (static-index update)
    dc, _, _ = dist_code(mdist)
    freq_d = _hist_onehot(jnp.clip(dc, 0, 29), take, 30)
    return sel, take, mlen, mdist, freq_ll, freq_d


def _ffill_u32(marker: jnp.ndarray, vals: jnp.ndarray) -> jnp.ndarray:
    """Forward-fill 32-bit ``vals`` from marker positions along the minor
    axis, elementwise only: three 12-bit planes each packed with a running
    position key and forward-filled by cummax."""
    B, M = marker.shape
    idx = jnp.arange(M, dtype=jnp.int32)[None, :] + 1  # 0 = "nothing yet"
    key = jnp.where(marker, idx, 0)
    out = jnp.zeros((B, M), _U32)
    for plane in range(3):
        part = (vals >> _U32(12 * plane)) & _U32(0xFFF)
        packed = jnp.where(marker, (key << 12) | part.astype(jnp.int32), 0)
        filled = jax.lax.cummax(packed, axis=1)
        out = out | ((filled & 0xFFF).astype(_U32) << _U32(12 * plane))
    return out


def _lookup_sorted(table: jnp.ndarray, idx: jnp.ndarray,
                   tbits: int) -> jnp.ndarray:
    """y[b,i] = table[b, idx[b,i]] via sort-merge + forward-fill + unsort
    (per-block tables, no random gathers).  table: int32[B,T] values
    < 2^20; idx: int32 [B,N] in [0,T); tbits = ceil_log2(T)."""
    B, T = table.shape
    N = idx.shape[1]
    M = T + N
    ibits = 18  # enough for M up to 256K entries
    # records: table entries first at each key (flag 0), queries flag 1
    tkey = ((jnp.arange(T, dtype=jnp.int32)[None, :].repeat(B, 0) << 1)
            << ibits)
    qkey = ((idx << 1) | 1) << ibits
    # low bits keep record identity for the unsort
    tkey = (tkey | jnp.arange(T, dtype=jnp.int32)[None, :]).astype(_U32)
    qkey = (qkey | (jnp.arange(N, dtype=jnp.int32)[None, :] + T)).astype(_U32)
    keys = jnp.concatenate([tkey, qkey], axis=-1)
    pay = jnp.concatenate([table.astype(_U32),
                           jnp.zeros((B, N), _U32)], axis=-1)
    skeys, spay = _vsort(keys, pay)
    is_tab = ((skeys >> ibits) & 1) == 0
    filled = _ffill_u32(is_tab, spay)
    # unsort: order by record identity, keep only query records
    rid = (skeys & ((1 << ibits) - 1)).astype(jnp.int32)
    k2 = jnp.where(is_tab, jnp.int32(M + 1), rid - T).astype(_U32)
    _, out = _vsort(k2, filled)
    return out[:, :N].astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("m_words",))
def pack_blocks(data: jnp.ndarray, sel: jnp.ndarray, take: jnp.ndarray,
                mlen: jnp.ndarray, mdist: jnp.ndarray,
                hdr_vals: jnp.ndarray, hdr_nbits: jnp.ndarray,
                ll_len: jnp.ndarray, ll_code: jnp.ndarray,
                d_len: jnp.ndarray, d_code: jnp.ndarray, m_words: int):
    """K2: emit the deflate bitstream for a batch of blocks, scatter- and
    gather-free (sort-merge lookups, prefix-sum packing).

    Per-position fields: position p carries the literal-or-length field;
    position p+1 carries the distance field of a match starting at p (p+1
    is always interior to that match).  Code tables are host-built
    ([B,286]/[B,30] int32, already mode-selected).  Returns
    (words uint32[B, m_words], bits int32[B]).
    """
    B, n = sel.shape
    lit = data[:, :n].astype(jnp.int32)

    lc, leb, lev = length_code(mlen)
    dc, deb, dev = dist_code(mdist)
    sym = jnp.clip(jnp.where(take, lc, lit), 0, 285)

    # fused per-block lookup of (code, len) pairs: value = code | len<<15
    ll_fused = (ll_code | (ll_len << 15)).astype(jnp.int32)
    ll_hit = _lookup_sorted(ll_fused, sym, 9)
    ll_c = ll_hit & 0x7FFF
    ll_n = ll_hit >> 15
    d_fused = (d_code | (d_len << 15)).astype(jnp.int32)
    d_hit = _lookup_sorted(d_fused, jnp.clip(dc, 0, 29), 5)
    d_c = d_hit & 0x7FFF
    d_n = d_hit >> 15

    # field A at p: literal or length code (+ length extra), <= 20 bits
    aV = jnp.where(sel, (ll_c | (lev << ll_n)).astype(_U32), _U32(0))
    aN = jnp.where(sel, ll_n + jnp.where(take, leb, 0), 0)
    # field B at p+1: distance code + extra of the match starting at p
    bV_at_p = jnp.where(take, (d_c | (dev << d_n)).astype(_U32), _U32(0))
    bN_at_p = jnp.where(take, d_n + deb, 0)
    bV = _shift_right(bV_at_p, 1, _U32(0))
    bN = _shift_right(bN_at_p, 1, 0)
    # a match at p forbids a field at p+1 from the position grid itself
    # (p+1 is interior), so the slot is free for the distance field
    posV = jnp.where(bN > 0, bV, aV)
    posN = jnp.where(bN > 0, bN, aN)
    # sanity: aN and bN can never both be nonzero at one position — p+1 of
    # a match is never selected

    eob_v = ll_fused[:, 256:257]
    eob_n = (eob_v >> 15)
    values = jnp.concatenate([hdr_vals, posV,
                              (eob_v & 0x7FFF).astype(_U32)], axis=-1)
    nbits = jnp.concatenate([hdr_nbits, posN, eob_n], axis=-1)
    fpad = (-values.shape[1]) % 128
    if fpad:
        values = jnp.pad(values, ((0, 0), (0, fpad)))
        nbits = jnp.pad(nbits, ((0, 0), (0, fpad)))
    F = values.shape[1]

    # --- scatter-free packing: per-field prefix sums ride a merge sort to
    # the word-boundary queries, and per-word values are forward-filled
    # prefix differences.  Contributions to a word occupy disjoint bit
    # ranges (sum == or); u32 wraparound subtraction is exact.
    nb = nbits.astype(jnp.int32)
    cum = jnp.cumsum(nb, axis=-1)
    off = cum - nb
    total_bits = cum[:, -1]

    vmask = jnp.where(nb > 0, values.astype(_U32), _U32(0))
    bit = (off & 31).astype(_U32)
    lo = vmask << bit
    hi = jnp.where(bit == 0, _U32(0), vmask >> (_U32(32) - bit))
    ps_lo = jnp.cumsum(lo, axis=-1)
    ps_hi = jnp.cumsum(hi, axis=-1)
    word_idx = off >> 5

    # merge fields and word queries: field record key = (word_idx, 1),
    # query key = (w, 0) — queries precede same-word fields, so the
    # forward-filled ps value at a query is the ps of the last field of
    # word w-1, i.e. the prefix boundary we need.
    wq = jnp.arange(m_words, dtype=jnp.int32)[None, :].repeat(B, 0)
    fkey = ((word_idx << 1) | 1).astype(_U32) << 13
    qkey = (wq << 1).astype(_U32) << 13
    # identity bits for the compaction; m_words <= 2^13*... use full sort
    keys = jnp.concatenate([fkey, qkey], axis=-1)
    ident = jnp.concatenate(
        [jnp.zeros((B, F), jnp.int32),
         jnp.arange(m_words, dtype=jnp.int32)[None, :].repeat(B, 0) + 1],
        axis=-1)
    pl = jnp.concatenate([ps_lo, jnp.zeros((B, m_words), _U32)], axis=-1)
    ph = jnp.concatenate([ps_hi, jnp.zeros((B, m_words), _U32)], axis=-1)
    skeys, sident, spl, sph = _vsort(keys, ident, pl, ph)
    is_field = (skeys >> 13) & 1 == 1
    fl = _ffill_u32(is_field, spl)
    fh = _ffill_u32(is_field, sph)
    # compact query records back to word order
    k2 = jnp.where(is_field, jnp.int32(F + m_words + 2), sident).astype(_U32)
    _, cfl, cfh = _vsort(k2, fl, fh)
    bnd_lo = cfl[:, :m_words]   # ps_lo at last field of word w-1
    bnd_hi = cfh[:, :m_words]
    nxt_lo = jnp.concatenate(
        [bnd_lo[:, 1:], jnp.cumsum(lo, axis=-1)[:, -1:]], axis=-1)
    nxt_hi = jnp.concatenate(
        [bnd_hi[:, 1:], jnp.cumsum(hi, axis=-1)[:, -1:]], axis=-1)
    w_direct = nxt_lo - bnd_lo          # sum of lo parts of word w's fields
    prev_hi = jnp.concatenate(
        [jnp.zeros((B, 1), _U32), bnd_hi[:, :-1]], axis=-1)
    w_carry = bnd_hi - prev_hi          # hi parts of word w-1's fields
    words = w_direct + w_carry
    return words, total_bits


def encode_blocks(data, lengths, depth: int, kwords: int,
                  allow_dynamic: bool, m_words: int, mesh=None):
    """One-call convenience: K1 -> host Huffman build -> K2.

    data: uint8[B, N+8]; lengths: int32[B].
    Returns (words uint32[B, m_words], bits int32[B], mode int32[B]) as
    numpy arrays.  Blocks with mode==MODE_STORED must be emitted by the
    caller (host stored-block framing).

    With ``mesh`` set, both device dispatches run block-data-parallel over
    the mesh's "block" axis (B must divide by the mesh size) — the device
    analog of the reference's request-level chunk parallelism sharded over
    instances/devices (src/qatzip.c:1505-1594, README.md:65-66).
    """
    from qatzip_tpu.native import qzcore as native

    if mesh is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        mat = NamedSharding(mesh, P("block", None))
        row = NamedSharding(mesh, P("block"))

        def put_mat(a):
            return jax.device_put(jnp.asarray(a), mat)

        def put_row(a):
            return jax.device_put(jnp.asarray(a), row)
    else:
        put_mat = jnp.asarray
        put_row = jnp.asarray

    data = put_mat(data)
    lengths = put_row(lengths)
    sel, take, mlen, mdist, freq_ll, freq_d = analyze_blocks(
        data, lengths, depth, kwords)
    mode, ll_len, ll_code, d_len, d_code, hv, hn, _est = \
        native.huff_build_batch(np.asarray(freq_ll), np.asarray(freq_d),
                                np.asarray(lengths), allow_dynamic,
                                32 * m_words, HDR_MAX)
    words, bits = pack_blocks(
        data, sel, take, mlen, mdist,
        put_mat(hv.astype(np.uint32)), put_mat(hn),
        put_mat(ll_len), put_mat(ll_code),
        put_mat(d_len), put_mat(d_code), m_words)
    # device arrays returned un-fetched: callers overlap the D2H transfer
    # with the next batch's dispatch (JAX async dispatch = the submit/poll
    # pipeline of the reference, src/qatzip.c:1483-1764)
    return words, bits, mode
