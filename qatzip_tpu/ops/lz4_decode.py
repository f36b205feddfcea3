"""Device LZ4 / LZ4s block decoder (JAX/XLA).

The reference decompresses LZ4 frames through the same DC hardware API as
deflate (src/qatzip.c:2103-2355, LZ4 framing parse src/qatzip_utils.c:
1232-1345).  The device translation: token parsing is byte-oriented and
embarrassingly position-parallel, so every byte offset speculatively
parses as a sequence start (elementwise + a few gathers), the real
sequence chain is materialized by pointer doubling from offset 0, and
match copies — which may overlap (dist < len, RFC-legal RLE) — resolve
with a log-doubling source-pointer composition over the output axis.

Grammar (lz4_block_decompress host oracle, engine/lz4_block.py:104):
  sequence = token(1B: litlen<<4|mlen) [lit ext 255*…] literals
             offset(2B LE) [match ext 255*…]
  LZ4: matchlen += 4 (MINMATCH); terminal sequence is literal-only.
  LZ4s: matchlen += mini_match-1 unless 0 (a 0-match sequence is legal).

Length extensions are parsed to full range via one log-doubling pass
computing the 0xFF-run length at every byte (ext value = 255*run +
terminator byte) — no per-byte scan, no length cap below the block size.
"""
from __future__ import annotations

import functools

import numpy as np

EXT_RUN_CAP = 512     # max 0xFF-run in a length extension (len <= ~130K)
MAX_BLOCK = 1 << 16   # block payloads beyond 64KB fall back to CPU
MAX_OUT = 1 << 17


def _next_pow2(x: int, lo: int) -> int:
    p = lo
    while p < x:
        p <<= 1
    return p


@functools.partial(__import__("jax").jit,
                   static_argnames=("n", "outcap", "lz4s", "base"))
def _decode_blocks_impl(b, blk_len, n: int, outcap: int, lz4s: bool,
                        base: int):
    import jax
    import jax.numpy as jnp

    _OB = jax.lax.optimization_barrier
    I32 = jnp.int32
    B = b.shape[0]
    pos = jnp.arange(n, dtype=I32)[None, :]
    L = blk_len[:, None]
    bi = b.astype(I32)

    def shifted(k):
        return jnp.concatenate(
            [bi[:, k:], jnp.zeros((B, k), I32)], axis=-1) if k else bi

    def gat(idx):
        a, i = _OB((bi, jnp.clip(idx, 0, n - 1)))
        return _OB(jnp.take_along_axis(a, i, axis=-1, mode="clip"))

    # --- speculative per-position sequence parse -------------------------
    token = bi
    lit0 = token >> 4
    m0 = token & 15

    # 0xFF-run length at every byte via log-doubling: a length extension
    # starting at q is run[q] bytes of 255 plus one terminator, so
    # ext_value = 255*run[q] + b[q+run[q]] in O(log) elementwise passes
    run = (bi == 255).astype(I32)
    s = 1
    while s < EXT_RUN_CAP:
        r_sh = jnp.concatenate([run[:, s:], jnp.zeros((B, s), I32)], axis=-1)
        run = jnp.where(run >= s,
                        jnp.minimum(s + r_sh, I32(EXT_RUN_CAP)), run)
        s <<= 1
    run_overflow = run >= EXT_RUN_CAP

    def parse_ext(q, active):
        """(ext_len_bytes, ext_value, overflow) of the length extension at
        byte offset q (array), where active marks fields with base == 15."""
        r_q = gat(q)          # unused fast path guard (keeps q clipped)
        del r_q
        rl = jnp.take_along_axis(*_OB((run, jnp.clip(q, 0, n - 1))),
                                 axis=-1, mode="clip")
        rl = _OB(rl)
        term = gat(q + rl)
        e_len = jnp.where(active, rl + 1, 0)
        e_val = jnp.where(active, 255 * rl + term, 0)
        ovf_q = jnp.take_along_axis(*_OB((run_overflow.astype(I32),
                                          jnp.clip(q, 0, n - 1))),
                                    axis=-1, mode="clip")
        ovf = active & (_OB(ovf_q) != 0)
        return e_len, e_val, ovf

    lit_ext_len, lit_ext_val, lit_overflow = parse_ext(pos + 1, lit0 == 15)
    litlen = lit0 + lit_ext_val
    lit_start = pos + 1 + lit_ext_len
    q2 = lit_start + litlen             # offset field position (varies)

    # terminal literal-only sequence: consumes exactly to block end
    terminal = q2 == L

    # match fields via gathers at the variable offset q2
    off = gat(q2) | (gat(q2 + 1) << 8)
    m_ext_len, m_ext_val, m_overflow = parse_ext(q2 + 2, m0 == 15)
    mraw = m0 + m_ext_val
    if lz4s:
        mlen = jnp.where(mraw != 0, mraw + base, 0)
    else:
        mlen = mraw + 4
    mlen = jnp.where(terminal, 0, mlen)
    off = jnp.where(terminal, 0, off)

    nxt = jnp.where(terminal, L, q2 + 2 + m_ext_len)
    bad = ((lit_overflow | (~terminal & (m_overflow | (off == 0)))
            | (q2 > L) | (nxt > L)))
    out_adv = litlen + mlen

    # --- chain materialization from position 0 ---------------------------
    # doubling tables: F[k] = next^(2^k), S[k] = output bytes over that hop,
    # E[k] = any-bad over that hop
    nxt_c = jnp.minimum(nxt, n)
    LOG = max(1, (n - 1).bit_length())
    Fs, Ss, Es = [nxt_c], [out_adv], [bad]
    for _ in range(LOG - 1):
        F, S, E = Fs[-1], Ss[-1], Es[-1]
        idx = jnp.clip(F, 0, n - 1)
        a, i = _OB((F, idx))
        F2 = jnp.where(F >= L, F, _OB(jnp.take_along_axis(a, i, axis=-1,
                                                          mode="clip")))
        s_src, _ = _OB((S, idx))
        S2 = S + jnp.where(F >= L,
                           0, _OB(jnp.take_along_axis(s_src, i, axis=-1,
                                                      mode="clip")))
        e_src, _ = _OB((E.astype(I32), idx))
        E2 = E | (jnp.where(F >= L, 0,
                            _OB(jnp.take_along_axis(e_src, i, axis=-1,
                                                    mode="clip"))) != 0)
        Fs.append(F2)
        Ss.append(S2)
        Es.append(E2)

    # enumerate the first J chain nodes via bit decomposition of the slot
    # index: slot j holds (in_pos, out_pos) of the j-th sequence
    J = n // 3 + 2
    Jp = _next_pow2(J, 128)
    j_idx = jnp.arange(Jp, dtype=I32)[None, :]
    a_pos = jnp.zeros((B, Jp), I32)
    a_out = jnp.zeros((B, Jp), I32)
    a_bad = jnp.zeros((B, Jp), jnp.bool_)
    for k in range(LOG - 1, -1, -1):
        bit = (j_idx >> k) & 1
        idx = jnp.clip(a_pos, 0, n - 1)
        F, S, E = Fs[k], Ss[k], Es[k]
        fa, ia = _OB((F, idx))
        f_at = _OB(jnp.take_along_axis(fa, ia, axis=-1, mode="clip"))
        sa, _ = _OB((S, idx))
        s_at = _OB(jnp.take_along_axis(sa, ia, axis=-1, mode="clip"))
        ea, _ = _OB((E.astype(I32), idx))
        e_at = _OB(jnp.take_along_axis(ea, ia, axis=-1, mode="clip")) != 0
        take = (bit == 1) & (a_pos < L)
        a_out = a_out + jnp.where(take, s_at, 0)
        a_bad = a_bad | (take & e_at)
        a_pos = jnp.where(take, jnp.minimum(f_at, n), a_pos)

    live = a_pos < L      # slot j is a real sequence
    err_stream = jnp.any(live & a_bad, axis=-1)

    # per-slot fields by gathering the parse arrays at the slot positions
    def slot_gather(arr):
        sa, si = _OB((arr, jnp.clip(a_pos, 0, n - 1)))
        return _OB(jnp.take_along_axis(sa, si, axis=-1, mode="clip"))

    s_litlen = jnp.where(live, slot_gather(litlen), 0)
    s_litstart = slot_gather(lit_start)
    s_off = jnp.where(live, slot_gather(off), 0)
    s_mlen = jnp.where(live, slot_gather(mlen), 0)
    s_adv = s_litlen + s_mlen
    tot = jnp.sum(jnp.where(live, s_adv, 0), axis=-1)
    err_stream = err_stream | (tot > outcap)

    # --- output construction --------------------------------------------
    # forward-fill per-output-position fields from slot markers at a_out
    o = jnp.arange(outcap, dtype=I32)[None, :]
    # Slots are ordered by a_out (chain order), so the owning slot of each
    # output position comes from a hand-rolled binary search (scatter-free,
    # narrow take_along_axis steps).
    def bsearch(sorted_keys, quer):
        lo = jnp.zeros_like(quer)
        hi = jnp.full_like(quer, Jp)
        for _ in range(int(np.log2(Jp)) + 1):
            mid = (lo + hi) // 2
            a, i = _OB((sorted_keys, jnp.clip(mid, 0, Jp - 1)))
            v = _OB(jnp.take_along_axis(a, i, axis=-1, mode="clip"))
            go = v <= quer
            lo = jnp.where(go, mid + 1, lo)
            hi = jnp.where(go, hi, mid)
        return lo - 1  # last slot with start <= query

    start_key = jnp.where(live & (s_adv > 0), a_out, jnp.iinfo(jnp.int32).max)
    slot_of_o = jnp.clip(bsearch(start_key, o), 0, Jp - 1)

    def o_gather(arr):
        a, i = _OB((arr, slot_of_o))
        return _OB(jnp.take_along_axis(a, i, axis=-1, mode="clip"))

    g_litdelta = o_gather(s_litstart - a_out)
    g_litend = o_gather(a_out + s_litlen)
    g_off = o_gather(s_off)
    in_range = o < tot[:, None]
    is_lit = o < g_litend
    # offset reaching before output start is malformed (host oracle raises)
    err_stream = err_stream | jnp.any(
        in_range & ~is_lit & (o - g_off < 0), axis=-1)
    # source pointer in OUTPUT space for match bytes; literals are ground
    ptr = jnp.where(is_lit, o, o - g_off)
    ptr = jnp.clip(ptr, 0, outcap - 1)
    for _ in range(int(np.log2(outcap)) + 1):
        a, i = _OB((ptr, ptr))
        ptr = _OB(jnp.take_along_axis(a, i, axis=-1, mode="clip"))
    # resolved ptr lands on a literal output position; fetch its input byte
    a, i = _OB((g_litdelta, ptr))
    delta_at = _OB(jnp.take_along_axis(a, i, axis=-1, mode="clip"))
    src_idx = jnp.clip(delta_at + ptr, 0, n - 1)
    a, i = _OB((bi, src_idx))
    out = _OB(jnp.take_along_axis(a, i, axis=-1, mode="clip"))
    out = jnp.where(in_range, out, 0)
    return out.astype(jnp.uint8), tot, err_stream


def decode_blocks(blocks, mini_match: int | None = None):
    """Decode a batch of LZ4 (mini_match=None) or LZ4s blocks on device.

    blocks: list of bytes.  Returns list of bytes-or-None (None = this
    block needs the CPU path: oversize, deep length extensions, or any
    malformed construct the kernel flags).
    """
    import jax.numpy as jnp

    if not blocks:
        return []
    results: list = [None] * len(blocks)
    idxs = [i for i, blk in enumerate(blocks)
            if 0 < len(blk) <= MAX_BLOCK]
    if not idxs:
        return results
    n = _next_pow2(max(len(blocks[i]) for i in idxs) + 8, 1024)
    # high-ratio blocks (RLE-ish) expand far beyond 4x: always allow the
    # full 128K output so small compressed blocks don't fall back
    outcap = min(_next_pow2(max(4 * n, MAX_OUT), 4096), MAX_OUT)
    B = len(idxs)
    Bp = ((B + 7) // 8) * 8
    arr = np.zeros((Bp, n), np.uint8)
    lens = np.zeros((Bp,), np.int32)
    for row, i in enumerate(idxs):
        blk = blocks[i]
        arr[row, :len(blk)] = np.frombuffer(blk, np.uint8)
        lens[row] = len(blk)
    lz4s = mini_match is not None
    base = (mini_match - 1) if lz4s else 0
    out, tot, err = _decode_blocks_impl(jnp.asarray(arr), jnp.asarray(lens),
                                        n, outcap, lz4s, base)
    out = np.asarray(out)
    tot = np.asarray(tot)
    err = np.asarray(err)
    for row, i in enumerate(idxs):
        if err[row] or tot[row] < 0 or tot[row] > outcap:
            results[i] = None
        else:
            results[i] = out[row, : tot[row]].tobytes()
    return results
