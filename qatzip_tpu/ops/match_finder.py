"""K1 v2: sort-based LZ77 candidate finder (the device half of the hybrid
deflate pipeline).

The finder is built from exactly two sorts plus elementwise ops, with no
gathers or scatters, and hands the per-position candidate distances to the
native parser (qz_deflate_candidates in native/qzdeflate.cpp), which
verifies and extends matches by direct byte compare — the reference's
split between the ASIC search engine and the driver
(src/qatzip.c:1483-1764) with the device playing the search engine.

Pipeline per 64KB block (batched [B, n]):
  1. 3-byte hash keys  key1 = h15 << 16 | pos16   (elementwise)
  2. sort1 by key1 carrying the 4-byte prefix word b4 as payload
  3. candidate select: for chain depth dd=1..DEPTH the dd-back sorted
     neighbour with equal hash is a candidate at distance
     pos - cand_pos; prefix length (3/4) from payload word compares —
     all shifts/compares in sorted order, no random access
  4. sort2 by pos to unscramble, payload = chosen distance
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
_INVALID_V = 0xFFFFFFFF  # materialized lazily: creating a jnp scalar at
                         # import time would initialize the jax backend

DEPTH = 4          # hash-chain depth (level->depth map lives in caller)
TOO_FAR = 4096     # len-3 matches beyond this distance are not worth bits


def find_candidates(data: jnp.ndarray, lengths: jnp.ndarray,
                    depth: int = DEPTH,
                    stride: int | None = None,
                    rank8: bool | None = None) -> jnp.ndarray:
    """data: uint8[B, n+8] zero-padded, n <= 65536 pow2; lengths: int32[B].

    Returns uint16[B, n]: per-position candidate distance (0 = none).
    Candidates are verified to a 3-/4-/8-byte prefix only — the native
    parser re-verifies and extends to the exact length.
    """
    if stride is None:
        import os

        stride = int(os.environ.get("QATZIP_TPU_MF_STRIDE", "1"))
    if rank8 is None:
        import os

        # rank8: carry the second prefix word (bytes 4..7) through the
        # sort so candidates rank by verified 8-byte prefix.  Dropping it
        # removes one payload operand from sort1 (~15% of device compute)
        # at a small ratio cost — only sound where the parser's two-sided
        # neighbour probes recover coverage (stride >= 2).
        rank8 = os.environ.get("QATZIP_TPU_MF_RANK8", "1") != "0"
    return _find_candidates_impl(data, lengths, depth, int(stride),
                                 bool(rank8))


@functools.partial(jax.jit, static_argnames=("depth", "stride", "rank8"))
def _find_candidates_impl(data: jnp.ndarray, lengths: jnp.ndarray,
                          depth: int, stride: int = 1,
                          rank8: bool = True) -> jnp.ndarray:
    _INVALID = _U32(_INVALID_V)
    B = data.shape[0]
    n = data.shape[1] - 8
    d32 = data.astype(_U32)
    b4 = (d32[:, 0:n] | (d32[:, 1:n + 1] << 8)
          | (d32[:, 2:n + 2] << 16) | (d32[:, 3:n + 3] << 24))
    b3 = b4 & _U32(0xFFFFFF)
    pos = jnp.arange(n, dtype=jnp.int32)[None, :]
    L = lengths[:, None]

    # second prefix word (bytes 4..7) rides the sort too, so candidates
    # rank by verified 8-byte prefix — greedy-nearest alone picks short
    # matches on repetitive text and loses to zlib's best-of-chain walk
    # (skipped when rank8=False: one payload operand less in sort1)
    b4b = (jnp.concatenate([b4[:, 4:], jnp.zeros((B, 4), _U32)], axis=-1)
           if rank8 else None)

    h = (b3 * _U32(2654435761)) >> _U32(17)          # 15-bit 3-gram hash
    valid = pos + 2 < L
    key1 = jnp.where(valid, (h << _U32(16)) | pos.astype(_U32), _INVALID)
    n_full = n
    if stride > 1:
        # QATZIP_TPU_MF_STRIDE: index only every stride-th position — the
        # sorts (the whole cost) shrink by the same factor; the native
        # parser's byte-compare extension recovers most of the lost
        # coverage (zlib's own fast levels insert sparsely the same way)
        n = n // stride
        lim = n * stride   # trim the ragged tail when stride doesn't divide
        ops = ((key1[:, :lim:stride], b4[:, :lim:stride],
                b4b[:, :lim:stride]) if rank8
               else (key1[:, :lim:stride], b4[:, :lim:stride]))
    else:
        ops = (key1, b4, b4b) if rank8 else (key1, b4)
    with jax.named_scope("mf_sort_hash"):
        sorted_ops = jax.lax.sort(ops, num_keys=1, is_stable=True)
    if rank8:
        sk, sb4, sb4b = sorted_ops
    else:
        sk, sb4 = sorted_ops
        sb4b = jnp.zeros_like(sb4)  # eq8 degenerates to eq4: rank-4 only

    cur_pos = (sk & _U32(0xFFFF)).astype(jnp.int32)
    cur_ok = sk != _INVALID
    cur_h = sk >> _U32(16)

    def shift_right(a, k, fill):
        pad = jnp.full((B, k), fill, a.dtype)
        return jnp.concatenate([pad, a[:, :-k]], axis=-1)

    with jax.named_scope("mf_select"):
        best8 = jnp.zeros((B, n), jnp.int32)   # nearest, 8-byte prefix
        best4 = jnp.zeros((B, n), jnp.int32)   # nearest, 4-byte prefix
        best3 = jnp.zeros((B, n), jnp.int32)   # nearest, 3-byte prefix
        for dd in range(1, depth + 1):
            ck = shift_right(sk, dd, _INVALID)
            cb4 = shift_right(sb4, dd, _U32(0))
            cb4b = shift_right(sb4b, dd, _U32(0))
            cpos = (ck & _U32(0xFFFF)).astype(jnp.int32)
            dist = cur_pos - cpos
            ok = (cur_ok & (ck != _INVALID) & ((ck >> _U32(16)) == cur_h)
                  & (dist >= 1) & (dist <= 32767))
            eq4 = ok & (cb4 == sb4)
            eq8 = eq4 & (cb4b == sb4b)
            eq3 = ok & (((cb4 ^ sb4) & _U32(0xFFFFFF)) == 0)
            # nearest-first within rank (dd ascends by recency in a chain)
            best8 = jnp.where((best8 == 0) & eq8, dist, best8)
            best4 = jnp.where((best4 == 0) & eq4, dist, best4)
            best3 = jnp.where((best3 == 0) & eq3, dist, best3)

        best3 = jnp.where(best3 < TOO_FAR, best3, 0)
        dist_sorted = jnp.where(best8 > 0, best8,
                                jnp.where(best4 > 0, best4, best3))

    # unscramble: key2 = pos<<16 keeps sorted row i aligned with position i
    # (with stride, sorted row i aligns with position stride*i)
    key2 = jnp.where(cur_ok, (cur_pos.astype(_U32) << _U32(16)), _INVALID)
    with jax.named_scope("mf_sort_pos"):
        _, dist_pos = jax.lax.sort((key2, dist_sorted.astype(_U32)),
                                   num_keys=1, is_stable=True)
    if stride > 1:
        # interleave with zero columns via stack+reshape — a layout-only
        # transform, no scatter
        parts = [dist_pos] + [jnp.zeros_like(dist_pos)] * (stride - 1)
        full = jnp.stack(parts, axis=-1).reshape(B, -1)
        if full.shape[1] < n_full:   # ragged tail: no candidates there
            full = jnp.concatenate(
                [full, jnp.zeros((B, n_full - full.shape[1]), full.dtype)],
                axis=-1)
        return full.astype(jnp.uint16)
    return dist_pos.astype(jnp.uint16)


# ---------------------------------------------------------------------------
# Packed candidate format (round-4 D2H cut): the uint16-per-position stream
# costs 2 B of device->host traffic per input byte — the QAT ASIC returns
# *compressed* bytes, ratio x smaller than the input (reference
# src/qatzip.c:1610-1718).  This packs to a fixed 0.75 B/B:
#   2-bit class per position (n/4 bytes):
#     0 = no candidate; 1 = same distance as previous position (run
#     continuation — ~75% of positions on text); 2 = exception (distance
#     in the side stream); 3 = distance 1
#   exception stream (n/2 bytes): per 64-position chunk, up to 16 uint16
#     distances in position order; overflowed exceptions (2.7% measured on
#     zipf text, the worst class) degrade to "repeat previous" — a stale
#     guess the parser's byte-compare verification makes safe.
# All elementwise + within-chunk cumsum + 16 masked reduces — no extra
# sort, so device compute is barely touched.  Decoded by
# unpack_candidates (native/qzdeflate.cpp).
# ---------------------------------------------------------------------------
EXC_PER_CHUNK = 16
CHUNK_P = 64


@functools.partial(jax.jit, static_argnames=("depth", "stride"))
def _find_candidates_packed_impl(data, lengths, depth, stride):
    d = _find_candidates_impl(data, lengths, depth,
                              stride).astype(jnp.uint32)
    B, n = d.shape
    prev = jnp.concatenate([jnp.zeros((B, 1), d.dtype), d[:, :-1]], axis=1)
    isrep = (d == prev) & (d != 0)
    cls = jnp.where(d == 0, 0,
                    jnp.where(isrep, 1,
                              jnp.where(d == 1, 3, 2))).astype(jnp.uint32)
    nc = n // CHUNK_P
    f3 = (cls == 2).reshape(B, nc, CHUNK_P)
    lidx = jnp.cumsum(f3.astype(jnp.int32), axis=-1) - 1
    keep3 = f3 & (lidx < EXC_PER_CHUNK)
    # overflowed exceptions degrade to "repeat previous" rather than
    # "none": the native parser verifies candidates by byte compare, so a
    # stale-distance guess can only recover matches, never corrupt
    cls = jnp.where((cls == 2) & ~keep3.reshape(B, n), 1, cls)
    d3 = d.reshape(B, nc, CHUNK_P)
    exc_cols = []
    for s in range(EXC_PER_CHUNK):
        exc_cols.append(jnp.sum(
            jnp.where(keep3 & (lidx == s), d3, 0), axis=-1))
    exc = jnp.stack(exc_cols, axis=-1).astype(jnp.uint16)  # [B, nc, 16]
    two = (cls[:, 0::4] | (cls[:, 1::4] << jnp.uint32(2))
           | (cls[:, 2::4] << jnp.uint32(4))
           | (cls[:, 3::4] << jnp.uint32(6))).astype(jnp.uint8)
    exc8 = jax.lax.bitcast_convert_type(
        exc.reshape(B, nc * EXC_PER_CHUNK), jnp.uint8).reshape(B, -1)
    return jnp.concatenate([two, exc8], axis=1)  # u8 [B, 3n/4]


def find_candidates_packed(data: jnp.ndarray, lengths: jnp.ndarray,
                           depth: int = DEPTH) -> jnp.ndarray:
    """Packed variant of find_candidates: u8[B, 3n/4] per the format above
    (stride mode is not packed — the stride knob already trades ratio)."""
    return _find_candidates_packed_impl(data, lengths, depth, 1)


def find_candidates_batch(data_np: np.ndarray, lengths_np: np.ndarray,
                          depth: int = DEPTH, mesh=None) -> np.ndarray:
    """Host wrapper: upload, run, return uint16[B, n] distances.

    With ``mesh`` the batch axis shards block-DP over the local device
    mesh (the request-level parallelism axis, SURVEY §2.3)."""
    dj = jnp.asarray(data_np)
    lj = jnp.asarray(lengths_np)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        dj = jax.device_put(dj, NamedSharding(mesh, P("block", None)))
        lj = jax.device_put(lj, NamedSharding(mesh, P("block")))
    return np.asarray(find_candidates(dj, lj, depth))
