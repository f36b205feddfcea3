"""Arithmetic (gather-free) DEFLATE code computations.

The RFC1951 length/distance code tables are computed arithmetically, as
elementwise chains with no table gathers:

  length L in [3,258], l = L-3:
    l < 8:   code 257+l, eb 0
    l >= 8:  eb = floor(log2 l) - 2, code = 257 + 4*(eb+1) + ((l>>eb)&3),
             extra = l & ((1<<eb)-1)
    L == 258: code 285, eb 0 (special-cased by RFC)

  distance D in [1,32768], v = D-1:
    v < 4:   code v, eb 0
    v >= 4:  eb = floor(log2 v) - 1, code = 2*(eb+1) + ((v>>eb)&1),
             extra = v & ((1<<eb)-1)

floor(log2 x) comes from the float32 exponent (exact for x < 2^24).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def floor_log2(x: jnp.ndarray) -> jnp.ndarray:
    """floor(log2(x)) for int32 x >= 1 via the float32 exponent."""
    f = x.astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(f, jnp.int32)
    return (bits >> 23) - 127


def length_code(mlen: jnp.ndarray):
    """mlen int32 (>=3 where used) -> (code, extra_bits, extra_val)."""
    l = jnp.maximum(mlen - 3, 0)
    small = l < 8
    lg = floor_log2(jnp.maximum(l, 1))
    eb = jnp.where(small, 0, lg - 2)
    code = jnp.where(small, 257 + l,
                     257 + 4 * (eb + 1) + ((l >> jnp.maximum(eb, 0)) & 3))
    ev = jnp.where(small, 0, l & ((1 << jnp.maximum(eb, 0)) - 1))
    is258 = mlen == 258
    code = jnp.where(is258, 285, code)
    eb = jnp.where(is258, 0, eb)
    ev = jnp.where(is258, 0, ev)
    return code, eb, ev


def dist_code(mdist: jnp.ndarray):
    """mdist int32 (>=1 where used) -> (code, extra_bits, extra_val)."""
    v = jnp.maximum(mdist - 1, 0)
    small = v < 4
    lg = floor_log2(jnp.maximum(v, 1))
    eb = jnp.where(small, 0, lg - 1)
    code = jnp.where(small, v,
                     2 * (eb + 1) + ((v >> jnp.maximum(eb, 0)) & 1))
    ev = jnp.where(small, 0, v & ((1 << jnp.maximum(eb, 0)) - 1))
    return code, eb, ev


def onehot_lookup(indices: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """table[indices] as a one-hot matmul (indices [..., n], table [k, c]).

    Exact for table values < 2^24.  Returns [..., n, c] float32.
    """
    k = table.shape[0]
    oh = (indices[..., None] == jnp.arange(k)[None, :]).astype(jnp.float32)
    return jnp.einsum("...nk,kc->...nc", oh, table.astype(jnp.float32),
                      preferred_element_type=jnp.float32)


def onehot_lookup1(indices: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """table[indices] for a 1-D integer table via one-hot matmul.

    Exact for table values < 2^24.  Returns int32 with indices' shape.
    """
    k = table.shape[0]
    oh = (indices[..., None] == jnp.arange(k)).astype(jnp.float32)
    vals = jnp.einsum("...k,k->...", oh, table.astype(jnp.float32),
                      preferred_element_type=jnp.float32)
    return vals.astype(jnp.int32)


def onehot_histogram(indices: jnp.ndarray, weights: jnp.ndarray,
                     k: int) -> jnp.ndarray:
    """Histogram of ``indices`` with integer weights as a matmul.

    indices/weights [n]; returns int32 [k].  Exact for totals < 2^24.
    """
    oh = (indices[:, None] == jnp.arange(k)[None, :]).astype(jnp.float32)
    counts = jnp.einsum("nk,n->k", oh, weights.astype(jnp.float32),
                        preferred_element_type=jnp.float32)
    return counts.astype(jnp.int32)
