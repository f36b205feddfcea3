"""Device checksum kernels: CRC32 and Adler32 over block batches.

The reference's ASIC returns the chunk checksum with every completed
request (outputChecksum, src/qatzip.c:1699-1718), so the host never
re-scans the data.  The device analog: CRC32 is GF(2)-linear in the message
bits, so a batch of blocks reduces with a log-depth combine tree built
from constant 32x32 bit matrices ("advance register by 2^k zero bytes"),
with per-word leaf CRCs as 32 elementwise select-XORs — no gathers, no
scatters, no tables on device.  Adler32 is two modular sums.

Variable block lengths: blocks are RIGHT-aligned (shifted so padding
becomes leading zeros) before the tree — a zero prefix leaves the raw
register at 0, so leading zeros never affect crc0.  The init/final-xor
convention is then restored per block with a conditional ladder of the
same zero-advance matrices.

Verified bit-exact vs zlib.crc32/adler32 (tests/test_device_checksums.py).
"""
from __future__ import annotations

import functools

import numpy as np

_POLY = 0xEDB88320


@functools.lru_cache(maxsize=1)
def _host_tables() -> dict:
    """Constant GF(2) operators, built once on host.

    cols_word[b]  : crc0 of the 4-byte message with only bit b set
    zadv[k][b]    : column b of the "advance by 2^k zero bytes" matrix
    """
    # advance-one-zero-byte columns
    def adv1(c: int) -> int:
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        return c

    z1 = [adv1(1 << b) for b in range(32)]

    def mat_apply(cols, v):
        acc = 0
        for b in range(32):
            if (v >> b) & 1:
                acc ^= cols[b]
        return acc

    def mat_sq(cols):
        return [mat_apply(cols, cols[b]) for b in range(32)]

    zadv = [z1]
    for _ in range(24):  # up to 2^24-byte advances
        zadv.append(mat_sq(zadv[-1]))

    # leaf: crc0 (raw reflected register, init 0) of one 4-byte LE word
    # with a single bit set = advance that bit's register image... compute
    # directly: feeding word w as 4 bytes from register 0 equals advancing
    # register rev-image; simplest is the linear build from the byte model.
    def crc0_word(w: int) -> int:
        c = 0
        for i in range(4):
            byte = (w >> (8 * i)) & 0xFF
            c = c ^ byte
            for _ in range(8):
                c = (c >> 1) ^ (_POLY if c & 1 else 0)
        return c

    cols_word = [crc0_word(1 << b) for b in range(32)]
    return {
        "cols_word": np.array(cols_word, np.uint32),
        "zadv": np.array([np.array(m, np.uint32) for m in zadv]),
    }


def _mat_apply_jnp(cols, v):
    """Apply a GF(2) 32x32 matrix (given as 32 uint32 columns) to every
    element of v: acc = XOR of cols[b] where bit b of v is set."""
    import jax.numpy as jnp

    acc = jnp.zeros_like(v)
    for b in range(32):
        bit = (v >> jnp.uint32(b)) & jnp.uint32(1)
        acc = acc ^ (bit * jnp.uint32(int(cols[b])))
    return acc


@functools.partial(
    __import__("jax").jit, static_argnames=("n",))
def crc32_blocks(data, lengths, n: int):
    """crc32 (zlib convention) of data[b, :lengths[b]] for each block.

    data: uint8[B, >=n]; lengths: int32[B].  Elementwise + reductions only.
    """
    import jax.numpy as jnp

    t = _host_tables()
    B = data.shape[0]
    d = data[:, :n].astype(jnp.uint32)
    L = lengths[:, None]
    pos = jnp.arange(n, dtype=jnp.int32)[None, :]

    # right-align: byte i of block moves to position i + (n - len)
    shift = (n - lengths)[:, None]
    src = pos - shift
    from qatzip_tpu.ops.deflate_encode import _take

    aligned = jnp.where(src >= 0, _take(d, jnp.clip(src, 0, n - 1)), 0)

    # leaf CRCs of 4-byte LE words
    w = aligned.reshape(B, n // 4, 4)
    word = (w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16)
            | (w[..., 3] << 24))
    c = _mat_apply_jnp(t["cols_word"], word)  # [B, n//4]

    # combine tree: crc(left||right) = Zlen(right)(crc_left) ^ crc_right
    level = 2  # right segment is 2^level bytes at the first fold
    while c.shape[1] > 1:
        left = c[:, 0::2]
        right = c[:, 1::2]
        c = _mat_apply_jnp(t["zadv"][level], left) ^ right
        level += 1

    crc0 = c[:, 0]  # raw register with init 0 for the real bytes
    # init 0xFFFFFFFF advanced over len(data) zero bytes, xor'd in by
    # linearity, then the standard final complement
    init = jnp.full((B,), 0xFFFFFFFF, jnp.uint32)
    ln = lengths
    for k in range(25):
        bit = (ln >> k) & 1
        adv = _mat_apply_jnp(t["zadv"][k], init)
        init = jnp.where(bit == 1, adv, init)
    return (crc0 ^ init ^ jnp.uint32(0xFFFFFFFF)).astype(jnp.uint32)


@functools.partial(
    __import__("jax").jit, static_argnames=("n",))
def adler32_blocks(data, lengths, n: int):
    """adler32 (zlib convention) of data[b, :lengths[b]] per block."""
    import jax.numpy as jnp

    MOD = jnp.uint32(65521)
    d = data[:, :n].astype(jnp.uint32)
    pos = jnp.arange(n, dtype=jnp.int32)[None, :]
    L = lengths[:, None]
    valid = pos < L
    dv = jnp.where(valid, d, 0)

    # A = 1 + sum(d) mod m ; B = len + sum((len-i)*d_i) mod m
    # partial sums over 256-wide groups keep products inside uint32
    wts = jnp.where(valid, (L - pos).astype(jnp.uint32) % MOD, 0)
    prod = dv * wts                       # <= 255 * 65520 per element
    # uint32-safe grouping: 128 * 255 * 65520 = 2.14e9 < 2^32; mod-reduce
    # each group, then sum the per-group residues
    g = prod.reshape(d.shape[0], n // 128, 128)
    part = g.sum(axis=-1) % MOD           # [B, n//128]
    sB = part.sum(axis=-1) % MOD
    sA = dv.reshape(d.shape[0], n // 128, 128).sum(axis=-1) % MOD
    sA = sA.sum(axis=-1) % MOD
    A = (sA + 1) % MOD
    Bv = (sB + lengths.astype(jnp.uint32)) % MOD
    return ((Bv << 16) | A).astype(jnp.uint32)
