"""GF(2^128) algebra: doubling, halving, and the two multiply conventions.

The reference implements four scalar bit-serial routines
(micro_aes.c:434-528): `doubleBblock`/`doubleLblock` (big/little-endian
doubling), `mulGF128` (GHASH convention) and `dotGF128` (POLYVAL
convention).  Here every routine is vectorized over a batch axis, and —
the key idea — a multiplication by a *fixed* operand H is a
GF(2)-linear map of the 128 input bits, so we materialize it once per key
as a 128×128 bit-matrix `M_H` by probing the bit-serial oracle with unit
vectors.  Applying the map is then an integer matmul + parity, which rides
the matrix units; H^k chains become matrix powers (see ops/mac.py for the
powers-of-H parallel tag reduction).

Bit order convention: bit index 8*i + j of a block is (byte_i >> (7-j)) & 1
(big-endian within bytes).  All conversions go through blocks_to_bits /
bits_to_blocks, so the convention is internally consistent by construction.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# numpy constant (not a device array): embedded at lowering, never fetched.
_BIT_SHIFTS = np.arange(7, -1, -1, dtype=np.uint8)  # MSB first


def blocks_to_bits(blocks: jax.Array) -> jax.Array:
    """uint8[..., 16] -> uint8[..., 128] of 0/1 bits, MSB-first per byte."""
    b = (blocks[..., :, None] >> _BIT_SHIFTS) & 1
    return b.reshape(blocks.shape[:-1] + (128,))


def bits_to_blocks(bits: jax.Array) -> jax.Array:
    """uint8[..., 128] of 0/1 -> uint8[..., 16]."""
    b = bits.reshape(bits.shape[:-1] + (16, 8)).astype(jnp.uint8)
    return jnp.sum(b << _BIT_SHIFTS, axis=-1).astype(jnp.uint8)


def double_be(x: jax.Array) -> jax.Array:
    """Big-endian GF(2^128) doubling (micro_aes.c:434-443): the 128-bit BE
    number shifts left one bit; on carry, last byte ^= 0x87."""
    carry_in = jnp.concatenate(
        [x[..., 1:] >> 7, jnp.zeros_like(x[..., :1])], axis=-1
    )
    y = ((x << 1) & 0xFF).astype(jnp.uint8) | carry_in.astype(jnp.uint8)
    msb_out = (x[..., 0] >> 7).astype(jnp.uint8)
    return y.at[..., 15].set(y[..., 15] ^ msb_out * 0x87)


def double_le(x: jax.Array) -> jax.Array:
    """Little-endian doubling (micro_aes.c:449-458); used by XTS and EAX'."""
    carry_in = jnp.concatenate(
        [jnp.zeros_like(x[..., :1]), x[..., :-1] >> 7], axis=-1
    )
    y = ((x << 1) & 0xFF).astype(jnp.uint8) | carry_in.astype(jnp.uint8)
    msb_out = (x[..., 15] >> 7).astype(jnp.uint8)
    return y.at[..., 0].set(y[..., 0] ^ msb_out * 0x87)


def halve_be(x: jax.Array) -> jax.Array:
    """divideBblock (micro_aes.c:464-473): BE shift right; if the dropped
    LSB was set, first byte ^= 0xE1."""
    carry_in = jnp.concatenate(
        [jnp.zeros_like(x[..., :1]), (x[..., :-1] & 1) << 7], axis=-1
    )
    y = (x >> 1).astype(jnp.uint8) | carry_in.astype(jnp.uint8)
    lsb_out = (x[..., 15] & 1).astype(jnp.uint8)
    return y.at[..., 0].set(y[..., 0] ^ lsb_out * 0xE1)


def halve_le(x: jax.Array) -> jax.Array:
    """divideLblock (micro_aes.c:499-507): reversed-byte variant."""
    carry_in = jnp.concatenate(
        [(x[..., 1:] & 1) << 7, jnp.zeros_like(x[..., :1])], axis=-1
    )
    y = (x >> 1).astype(jnp.uint8) | carry_in.astype(jnp.uint8)
    lsb_out = (x[..., 0] & 1).astype(jnp.uint8)
    return y.at[..., 15].set(y[..., 15] ^ lsb_out * 0xE1)


def mul_gf128(x: jax.Array, y: jax.Array) -> jax.Array:
    """GHASH-convention product (micro_aes.c:476-493). Bit-serial, 128
    steps; `x` may be a single block [16] or batched [..., 16] matching
    the leading axes of `y`."""
    xbits = blocks_to_bits(x)  # [..., 128]

    def step(i, carry):
        acc, yy = carry
        bit = jnp.expand_dims(xbits[..., i], -1)
        acc = acc ^ (yy * bit)
        return acc, halve_be(yy)

    acc0 = jnp.zeros_like(y)
    acc, _ = jax.lax.fori_loop(0, 128, lambda i, c: step(i, c), (acc0, y))
    return acc


def dot_gf128(x: jax.Array, y: jax.Array) -> jax.Array:
    """POLYVAL-convention product (micro_aes.c:511-527); `x` single or
    batched like mul_gf128.

    Iterates bits of x from byte 15 downward, halving before the
    conditional add — mirrored order relative to mul_gf128."""
    xb = blocks_to_bits(x)
    xb = xb.reshape(xb.shape[:-1] + (16, 8))[..., ::-1, :]
    xb = xb.reshape(xb.shape[:-2] + (128,))  # byte 15 first

    def step(i, carry):
        acc, yy = carry
        yy = halve_le(yy)
        acc = acc ^ (yy * jnp.expand_dims(xb[..., i], -1))
        return acc, yy

    acc0 = jnp.zeros_like(y)
    acc, _ = jax.lax.fori_loop(0, 128, lambda i, c: step(i, c), (acc0, y))
    return acc


# ---------------------------------------------------------------------------
# Fixed-operand multiplication as a GF(2) bit-matrix (the matmul form)
# ---------------------------------------------------------------------------

def _probe_linear_map(apply_fn, h_block: jax.Array) -> jax.Array:
    """Build the 128×128 GF(2) matrix of y -> apply_fn(h, y) by feeding the
    128 unit bit-vectors through the bit-serial oracle.  Column j of the
    result is apply_fn(h, e_j) so that  bits(out) = M @ bits(in)  (mod 2)."""
    eye = jnp.eye(128, dtype=jnp.uint8)
    unit_blocks = bits_to_blocks(eye)  # [128, 16]
    cols = apply_fn(h_block, unit_blocks)  # [128, 16]
    return blocks_to_bits(cols).T.astype(jnp.uint8)  # [128 out, 128 in]


# Host (numpy) probes: the matrices are tiny (128x128 bits) and the
# bit-serial oracles take microseconds in numpy — never pay device
# dispatch/compile for per-key setup.

def _bits_np(blocks):
    b = (np.asarray(blocks, np.uint8)[..., :, None] >> np.arange(7, -1, -1)) & 1
    return b.reshape(np.asarray(blocks).shape[:-1] + (128,))


def _halve_be_np(x):
    y = (x >> 1).astype(np.uint8)
    y[..., 1:] |= (x[..., :-1] & 1) << 7
    y[..., 0] ^= (x[..., 15] & 1) * 0xE1
    return y


def _halve_le_np(x):
    y = (x >> 1).astype(np.uint8)
    y[..., :-1] |= (x[..., 1:] & 1) << 7
    y[..., 15] ^= (x[..., 0] & 1) * 0xE1
    return y


def ghash_matrix(h_block) -> np.ndarray:
    """M (numpy uint8[128,128]) with bits(mulGF128(H, y)) = M @ bits(y)."""
    h = np.asarray(h_block, np.uint8)
    hbits = _bits_np(h)
    eye = np.eye(128, dtype=np.uint8)
    y = eye.reshape(128, 16, 8)  # unit bit-vectors as blocks
    y = np.packbits(y, axis=-1, bitorder="big").reshape(128, 16)
    acc = np.zeros((128, 16), np.uint8)
    for i in range(128):
        if hbits[i]:
            acc ^= y
        y = _halve_be_np(y)
    return _bits_np(acc).T.astype(np.uint8)


def polyval_matrix(h_block) -> np.ndarray:
    """M (numpy uint8[128,128]) with bits(dotGF128(H, y)) = M @ bits(y)."""
    h = np.asarray(h_block, np.uint8)
    hb = _bits_np(h).reshape(16, 8)[::-1].reshape(128)  # byte 15 first
    eye = np.eye(128, dtype=np.uint8)
    y = np.packbits(eye.reshape(128, 16, 8), axis=-1,
                    bitorder="big").reshape(128, 16)
    acc = np.zeros((128, 16), np.uint8)
    for i in range(128):
        y = _halve_le_np(y)
        if hb[i]:
            acc ^= y
    return _bits_np(acc).T.astype(np.uint8)


def mat_apply_bits(m: jax.Array, bits: jax.Array) -> jax.Array:
    """Apply a GF(2) matrix to bit vectors: [..., 128] @ M^T mod 2.

    Integer matmul keeps exact sums (≤ 128) then reduces mod 2."""
    acc = jax.lax.dot_general(
        bits.astype(jnp.int32),
        m.astype(jnp.int32),
        dimension_numbers=(((bits.ndim - 1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (acc & 1).astype(jnp.uint8)


def mat_mul_gf2(a: jax.Array, b: jax.Array) -> jax.Array:
    """(A @ B) mod 2 for GF(2) matrices — used for powers of M_H."""
    acc = jnp.dot(a.astype(jnp.int32), b.astype(jnp.int32),
                  preferred_element_type=jnp.int32)
    return (acc & 1).astype(jnp.uint8)


def mat_power_gf2_np(m, k: int) -> np.ndarray:
    """M^k over GF(2) in numpy (host; square-and-multiply)."""
    result = np.eye(128, dtype=np.int64)
    base = np.asarray(m, np.uint8).astype(np.int64)
    while k:
        if k & 1:
            result = (result @ base) % 2
        k >>= 1
        if k:
            base = (base @ base) % 2
    return result.astype(np.uint8)


def gf2_matinv_np(m) -> np.ndarray:
    """Inverse of a GF(2) matrix (numpy Gaussian elimination, any size)."""
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    a = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r, col])
        a[[col, piv]] = a[[piv, col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= a[col]
    return a[:, n:]


def mat_power_gf2(m: jax.Array, k: int) -> jax.Array:
    """M^k over GF(2) by square-and-multiply (k static)."""
    result = jnp.eye(128, dtype=jnp.uint8)
    base = m
    while k:
        if k & 1:
            result = mat_mul_gf2(result, base)
        k >>= 1
        if k:
            base = mat_mul_gf2(base, base)
    return result


def pow_gf128(h: jax.Array, e: jax.Array, bits: int = 28) -> jax.Array:
    """h^e in the GHASH field by batched square-and-multiply: h
    uint8[B,16], e int32[B] (or scalar), 0 <= e < 2^bits.  h^0 is the
    field identity (the block for polynomial 1: 0x80 00..00 in the
    GHASH bit order).  Used by the segmented multi-key chain engine to
    scale the AAD fold by H^n_blocks (modes/seal_batch)."""
    one = jnp.zeros_like(h).at[..., 0].set(jnp.uint8(0x80))
    e = jnp.broadcast_to(jnp.asarray(e, jnp.int32), h.shape[:-1])

    def step(t, carry):
        acc, hp = carry
        bit = ((e >> t) & 1).astype(jnp.uint8)[..., None]
        acc = jnp.where(bit == 1, mul_gf128(acc, hp), acc)
        return acc, mul_gf128(hp, hp)

    acc, _ = jax.lax.fori_loop(0, bits, step, (one, h))
    return acc
