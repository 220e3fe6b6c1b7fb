"""Bulk GHASH: the serial Horner fold reformulated as int8 matrix products.

GHASH over n blocks is G = sum_i M_H^(n-i+1) c_i (M_H = the per-key GF(2)
bit-matrix, ops/gf128.ghash_matrix).  Decomposition:

  level 1:  chunks of C=32 blocks (one bitslice word) -> one batched
            [T, 4096] @ [4096, 128] int8 matmul (exact int32 accumulate)
  level 2:  groups of C2 chunks -> same trick with powers of M^32
  combine:  log-depth pairwise fold (span matrix squares each level)

The level-1 weights can be row-permuted so the matmul consumes bit-plane
order directly (ghash_bulk_planes) — ciphertext never has to leave the
bitsliced domain.  Leading zero blocks contribute nothing (exponents
count from the end), so fronts pad freely to tile boundaries.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .gf128 import bits_to_blocks, blocks_to_bits

CHUNK = 32     # blocks per level-1 chunk == bits per bitslice word
CHUNK2 = 32    # chunks per level-2 group

# rows of W1 arrive as (j, b, p): lane j, bit b, byte p; standard GHASH
# bit order within a block is q = 8p + (7-b)  (MSB-first per byte).
_PLANE_PERM = np.concatenate([
    j * 128 + np.array([8 * p + (7 - b) for b in range(8) for p in range(16)])
    for j in range(CHUNK)
])


SPAN_LEVELS = 2     # extra 32-way matmul combine levels (3 and 4)
SPAN_FAN = 32       # rows folded per extra level


def ghash_power_tables(m_h, chunk: int = CHUNK, chunk2: int = CHUNK2,
                       plane_order: bool = False):
    """Per-key precompute: (W1 [C*128,128], W2 [C2*128,128], M_outer, M_H,
    spans) as int8 device arrays.  W1 row-block j holds (M^(C-j))^T so
    S = c_flat @ W1.  `spans` holds SPAN_LEVELS further (W, M_next) pairs
    that fold 32 rows per matmul — they turn the tail combine into a
    couple of int8 contractions instead of a serial log-depth ladder
    (up to chunk*chunk2*32^2 blocks collapse to one row).  Built entirely
    in numpy on the host (the matrices are tiny; device dispatch/compile
    would dominate per-key setup)."""
    m = np.asarray(m_h, np.uint8).astype(np.int64)

    def mm(a, b):
        return (a @ b) % 2

    pows = [m]
    for _ in range(chunk - 1):
        pows.append(mm(m, pows[-1]))
    w1 = np.concatenate([pows[chunk - 1 - j].T for j in range(chunk)], axis=0)
    if plane_order:
        assert chunk == CHUNK
        w1 = w1[_PLANE_PERM]
    m_c = pows[chunk - 1]  # M^C
    pows2 = [np.eye(128, dtype=np.int64), m_c]
    for _ in range(chunk2 - 2):
        pows2.append(mm(m_c, pows2[-1]))
    w2 = np.concatenate([pows2[chunk2 - 1 - j].T for j in range(chunk2)], axis=0)
    m_outer = mm(m_c, pows2[chunk2 - 1])  # M^(C*C2)

    spans = []
    m_cur = m_outer
    for _ in range(SPAN_LEVELS):
        pws = [np.eye(128, dtype=np.int64), m_cur]
        for _ in range(SPAN_FAN - 2):
            pws.append(mm(m_cur, pws[-1]))
        wsp = np.concatenate(
            [pws[SPAN_FAN - 1 - j].T for j in range(SPAN_FAN)], axis=0)
        m_next = mm(m_cur, pws[SPAN_FAN - 1])
        spans.append((jnp.asarray(wsp.astype(np.int8)),
                      jnp.asarray(m_next.astype(np.int8))))
        m_cur = m_next

    return (jnp.asarray(w1.astype(np.int8)), jnp.asarray(w2.astype(np.int8)),
            jnp.asarray(m_outer.astype(np.int8)),
            jnp.asarray(np.asarray(m_h, np.uint8)),
            tuple(spans))


def _gf2_matmul_i8(x, w):
    """(x @ w) mod 2 with int8 operands (int32 accumulate).  No float
    product is involved, so TF32 cannot arise."""
    acc = jax.lax.dot_general(
        x, w, dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    return acc & 1


def _combine_logdepth(u, m_outer):
    """G = sum_g M^(S*(T2-1-g)) U_g via pairwise folds; log2(T2) matmuls."""
    pow2 = 1
    while pow2 < u.shape[0]:
        pow2 *= 2
    if pow2 != u.shape[0]:  # front-pad: exponents count from the end
        u = jnp.concatenate(
            [jnp.zeros((pow2 - u.shape[0], 128), u.dtype), u], axis=0)
    m_span_t = jnp.transpose(m_outer)
    while u.shape[0] > 1:
        left, right = u[0::2], u[1::2]
        u = (_gf2_matmul_i8(left.astype(jnp.int8), m_span_t) ^ right).astype(jnp.int8)
        if u.shape[0] > 1:
            m_span_t = _gf2_matmul_i8(
                m_span_t.astype(jnp.int8), m_span_t).astype(jnp.int8)
    return u[0].astype(jnp.uint8)


def combine_levels(u, tables):
    """Fold row partials u int8 [T, 128] (exponents count from the row-
    stream end; front-pad freely) into one accumulator uint8[128]: one
    32-way matmul per span level, then a log-depth ladder for whatever
    tail remains (empty for messages up to chunk*chunk2*32^2 blocks)."""
    m_outer = tables[2]
    spans = tables[4] if len(tables) > 4 else ()
    m_cur = m_outer
    for wsp, m_next in spans:
        if u.shape[0] == 1:
            break
        pad = (-u.shape[0]) % SPAN_FAN
        if pad:
            u = jnp.concatenate(
                [jnp.zeros((pad, 128), u.dtype), u], axis=0)
        u = _gf2_matmul_i8(
            u.reshape(u.shape[0] // SPAN_FAN, SPAN_FAN * 128), wsp
        ).astype(jnp.int8)
        m_cur = m_next
    return _combine_logdepth(u.astype(jnp.int8), m_cur)


def _levels(bits_flat, tables):
    """bits_flat [T, C*128] int8 -> folded accumulator uint8[128]."""
    w1, w2 = tables[0], tables[1]
    chunk2 = w2.shape[0] // 128
    t = bits_flat.shape[0]
    s1 = _gf2_matmul_i8(bits_flat, w1)  # [T,128] int32 0/1
    t2 = t // chunk2
    s2 = _gf2_matmul_i8(s1.astype(jnp.int8).reshape(t2, chunk2 * 128), w2)
    return combine_levels(s2.astype(jnp.int8), tables)


def ghash_bulk(tables, ct_blocks: jax.Array, init_bits=None) -> jax.Array:
    """GHASH accumulator after folding ct_blocks [N,16]; N must be a
    multiple of chunk*chunk2.  Returns bit-vector uint8[128] (state
    *before* the final length-block fold)."""
    w1, w2 = tables[0], tables[1]
    chunk = w1.shape[0] // 128
    chunk2 = w2.shape[0] // 128
    n = ct_blocks.shape[0]
    assert n % (chunk * chunk2) == 0
    bits = blocks_to_bits(ct_blocks).astype(jnp.int8)  # [N,128]
    if init_bits is not None:
        # fold init into the first block: M^n(init ^ c_0) distributes
        bits = bits.at[0].set(bits[0] ^ init_bits.astype(jnp.int8))
    return _levels(bits.reshape(n // chunk, chunk * 128), tables)


def planes_to_bits_i8(planes: jax.Array) -> jax.Array:
    """uint32[8,16,W] -> int8[32*W, 128] per-block bit rows in *plane
    order* (b, p); slice/pad the block axis freely, then feed
    ghash_from_bits (whose tables must use plane_order=True)."""
    w = planes.shape[-1]
    lanes = np.arange(32, dtype=np.uint32)
    bits = ((planes[:, :, :, None] >> lanes) & 1).astype(jnp.int8)  # [8,16,W,32]
    return bits.transpose(2, 3, 0, 1).reshape(32 * w, 128)


def ghash_from_bits(tables, bits: jax.Array) -> jax.Array:
    """Fold per-block bit rows [N, 128] (N multiple of chunk*chunk2).
    Bit order must match the tables (plane_order or standard)."""
    w1 = tables[0]
    chunk = w1.shape[0] // 128
    n = bits.shape[0]
    return _levels(bits.reshape(n // chunk, chunk * 128), tables)


def ghash_finalize(tables, acc_bits: jax.Array, len_block: jax.Array) -> jax.Array:
    """One more fold with the length block: G = M(acc ^ bits(len))."""
    m_h = tables[3]
    x = (acc_bits ^ blocks_to_bits(len_block)).astype(jnp.int8)
    mt = jnp.transpose(m_h.astype(jnp.int8))
    g = _gf2_matmul_i8(x, mt).astype(jnp.uint8)
    return bits_to_blocks(g)
