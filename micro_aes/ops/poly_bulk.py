"""Bulk Poly1305: the serial Horner fold reformulated as int8 matrix products.

Same shape as ops/ghash_bulk, but over the integers mod p = 2^130-5
instead of GF(2^128) — parity with the reference's 17-byte-limb
schoolbook arithmetic (micro_aes.c:1901-1997), redesigned for an
accelerator:

  * field elements live in FIFTEEN 9-BIT LIMBS (values < 2^135 in
    redundant form).  Multiplication by a FIXED power of r is linear
    over Z, so chunk_i * r^k is a matrix-vector product whose matrix
    columns are limbs(2^(9*li) * r^k mod p) — all entries < 2^9;
  * LAYOUT IS LIMB-MAJOR: the chunk axis is the LAST (lane) axis
    everywhere — limbs [15, N], fold operands [480, T], fold outputs
    [15, T].  (The v1 design used [N, 15] rows, whose minor dim of 15
    made every elementwise/normalize step work on a narrow axis.)
  * each level folds the array STRIDED, not in adjacent runs: an array
    a[0..M) with invariant F = sum_t a[t] r^(M-t) splits as
    t = j*(M/32) + t', so column t' folds {a[t'], a[M/32+t'], ...} —
    32 strided elements.  The payoff: the [480, T] matmul operand with
    row li*32+j = limb li of element j*T+t is a PURE RESHAPE of the
    [15, M] limb array — zero data movement between levels (the
    adjacent-run scheme needs a [15,T,32]->[32,15,T] transpose per
    level).  The residual invariant after each fold keeps the same
    form with M -> M/32, so levels stack until M = 1; the final level
    bakes in the trailing r (exponents 32-j).  Exponents now depend on
    the (static) level sizes, so tables are per-(r, padded-length) —
    a handful of host pow()s, lru-cached;
  * each level is Wt [15, 32*15] @ X [32*15, T].  Operands split into
    two int8 digits (lo 7 bits / hi 2 bits), so the fold is FOUR int8
    matmuls with exact int32 accumulation (bound: 480 * 511 * 511
    < 2^27 — no overflow);
  * between levels the redundant limbs renormalize to 9 bits with the
    2^135 = 160 (mod p) wraparound — a 15-step carry chain over [T]
    lane rows; the final canonical reduction happens host-side on 15
    small ints.

The fold convention matches modes/poly1305.py (micro_aes.c:1976-1986):
F = sum_i c_i * r^(N-i) over chunks c_0..c_{N-1}, each c = chunk||0x01
little-endian.  Zero chunks contribute nothing and front-padding an
array only shifts M together with t, so fronts pad freely to
32-boundaries — exactly the GHASH tiling trick.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

P1305 = (1 << 130) - 5
LIMBS = 15          # 9-bit limbs: 135 bits of redundant headroom
LIMB_BITS = 9
LIMB_MASK = (1 << LIMB_BITS) - 1
FAN = 32            # strided groups folded per level
WRAP135 = 160       # 2^135 mod p  (2^130 = 5 -> 2^135 = 32*5)


def _to_limbs(x: int) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(LIMBS)]


def _level_sizes(n: int) -> list[tuple[int, int]]:
    """[(padded M, M/32)] per level for a fold starting at n elements."""
    sizes = []
    m = max(n, 1)
    while m > 1:
        m += (-m) % FAN
        sizes.append((m, m // FAN))
        m //= FAN
    return sizes or [(FAN, 1)]


from ..utils.keycache import key_cache


@key_cache(maxsize=256)
def poly_power_tables(r: int, n: int):
    """Per-(r, chunk-count) precompute: one (Wtlo, Wthi) pair of int8
    digit matrices [LIMBS, FAN*LIMBS] per fold level.  Level with input
    size M (padded) and stride T = M/32 folds element j*T+t with
    coefficient r^(T*(31-j)) (plus the trailing r on the last level:
    exponents 32-j), preserving the invariant F = sum_t out[t] r^(T-t).
    Row c = li*FAN + j matches the reshape-only operand layout."""
    tables = []
    base = r % P1305
    sizes = _level_sizes(n)
    for lvl, (_, t) in enumerate(sizes):
        last = lvl == len(sizes) - 1
        w = np.zeros((FAN * LIMBS, LIMBS), np.int32)
        for j in range(FAN):
            e = t * (FAN - 1 - j) + (1 if last else 0)
            g = pow(base, e, P1305)
            for li in range(LIMBS):
                prod = ((1 << (LIMB_BITS * li)) * g) % P1305
                w[li * FAN + j] = _to_limbs(prod)
        wt = w.T  # [LIMBS, FAN*LIMBS]
        tables.append((jnp.asarray((wt & 127).astype(np.int8)),
                       jnp.asarray((wt >> 7).astype(np.int8))))
    return tuple(tables)


def _digit_matmul_t(xlo, xhi, wtlo, wthi):
    """Exact int32 product, transposed form: Wt [15, 480] @ X [480, T]
    -> [15, T], as four int8 matmuls."""
    def mm(a, b):
        return jax.lax.dot_general(
            a, b, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)

    return (mm(wtlo, xlo) + 128 * (mm(wtlo, xhi) + mm(wthi, xlo))
            + 16384 * mm(wthi, xhi))


def _normalize(y):
    """Redundant [LIMBS, T] int32 -> 9-bit limbs, same value mod p.
    Two full carry chains with the 2^135 wraparound, then a final short
    wrap (bounds: level outputs < 2^27 per limb; after pass 1 the
    overflow carry < 2^18, after pass 2 it is 0 or 1).  Every step is a
    full-width op on a [T] lane row."""
    for _ in range(2):
        c = jnp.zeros_like(y[0])
        rows = []
        for k in range(LIMBS):
            t = y[k] + c
            rows.append(t & LIMB_MASK)
            c = t >> LIMB_BITS
        y = jnp.stack(rows, axis=0)
        y = y.at[0].add(c * WRAP135)
    # after two passes only limb 0 can exceed 9 bits, by < 2^14: one
    # short ripple is enough (it cannot overflow limb 1's headroom)
    c = y[0] >> LIMB_BITS
    y = y.at[0].set(y[0] & LIMB_MASK)
    y = y.at[1].add(c)
    return y


def _digits(x):
    """int32 9-bit limb array -> (lo, hi) int8 digit planes, same shape."""
    return (x & 127).astype(jnp.int8), (x >> 7).astype(jnp.int8)


def chunk_limbs_from_words(words, pad_mask):
    """LE words uint32[4, N] (word k of chunk n at [k, n]) -> normalized
    limb rows int32[LIMBS, N] of c_n = chunk || pad, where pad_mask[n]
    (0/1 int32) adds the 2^128 pad bit (bit 2 of limb 14) for the chunks
    it marks.  All shifts are vectorized over the chunk (lane) axis."""
    w = [words[k].astype(jnp.uint32) for k in range(4)]
    rows = []
    for li in range(LIMBS):
        bit0 = LIMB_BITS * li
        k0, s = bit0 // 32, bit0 % 32
        if k0 >= 4:
            v = jnp.zeros_like(w[0])
        else:
            v = w[k0] >> s
            if s > 32 - LIMB_BITS and k0 + 1 < 4:
                v = v | (w[k0 + 1] << (32 - s))
        rows.append((v & LIMB_MASK).astype(jnp.int32))
    limbs = jnp.stack(rows, axis=0)  # [15, N]
    return limbs.at[14].add(pad_mask.astype(jnp.int32) << 2)


@functools.partial(jax.jit, static_argnames=())
def poly_fold_jnp(tables, words, pad_mask):
    """Device fold F = sum_i c_i r^(N-i) over N chunks given as LE words
    uint32[4, N] (N a multiple of 32; front-pad with zero words and
    pad_mask zeros; tables = poly_power_tables(r, N)).  Returns the
    normalized limb row int32[LIMBS]."""
    rows = chunk_limbs_from_words(words, pad_mask)  # [15, N]
    for wtlo, wthi in tables:
        pad = (-rows.shape[1]) % FAN
        if pad:
            rows = jnp.pad(rows, ((0, 0), (pad, 0)))
        t = rows.shape[1] // FAN
        # strided operand: row li*32+j of column t' = limbs[li, j*t+t']
        # — a pure reshape of the [15, M] limb array (see module doc)
        xlo, xhi = _digits(rows.reshape(FAN * LIMBS, t))
        rows = _normalize(_digit_matmul_t(xlo, xhi, wtlo, wthi))
    return rows[:, 0]


def limbs_to_int(limbs) -> int:
    """Host: normalized limb row -> canonical integer mod p."""
    v = 0
    for i, x in enumerate(np.asarray(limbs).tolist()):
        v += int(x) << (LIMB_BITS * i)
    return v % P1305
