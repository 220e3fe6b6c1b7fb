"""Stream-form bitsliced engines, written in plain `jnp` for XLA.

Every bulk engine works on one layout, the w-major stream
uint32[W, 128]: row w, lane 4j+k holds little-endian word k of block
32w+j.  It is a pure bitcast + reshape of the byte stream, so the host
builds it with one memcpy (modes/seal.host_stream).

Inside, the engines butterfly stream words into bit planes
(core/bitslice: plane [b, pos, w] bit j = bit b of byte pos of block
32w+j), run the bitsliced rounds, and butterfly back:

  * `ctrw_fused_jnp`   — cipher-and-xor with a caller-supplied block stream
    (counter modes with preset counters; XEX bodies of OCB/XTS);
  * `ctr_fused_jnp`    — GCM/CTR keystream from (J0, per-row counters);
  * `seal_fused_jnp`   — the same plus GHASH level 1 of the ciphertext
    (int8 GF(2) matrix product, ops/ghash_bulk);
  * `xex_fused_jnp`, `ocb_fused_jnp` — XTS and OCB bodies with their
    offsets computed from the row base / gray code;
  * `ctrw_fused_multikey_jnp` — B messages under B keys in one program.

On a GPU the counter-mode keystream of the GCM seal/open and of bulk CTR
runs through the hand-written kernel in ops/ctr_kernel.py instead; the
functions here are its reference and the path on every other platform.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.bitslice import (
    decrypt_planes,
    encrypt_planes,
    planes_to_words,
    words_to_planes,
)
from ..ops.counter import _LOW_BIT_PATTERNS


def _stream_to_kwords(x):
    """uint32[W, 128] w-major stream -> [4, 32W] word-major (block order:
    words_flat[k, 32w+j] = x[w, 4j+k])."""
    w = x.shape[0]
    return x.reshape(w, 32, 4).transpose(2, 0, 1).reshape(4, 32 * w)


def _kwords_to_stream(words):
    """Inverse of _stream_to_kwords."""
    n = words.shape[-1]
    w = n // 32
    return words.reshape(4, w, 32).transpose(1, 2, 0).reshape(w, 128)


def stream_bits_i8(x):
    """uint32[W, 128] stream -> int8[32W, 128] per-block bit rows in plane
    order (column b*16 + pos = bit b of byte pos), straight from the
    words: byte pos of a block is byte pos%4 of its word pos//4."""
    n = x.shape[0] * 32
    words = x.reshape(n, 4)
    bits = (words[:, :, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1
    return (bits.reshape(n, 4, 4, 8).transpose(0, 3, 1, 2)
            .reshape(n, 128).astype(jnp.int8))


# row -> counter-plane source map (static): for plane row q = b*16 + pos,
# sel 0 = J0 broadcast bit (pos <= 8), 1 = low-counter fixed lane pattern
# (bit k < 5), 2 = lo-word bit k, 3 = hi-word bit
_CTR_SEL = np.zeros(128, np.int32)
_CTR_SHIFT = np.zeros(128, np.int32)
_CTR_PATTERN = np.zeros(128, np.uint32)
for _q in range(128):
    _b, _pos = _q // 16, _q % 16
    if _pos <= 8:
        _CTR_SEL[_q] = 0
    elif _pos >= 12:
        _k = 8 * (15 - _pos) + _b
        if _k < 5:
            _CTR_SEL[_q] = 1
            _CTR_PATTERN[_q] = _LOW_BIT_PATTERNS[_k]
        else:
            _CTR_SEL[_q] = 2
            _CTR_SHIFT[_q] = _k
    else:
        _CTR_SEL[_q] = 3
        _CTR_SHIFT[_q] = 8 * (11 - _pos) + _b


def _counter_planes_vec(j0c, lohi):
    """Counter planes [128, W] of the 32-aligned GCM/CTR keystream: the
    top 9 byte positions broadcast J0 bits (j0c [128, 1] of 0/~0), the
    low 5 counter bits are fixed lane patterns, bits 5..31 broadcast the
    per-row value lo and bits 32..55 the 24-bit extension hi (the
    reference's 56-bit carry window, micro_aes.c:421-428)."""
    w = lohi.shape[-1]
    ones = jnp.uint32(0xFFFFFFFF)
    lo, hi = lohi[0:1, :], lohi[1:2, :]
    sel = jnp.asarray(_CTR_SEL)[:, None]
    shift = jnp.asarray(_CTR_SHIFT)[:, None]
    from_lo = ((lo >> shift.astype(jnp.uint32)) & 1) * ones
    from_hi = ((hi >> shift.astype(jnp.uint32)) & 1) * ones
    return jnp.where(sel == 0, j0c | jnp.zeros((128, w), jnp.uint32),
                     jnp.where(sel == 1,
                               jnp.broadcast_to(
                                   jnp.asarray(_CTR_PATTERN)[:, None],
                                   (128, w)),
                               jnp.where(sel == 2, from_lo, from_hi)))


def _ghash_level1(bits, ghmask, w1t):
    """Level-1 GHASH/POLYVAL partials from plane-order bit rows
    [32W, 128]: mask invalid stream positions (bit j of ghmask word w set
    == position 32w+j valid) and fold each 32-block chunk with one int8
    product against the plane-ordered table.  Returns int8[128, W]."""
    from .ghash_bulk import _gf2_matmul_i8

    w = ghmask.shape[-1]
    mask = (ghmask[0][:, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1
    bits = bits * mask.reshape(32 * w, 1).astype(jnp.int8)
    s1 = _gf2_matmul_i8(bits.reshape(w, 32 * 128), jnp.transpose(w1t))
    return jnp.transpose(s1).astype(jnp.int8)


@jax.jit
def ghash1_fused_jnp(ghm, w1t, x_words):
    """Level-1 MAC partials of a u32[W, 128] stream: s1 int8[128, W]
    (column w = partial of 32-block chunk w).  ghm uint32[1, W] masks
    valid stream positions; w1t int8[128, 4096] is the transposed
    plane-ordered level-1 table (GHASH or POLYVAL — the convention lives
    entirely in the table)."""
    return _ghash_level1(stream_bits_i8(x_words), ghm, w1t)


@functools.partial(jax.jit, static_argnames=("bits_from_input",))
def seal_fused_jnp(kp_flat, j0_const, lohi, ghmask, w1t, pt_words,
                   bits_from_input: bool = False):
    """GCM seal body: kp_flat uint32[(R+1)*128, 1], j0_const
    uint32[128, 1], lohi uint32[2, W], ghmask uint32[1, W], w1t
    int8[128, 4096] (transposed plane-ordered level-1 GHASH table),
    pt_words uint32[W, 128] -> (out_words uint32[W, 128], s1 int8[128, W])
    where s1[:, w] is the level-1 GHASH partial of 32-block chunk w.
    bits_from_input=True is the open direction (the input is the
    ciphertext)."""
    from .ghash_bulk import planes_to_bits_i8

    rounds = kp_flat.shape[0] // 128 - 1
    w = lohi.shape[-1]
    ctr_planes = _counter_planes_vec(j0_const, lohi).reshape(8, 16, w)
    kp = kp_flat.reshape(rounds + 1, 8, 16)
    ks_planes = encrypt_planes(kp, ctr_planes)

    in_planes = words_to_planes(_stream_to_kwords(pt_words))
    out_planes = in_planes ^ ks_planes
    ct_planes = in_planes if bits_from_input else out_planes

    ctw = _kwords_to_stream(planes_to_words(out_planes))
    return ctw, _ghash_level1(planes_to_bits_i8(ct_planes), ghmask, w1t)


@jax.jit
def ctr_fused_jnp(kp_flat, j0_const, lohi, pt_words):
    """Counter + cipher + xor (no MAC); arguments as seal_fused_jnp."""
    rounds = kp_flat.shape[0] // 128 - 1
    w = lohi.shape[-1]
    ctr_planes = _counter_planes_vec(j0_const, lohi).reshape(8, 16, w)
    kp = kp_flat.reshape(rounds + 1, 8, 16)
    ks = encrypt_planes(kp, ctr_planes)
    in_planes = words_to_planes(_stream_to_kwords(pt_words))
    return _kwords_to_stream(planes_to_words(in_planes ^ ks))


@functools.partial(jax.jit, static_argnames=("decrypt",))
def ctrw_fused_jnp(kp_flat, ctr_words, pt_words, decrypt: bool = False):
    """Cipher-and-xor with a caller-supplied block stream [W, 128]:
    E_K(ctr) ^ pt (D_K when decrypt).  Backs counter modes with preset
    counters and the XEX bodies (blocks = data ^ offsets, xor =
    offsets)."""
    rounds = kp_flat.shape[0] // 128 - 1
    kp = kp_flat.reshape(rounds + 1, 8, 16)
    ctr_planes = words_to_planes(_stream_to_kwords(ctr_words))
    cipher = decrypt_planes if decrypt else encrypt_planes
    ks = cipher(kp, ctr_planes)
    in_planes = words_to_planes(_stream_to_kwords(pt_words))
    return _kwords_to_stream(planes_to_words(in_planes ^ ks))


# ---------------------------------------------------------------------------
# XEX with per-row bases (XTS): offsets tw = base * alpha^jj for the 32
# lanes of a row, from one base block per row (five masked doubling
# stages: lane jj applies alpha^(2^b) when bit b of jj is set).
# ---------------------------------------------------------------------------

_LANE_K = np.arange(128) % 4
_LANE_JJ = np.arange(128) // 4


def _alpha_pow_words(x, m: int):
    """alpha^m (m <= 16) on the block lane groups of a u32[W, 128]
    stream: word-level shift with carry plus the 0x87 reduction taps
    (LE doubling, micro_aes.c:449-458)."""
    sh = jnp.roll(x, 1, axis=1)
    carry = jnp.where(jnp.asarray(_LANE_K == 0)[None, :], jnp.uint32(0),
                      sh >> (32 - m))
    y = (x << m) | carry
    ov = jnp.roll(x >> (32 - m), -3, axis=1)
    red = jnp.zeros_like(x)
    for i in range(m):
        red = red ^ (jnp.uint32(0x87 << i) * ((ov >> i) & 1))
    return y ^ jnp.where(jnp.asarray(_LANE_K == 0)[None, :], red,
                         jnp.uint32(0))


@functools.partial(jax.jit, static_argnames=("decrypt",))
def xex_fused_jnp(kp_flat, base_words, pt_words, decrypt: bool = False):
    """XEX body with per-row bases: base_words u32[W, 128] holds the row's
    base block in every lane group; out = off ^ E_K(in ^ off) (D_K when
    decrypt) with off = base * alpha^jj."""
    x = base_words
    for b in range(5):
        sel = jnp.asarray(((_LANE_JJ >> b) & 1).astype(np.uint32))[None, :]
        x = jnp.where(sel == 1, _alpha_pow_words(x, 1 << b), x)
    return ctrw_fused_jnp(kp_flat, pt_words ^ x, x, decrypt=decrypt)


@functools.partial(jax.jit, static_argnames=("decrypt", "nbits"))
def ocb_fused_jnp(kp_flat, d0l, lbl, pt_words, nbits: int,
                  decrypt: bool = False):
    """OCB body: out = Δ ^ E_K(in ^ Δ) (D_K when decrypt), block index =
    stream position + 1, Δ_i = Δ_0 ^ XOR over set bits b of gray(i) of
    L_b (the gray-code form of the reference's getDelta ladder,
    micro_aes.c:1662-1680).  d0l u32[1,128] / lbl u32[nbits,128] are
    lane-replicated Δ_0 and L_b word tables (lane l holds word l%4)."""
    w = pt_words.shape[0]
    rows = jax.lax.broadcasted_iota(jnp.uint32, (w, 128), 0)
    lanes = jax.lax.broadcasted_iota(jnp.uint32, (w, 128), 1)
    i = 32 * rows + lanes // 4 + 1
    g = i ^ (i >> 1)
    offs = jnp.broadcast_to(d0l[0:1, :], (w, 128))
    for b in range(nbits):
        mask = jnp.uint32(0) - ((g >> b) & 1)
        offs = offs ^ (mask & lbl[b: b + 1, :])
    return ctrw_fused_jnp(kp_flat, pt_words ^ offs, offs, decrypt=decrypt)


# ---------------------------------------------------------------------------
# Multi-key: B messages under B keys, one program.  Each message owns a
# window of Wm stream rows; the key planes follow the message index.
# ---------------------------------------------------------------------------


def mk_window_words(nblocks: int) -> int:
    """Per-message window width in stream rows (32 blocks each):
    ceil(nblocks/32) rounded up to a multiple of 8, so that batches of
    nearby lengths share one compiled shape.  The single definition —
    modes/bulk.py and modes/seal_batch.py must agree."""
    wm = -(-nblocks // 32)
    return wm + (-wm) % 8


@functools.partial(jax.jit, static_argnames=("b", "decrypt"))
def ctrw_fused_multikey_jnp(kp_stack, ctr_words, pt_words, b: int,
                            decrypt: bool = False):
    """Cipher-and-xor over B messages with per-message keys: kp_stack
    uint32[B*(R+1)*128, 1] (per-message key planes stacked),
    ctr_words/pt_words
    uint32[B*Wm, 128] (messages concatenated, Wm rows each) — the
    single-key engine vmapped over the message axis."""
    n = kp_stack.shape[0] // b
    wm = pt_words.shape[0] // b
    return jax.vmap(
        lambda kp, cw, pw: ctrw_fused_jnp(kp, cw, pw, decrypt=decrypt)
    )(kp_stack.reshape(b, n, 1), ctr_words.reshape(b, wm, 128),
      pt_words.reshape(b, wm, 128)).reshape(b * wm, 128)


def bytes_to_stream(blocks, front_pos: int, w: int):
    """uint8[N,16] blocks -> uint32[W, 128] w-major stream with the data
    starting at stream position `front_pos` (pure bitcast + pad +
    reshape: one pass, no transposes)."""
    n = blocks.shape[0]
    u32 = jax.lax.bitcast_convert_type(
        blocks.reshape(n, 4, 4), jnp.uint32).reshape(4 * n)
    flat = jnp.pad(u32, (4 * front_pos, 128 * w - 4 * n - 4 * front_pos))
    return flat.reshape(w, 128)


def stream_to_bytes(stream, front_pos: int, n: int):
    """uint32[W, 128] -> uint8[n, 16] blocks from stream position
    front_pos (pure slice + bitcast)."""
    flat = stream.reshape(-1)
    words = jax.lax.slice(flat, (4 * front_pos,), (4 * front_pos + 4 * n,))
    return jax.lax.bitcast_convert_type(
        words.reshape(n, 4), jnp.uint8).reshape(n, 16)
