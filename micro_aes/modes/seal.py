"""Fused single-dispatch bulk AES-GCM ("seal") — the throughput engine.

v2 pipeline, fully bit-plane-resident (no per-block byte shuffles):

  counter planes (direct vector math, ops/counter.counter_planes_be)
    -> bitsliced cipher (core/bitslice.encrypt_planes)
    -> xor with plaintext planes (butterfly-packed words)
    -> int8 bit rows -> two-level int8-product GHASH (plane-ordered tables)
    -> tag.

Key layout facts exploited:
  * counter values are consecutive, so with a 32-aligned generation start
    every bit-plane word is either a fixed lane pattern (bits 0..4) or a
    per-word broadcast (bits >= 5) — the keystream never exists in byte
    form at all;
  * a 12-byte-nonce J0 has low word == 1, so the alignment offset is the
    *static* constant 2 and E(J0) is simply stream position 1;
  * leading zero blocks are free in GHASH (exponents count from the end),
    so tile padding always goes in front.

The per-message host path (modes/gcm.py) remains the general/ragged API;
this engine requires a 12-byte nonce and whole-block length (AAD of any
byte length is supported: its GHASH partial folds in ahead of the
ciphertext via one cached matrix power).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.bitslice import (
    blocks_to_words,
    encrypt_planes,
    key_planes,
    planes_to_words,
    words_to_blocks,
    words_to_planes,
)
from ..core.keyschedule import expand_key
from ..ops.counter import counter_planes_be
from ..ops.gf128 import ghash_matrix
from ..ops.ghash_bulk import ghash_finalize, ghash_from_bits, planes_to_bits_i8
from ..ops.ghash_bulk import ghash_power_tables
from ..utils.bytesio import BLOCK, verify_tag
from .common import enc_block


from ..utils.keycache import key_cache


@key_cache(maxsize=64)
def gcm_key_setup(key: bytes, chunk: int = 32, chunk2: int = 32):
    """Per-key precompute: bitsliced key planes + plane-ordered GHASH
    power tables."""
    rk = expand_key(key)
    kp = jnp.asarray(key_planes(rk))
    h = enc_block(key, np.zeros(BLOCK, np.uint8))
    m_h = ghash_matrix(h)  # host numpy probe
    tables = ghash_power_tables(m_h, chunk, chunk2, plane_order=(chunk == 32))
    return kp, tables


def _len_block(n_blocks: int, aad_bytes: int = 0) -> jax.Array:
    lb = np.zeros(BLOCK, np.uint8)
    lb[:8] = np.frombuffer((aad_bytes * 8).to_bytes(8, "big"), np.uint8)
    lb[8:] = np.frombuffer((n_blocks * BLOCK * 8).to_bytes(8, "big"), np.uint8)
    return jnp.asarray(lb)


# std GHASH bit index q_std = 8p + (7-b)  ->  plane-order index b*16 + p
_STD2PLANE = np.array(
    [8 * (q % 16) + 7 - q // 16 for q in range(128)], dtype=np.int32
)


def gcm_seal_kernel(kp, tables, j0, pt_blocks):
    """Jittable fused seal: returns (ct_blocks [N,16], tag [16]).
    Requires a J0 whose low 32 bits are 1 (12-byte-nonce fast path)."""
    n = pt_blocks.shape[0]
    chunk2 = tables[1].shape[0] // 128
    tile = 32 * chunk2

    # keystream stream: position q holds counter value J0 - 1 + q
    # (32-aligned since J0_lo == 1); data occupies positions 2..n+1 and
    # position 1 is E(J0).
    nwords = -(-(n + 2) // 32)
    nwords += (-nwords) % 4  # keep the lane axis reasonably tiled
    ctr_planes = counter_planes_be(j0, nwords, -1)
    ks_planes = encrypt_planes(kp, ctr_planes)

    pt_words = blocks_to_words(pt_blocks)  # [4, N]
    pt_words = jnp.pad(pt_words, ((0, 0), (2, 32 * nwords - n - 2)))
    ct_planes = words_to_planes(pt_words) ^ ks_planes

    ct_words = planes_to_words(ct_planes)  # [4, 32*nwords]
    ek_j0 = words_to_blocks(ct_words[:, 1:2])[0]
    ct = words_to_blocks(ct_words[:, 2: n + 2])

    bits = planes_to_bits_i8(ct_planes)[2: n + 2]  # [N,128] plane order
    gpad = (-n) % tile
    if gpad:
        bits = jnp.concatenate(
            [jnp.zeros((gpad, 128), jnp.int8), bits], axis=0)
    acc = ghash_from_bits(tables, bits)
    tag = ek_j0 ^ ghash_finalize(tables, acc, _len_block(n))
    return ct, tag


_gcm_seal_jit = jax.jit(gcm_seal_kernel)


# ---------------------------------------------------------------------------
# v3: stream form — counter + cipher + xor + GHASH level 1 in one program
# ---------------------------------------------------------------------------


@key_cache(maxsize=512)
def _trail_adjust_t(key: bytes, z: int):
    """((M_H^z)^-1)^T as int8 — compensates the z trailing masked stream
    positions of the fused seal (exponents count from the stream end)."""
    from ..ops.gf128 import gf2_matinv_np, mat_power_gf2_np

    _, tables = gcm_key_setup(key)
    mz = (mat_power_gf2_np(np.asarray(tables[3]), z) if z
          else np.eye(128, dtype=np.uint8))
    return jnp.asarray(gf2_matinv_np(mz).T.astype(np.int8))


def seal_stream_words(n_blocks: int, chunk2: int = 32) -> int:
    """Static stream width W (rows of the u32[W, 128] w-major stream) for
    a message/shard of n blocks: data at positions 2..n+2, rounded up to
    lcm(keystream alignment, chunk2) words."""
    import math

    from ..ops.ctr_kernel import seal_word_align

    align = math.lcm(seal_word_align(), chunk2)
    w = -(-(n_blocks + 2) // 32)
    return w + (-w) % align


def ctr_lohi(ctr0, w: int, start=-1):
    """Per-row counter words u32[2, W] of a 32-aligned keystream stream:
    row w covers counter values ctr0 + start + 32w + j (j = 0..31) on the
    reference's 56-bit big-endian window (bytes 9..15, micro_aes.c:
    421-428).  lo = bits 0..31 of the row's first value (low 5 bits are
    0: callers must keep ctr0's low word + start a multiple of 32), hi =
    bits 32..55.  `start` may be traced."""
    b32 = ctr0.astype(jnp.uint32)
    c_lo = (b32[12] << 24) | (b32[13] << 16) | (b32[14] << 8) | b32[15]
    c_hi = (b32[9] << 16) | (b32[10] << 8) | b32[11]
    s32 = jnp.asarray(start, jnp.int32)
    sext = (s32 >> 31).astype(jnp.uint32)
    lo0 = c_lo + s32.astype(jnp.uint32)
    carry0 = (lo0 < c_lo).astype(jnp.uint32)
    lo = lo0 + jnp.arange(w, dtype=jnp.uint32) * 32
    hi = (c_hi + sext + carry0 + (lo < lo0).astype(jnp.uint32)) & 0xFFFFFF
    return jnp.stack([lo, hi])


def j0_bit_planes(j0):
    """uint8[16] block -> u32[128, 1] of 0/~0, row b*16 + pos = bit b of
    byte pos (the broadcast planes of the counter's fixed bytes)."""
    bits = (j0[:, None] >> np.arange(8)) & 1  # [16, 8]
    return bits.T.reshape(128, 1).astype(jnp.uint32) * jnp.uint32(0xFFFFFFFF)


def ctr_stream_xor(kp, ctr0, pt_stream, start=-1, kernel=None):
    """Keystream of the 32-aligned counter stream from ctr0 (stream
    position q holds counter ctr0 + start + q) xored onto the w-major
    stream.  kernel=None takes the platform's engine (ops/ctr_kernel.
    use_kernel); True/False name one of the two explicitly."""
    from ..ops.ctr_kernel import ctr_fused_kernel, use_kernel
    from ..ops.stream import ctr_fused_jnp

    if kernel is None:
        kernel = use_kernel()
    fn = ctr_fused_kernel if kernel else ctr_fused_jnp
    return fn(kp.reshape(-1, 1), j0_bit_planes(ctr0),
              ctr_lohi(ctr0, pt_stream.shape[0], start), pt_stream)


def fused_seal_stream(kp, tables, j0, pt_stream, n: int,
                      open_direction: bool = False, start=-1, kernel=None):
    """Fused seal core, stream form: pt_stream is the w-major
    uint32[W, 128] stream (a pure host-side numpy view of the byte
    stream: row w lane 4j+k = LE word k of block 32w+j) with the message
    at positions 2..n+2.  Returns (out_stream, ek_j0_block, acc_bits)
    where acc_bits uint8[128] is the local GHASH partial *before* the
    trailing-pad compensation.  `start` (traced int32) is the counter
    offset of stream position 0 relative to J0 (-1 for a whole message;
    sp_idx*L - 1 for a block shard); must keep generation 32-aligned.
    kernel as in ctr_stream_xor: the kernel returns the keystream xor
    only, and GHASH level 1 then runs as XLA's int8 product on the
    ciphertext words; the XLA engine folds level 1 from its own planes."""
    from ..ops.ctr_kernel import use_kernel
    from ..ops.ghash_bulk import _gf2_matmul_i8, combine_levels
    from ..ops.stream import ghash1_fused_jnp, seal_fused_jnp

    w = pt_stream.shape[0]
    # validity mask: stream position 32w+j holds a message block iff the
    # position is in [2, n+2) (n, w static under jit -> plain numpy)
    pv = np.zeros(32 * w, dtype=np.uint64)
    pv[2: n + 2] = 1
    ghm = np.zeros(w, np.uint32)
    for j in range(32):
        ghm |= (pv[j::32].astype(np.uint32) << j)
    ghmask = jnp.asarray(ghm[None, :])

    w1, w2 = tables[0], tables[1]
    w1t = jnp.transpose(w1).astype(jnp.int8)
    if kernel is None:
        kernel = use_kernel()
    if kernel:
        ctw = ctr_stream_xor(kp, j0, pt_stream, start, kernel=True)
        s1t = ghash1_fused_jnp(ghmask, w1t,
                               pt_stream if open_direction else ctw)
    else:
        ctw, s1t = seal_fused_jnp(kp.reshape(-1, 1), j0_bit_planes(j0),
                                  ctr_lohi(j0, w, start), ghmask, w1t,
                                  pt_stream, bits_from_input=open_direction)

    ek_j0 = jax.lax.bitcast_convert_type(ctw[0, 4:8], jnp.uint8).reshape(16)

    chunk2 = w2.shape[0] // 128
    s2 = _gf2_matmul_i8(
        jnp.transpose(s1t).reshape(w // chunk2, chunk2 * 128), w2)
    acc = combine_levels(s2.astype(jnp.int8), tables)
    return ctw, ek_j0, acc


def fused_seal_body(kp, tables, j0, pt_blocks,
                    open_direction: bool = False, start=-1):
    """Blocks-form wrapper over fused_seal_stream (used by the sharded
    engine, whose public arrays are [B, N, 16] blocks): relayouts to and
    from the stream happen on-device here — convenient but slower than
    the stream API; bulk single-chip paths use fused_seal_stream with
    host-side views instead."""
    from ..ops.stream import bytes_to_stream, stream_to_bytes

    n = pt_blocks.shape[0]
    chunk2 = tables[1].shape[0] // 128
    w = seal_stream_words(n, chunk2)
    ptw = bytes_to_stream(pt_blocks, 2, w)
    ctw, ek_j0, acc = fused_seal_stream(kp, tables, j0, ptw, n,
                                        open_direction, start)
    return stream_to_bytes(ctw, 2, n), ek_j0, acc


def fused_trailing_pad(n_blocks: int, chunk2: int = 32) -> int:
    """z = number of trailing masked stream positions for a message/shard
    of n blocks (static).  chunk2 must match the GHASH tables in use (the
    word axis is padded as seal_stream_words says)."""
    return 32 * seal_stream_words(n_blocks, chunk2) - n_blocks - 2


@key_cache(maxsize=512)
def _aad_shift_t(key: bytes, n_ct_blocks: int):
    """(M_H^n)^T as int8 — shifts the AAD partial past the ciphertext
    blocks: G = M^n * G_aad ^ G_ct."""
    from ..ops.gf128 import mat_power_gf2_np

    _, tables = gcm_key_setup(key)
    return jnp.asarray(
        mat_power_gf2_np(np.asarray(tables[3]), n_ct_blocks).T.astype(np.int8))


def _aad_fold(tables, acc, aad_blocks, aad_shift_t):
    """Fold the AAD GHASH partial in front of the ciphertext partial."""
    from ..ops.gf128 import blocks_to_bits
    from ..ops.ghash_bulk import _gf2_matmul_i8, ghash_from_bits

    chunk2 = tables[1].shape[0] // 128
    tile = 32 * chunk2
    abits = blocks_to_bits(aad_blocks).astype(jnp.int8)[:, _STD2PLANE]
    apad = (-aad_blocks.shape[0]) % tile
    if apad:
        abits = jnp.concatenate(
            [jnp.zeros((apad, 128), jnp.int8), abits], axis=0)
    g_aad = ghash_from_bits(tables, abits)
    return acc ^ _gf2_matmul_i8(g_aad.astype(jnp.int8), aad_shift_t)


def gcm_seal_stream_fused(kp, tables, trail_adj_t, j0, pt_stream, n: int,
                          open_direction: bool = False,
                          aad_blocks=None, aad_bytes: int = 0,
                          aad_shift_t=None, kernel=None):
    """Stream-form fused seal/open: stream in, stream out (the bulk API
    views bytes as the stream host-side, so the device never touches an
    [N,16] block array).  aad_blocks uint8[Na,16] (zero-padded tail)
    folds in ahead of the ciphertext via one cached matrix power
    (aad_shift_t).  kernel as in ctr_stream_xor.  Returns (out_stream,
    tag)."""
    from ..ops.ghash_bulk import _gf2_matmul_i8

    ctw, ek_j0, acc = fused_seal_stream(kp, tables, j0, pt_stream, n,
                                        open_direction, kernel=kernel)
    acc = _gf2_matmul_i8(acc.astype(jnp.int8), trail_adj_t)
    if aad_blocks is not None and aad_blocks.shape[0]:
        acc = _aad_fold(tables, acc, aad_blocks, aad_shift_t)
    acc = acc.astype(jnp.uint8)
    tag = ek_j0 ^ ghash_finalize(tables, acc, _len_block(n, aad_bytes))
    return ctw, tag


# donate_argnums=4: the bytes APIs upload a fresh stream used nowhere
# else, so XLA may write the output stream into its buffer — the
# reference's in-place contract (micro_aes.h:520-526): one stream-sized
# device buffer end to end instead of two.
_gcm_seal_stream_jit = jax.jit(
    gcm_seal_stream_fused, donate_argnums=(4,),
    static_argnames=("n", "open_direction", "aad_bytes", "kernel"))


def host_stream(data: bytes, front_pos: int, w: int) -> np.ndarray:
    """Host-side bytes -> w-major uint32[W, 128] stream (one memcpy into
    the zero-padded buffer; the u32 view itself is free on LE hosts)."""
    words = np.frombuffer(data, np.uint32)
    out = np.zeros(w * 128, np.uint32)
    out[4 * front_pos: 4 * front_pos + len(words)] = words
    return out.reshape(w, 128)


def host_unstream(stream: np.ndarray, front_pos: int, nbytes: int) -> bytes:
    """Host-side stream -> bytes from position front_pos (one memcpy)."""
    flat = np.ascontiguousarray(stream, np.uint32).reshape(-1)
    return flat[4 * front_pos: 4 * front_pos + nbytes // 4].tobytes()


def _aad_prep(key, aad, n_ct_blocks):
    aad = bytes(aad or b"")
    if not aad:
        return None, 0, None
    na = -(-len(aad) // BLOCK)
    blocks = np.zeros((na, BLOCK), np.uint8)
    blocks.reshape(-1)[: len(aad)] = np.frombuffer(aad, np.uint8)
    return jnp.asarray(blocks), len(aad), _aad_shift_t(key, n_ct_blocks)


def ctr_bulk_stream(kp, ctr0, pt_stream):
    """Bulk CTR (CTR_NA semantics), stream form: ctr0 = nonce||0^3||0x01
    block; data occupies stream positions 1.. (counter value = ctr0 +
    position - 1, so generation starts 32-aligned at position 0)."""
    return ctr_stream_xor(kp, ctr0, pt_stream, -1)


_ctr_bulk_jit = jax.jit(ctr_bulk_stream)


def ctr_bulk(key, iv, data) -> bytes:
    """Bulk CTR encrypt/decrypt (self-inverse).  12-byte nonce with the
    RFC-3686 start value (modes/ctr.py semantics); data a whole-block
    multiple."""
    from ..ops.ctr_kernel import seal_word_align

    key = bytes(key)
    iv = bytes(iv)
    data = bytes(data)
    assert len(iv) >= 12
    n = len(data) // BLOCK
    w = -(-(n + 1) // 32)
    w += (-w) % seal_word_align()
    ctr0 = np.zeros(BLOCK, np.uint8)
    ctr0[:12] = np.frombuffer(iv[:12], np.uint8)
    ctr0[15] = 1  # CTR_START_VALUE (micro_aes.h:98)
    kp, _ = gcm_key_setup(key)
    out = _ctr_bulk_jit(kp, jnp.asarray(ctr0),
                        jnp.asarray(host_stream(data, 1, w)))
    return host_unstream(np.asarray(out), 1, len(data))


def gcm_open(key, nonce, ct_and_tag, aad: bytes = b"") -> bytes:
    """Bulk open (verify-then-return-plaintext); constraints as gcm_seal.
    Raises AuthenticationError on tag mismatch."""
    from ..errors import AuthenticationError

    key = bytes(key)
    data = bytes(ct_and_tag)
    ct, tag = data[:-16], data[-16:]
    nonce = np.frombuffer(bytes(nonce), np.uint8)
    assert len(nonce) == 12
    j0 = np.zeros(BLOCK, np.uint8)
    j0[:12] = nonce
    j0[15] = 1
    kp, tables = gcm_key_setup(key)
    # verify-BEFORE-release ordering preserved.  Bytes<->stream
    # conversion happens host-side (numpy views).
    n = len(ct) // BLOCK
    w = seal_stream_words(n)
    adj = _trail_adjust_t(key, fused_trailing_pad(n))
    ab, alen, ashift = _aad_prep(key, aad, n)
    ptw, got = _gcm_seal_stream_jit(kp, tables, adj, jnp.asarray(j0),
                                    jnp.asarray(host_stream(ct, 2, w)), n,
                                    open_direction=True, aad_blocks=ab,
                                    aad_bytes=alen, aad_shift_t=ashift)
    if not verify_tag(np.asarray(got), tag):
        raise AuthenticationError("GCM tag mismatch")
    return host_unstream(np.asarray(ptw), 2, len(ct))


def gcm_seal(key, nonce, plaintext, aad: bytes = b"") -> bytes:
    """Bulk seal: ct || 16-byte tag.  12-byte nonce, whole-block
    plaintext, optional AAD (the general API handles ragged cases)."""
    key = bytes(key)
    kp, tables = gcm_key_setup(key)
    nonce = np.frombuffer(bytes(nonce), np.uint8)
    assert len(nonce) == 12, "bulk seal path requires a 12-byte nonce"
    j0 = np.zeros(BLOCK, np.uint8)
    j0[:12] = nonce
    j0[15] = 1
    plaintext = bytes(plaintext)
    n = len(plaintext) // BLOCK
    w = seal_stream_words(n)
    adj = _trail_adjust_t(key, fused_trailing_pad(n))
    ab, alen, ashift = _aad_prep(key, aad, n)
    ctw, tag = _gcm_seal_stream_jit(
        kp, tables, adj, jnp.asarray(j0),
        jnp.asarray(host_stream(plaintext, 2, w)), n,
        aad_blocks=ab, aad_bytes=alen, aad_shift_t=ashift)
    return host_unstream(np.asarray(ctw), 2, len(plaintext)) + \
        bytes(np.asarray(tag))
