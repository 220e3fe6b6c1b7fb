"""Bulk XTS disk-sector engine: many sectors in one dispatch.

The reference doubles the tweak serially per block (micro_aes.c:1035).
Doubling in GF(2^128) is linear over GF(2), so the per-sector tweak
chain T·alpha^j splits two ways:

    T0 = E_k2(sector tweak)                          (bitsliced cipher)
    base[s, r] = D^(32r) @ bits(T0[s])               (one small matmul:
                                                      one base per
                                                      32-block stream row)
    off[lane jj] = base * alpha^jj                   (5 masked doubling
                                                      stages on the
                                                      stream words)
    out = off ^ CIPH_k1(off ^ data)                  (ops/stream.
                                                      xex_fused_jnp)

The v1 design materialized the whole T[s, j] chain via a [S, J*128]
matmul — 32x the message in device memory; the per-row expansion leaves
only data-sized streams there.  Sector sizes that are
not a 32-block multiple fall back to the v1 kernel (kept below).

Whole sectors only (the ragged CTS tail stays on the general modes/xts.py
path; disk workloads are sector-aligned by construction).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.bitslice import decrypt_planes, encrypt_planes, key_planes
from ..core.keyschedule import expand_key
from ..errors import DataLengthError
from ..ops.gf128 import bits_to_blocks, blocks_to_bits, double_le
from ..utils.bytesio import BLOCK
from .common import to_u8

BLOCKS_PER_SECTOR_MAX = 512  # up to 8 KiB sectors


@functools.lru_cache(maxsize=8)
def _double_powers_t(nblocks: int):
    """[(D^j)^T for j=0..nblocks-1] as int8 [J,128,128]; D = the
    little-endian doubling map (micro_aes.c:449-458), probed from the
    oracle column by column."""
    eye = np.eye(128, dtype=np.uint8)
    unit_blocks = bits_to_blocks(jnp.asarray(eye))
    d_cols = blocks_to_bits(double_le(unit_blocks))      # [128 in, 128 bits]
    d = np.asarray(d_cols).T.astype(np.uint8)            # D[out, in]
    mats = [eye]
    for _ in range(nblocks - 1):
        mats.append((mats[-1].astype(np.int32) @ d.astype(np.int32) % 2
                     ).astype(np.uint8))
    # careful: T_{j+1} = D @ T_j, so alpha^j map = D^j; stack transposed
    # for row-vector application  bits_row @ (D^j)^T
    stack = np.stack([m.T for m in mats]).astype(np.int8)
    return jnp.asarray(stack)


def _cipher_blocks(kp, blocks, decrypt=False):
    """Bitsliced cipher over uint8[N,16] (pads N to a multiple of 32)."""
    from ..core.bitslice import pack_planes, unpack_planes

    n = blocks.shape[0]
    npad = (-n) % 32
    if npad:
        blocks = jnp.pad(blocks, ((0, npad), (0, 0)))
    planes = pack_planes(blocks)
    planes = (decrypt_planes if decrypt else encrypt_planes)(kp, planes)
    return unpack_planes(planes, n + npad)[:n]


@functools.partial(jax.jit, static_argnames=("decrypt",))
def xts_sectors_kernel(kp1, kp2, pows_t, tweaks, data, decrypt: bool = False):
    """tweaks uint8[S,16], data uint8[S, J, 16] -> uint8[S, J, 16]."""
    s, j, _ = data.shape
    t0 = _cipher_blocks(kp2, tweaks)                     # E_k2(tweak)
    tbits = blocks_to_bits(t0).astype(jnp.int8)          # [S,128]
    tw = jax.lax.dot_general(
        tbits, pows_t,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32) & 1            # [S, J, 128]
    tw = bits_to_blocks(tw.astype(jnp.uint8))            # [S, J, 16]
    x = (data ^ tw).reshape(s * j, BLOCK)
    y = _cipher_blocks(kp1, x, decrypt).reshape(s, j, BLOCK)
    return y ^ tw


def _prepare(keys, sector_ids, data, sector_size, want_powers: bool = True):
    keys = bytes(keys)
    klen = len(keys) // 2
    kp1 = jnp.asarray(key_planes(expand_key(keys[:klen])))
    kp2 = jnp.asarray(key_planes(expand_key(keys[klen:])))
    flat = to_u8(data)
    if sector_size % BLOCK or len(flat) % sector_size:
        raise DataLengthError("data must be whole 16-byte-aligned sectors")
    j = sector_size // BLOCK
    if j > BLOCKS_PER_SECTOR_MAX:
        raise DataLengthError(f"sector size > {BLOCKS_PER_SECTOR_MAX * BLOCK}")
    s = len(flat) // sector_size
    tweaks = np.zeros((s, BLOCK), np.uint8)
    for i, sid in enumerate(sector_ids):
        if isinstance(sid, (bytes, bytearray, np.ndarray)):
            tweaks[i, : len(sid)] = np.frombuffer(bytes(sid), np.uint8)[:BLOCK]
        else:  # integer sector id, little-endian (copyLint, c:399-404)
            v = int(sid)
            k = 0
            while True:
                tweaks[i, k] = v & 0xFF
                v >>= 8
                k += 1
                if not v:
                    break
    blocks = flat.reshape(s, j, BLOCK)
    pows = _double_powers_t(j) if want_powers else None
    return kp1, kp2, pows, jnp.asarray(tweaks), jnp.asarray(blocks)


@functools.lru_cache(maxsize=8)
def _row_base_powers_t(r_per_sector: int):
    """[(D^(32r))^T for r = 0..R-1] concatenated on the output axis:
    int8 [128, R*128] so  tbits [S,128] @ P  yields every stream row's
    base bits in row-major (s, r) order."""
    eye = np.eye(128, dtype=np.uint8)
    unit_blocks = bits_to_blocks(jnp.asarray(eye))
    d_cols = blocks_to_bits(double_le(unit_blocks))
    d = np.asarray(d_cols).T.astype(np.int64)
    d32 = d
    for _ in range(5):  # D^32 by repeated squaring mod 2
        d32 = (d32 @ d32) % 2
    pows = [np.eye(128, dtype=np.int64)]
    for _ in range(r_per_sector - 1):
        pows.append((d32 @ pows[-1]) % 2)
    p = np.concatenate([m.T for m in pows], axis=1)  # [128, R*128]
    return jnp.asarray(p.astype(np.int8))


# value-bit column q (8*pos + b, LSB-first) -> gf128 bit column
# (8*pos + (7-b), MSB-first per byte)
_VAL_PERM = np.array([8 * (q // 8) + 7 - q % 8 for q in range(128)])


@functools.partial(jax.jit, static_argnames=("decrypt",))
def xts_sectors_stream_kernel(kp1, kp2, pows_t, tweaks, ptw,
                              decrypt: bool = False):
    """Fused-stream XTS (J % 32 == 0): tweaks uint8[S,16], data as the
    w-major u32[W, 128] stream (block n = sector-major position n;
    a free numpy view of the byte stream host-side) -> output stream."""
    from ..ops.stream import xex_fused_jnp

    w = ptw.shape[0]
    s = tweaks.shape[0]
    w_real = s * (pows_t.shape[1] // 128)

    t0 = _cipher_blocks(kp2, tweaks)                     # [S, 16]
    tbits = blocks_to_bits(t0).astype(jnp.int8)          # [S, 128]
    bases = jax.lax.dot_general(
        tbits, pows_t,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32) & 1            # [S, R*128]
    # gf128 bit columns are MSB-first per byte; u32 value bits LSB-first
    bits = bases.astype(jnp.uint32).reshape(w_real, 128)[:, _VAL_PERM]
    bw = jnp.sum(bits.reshape(w_real, 4, 32)
                 << jnp.arange(32, dtype=jnp.uint32), axis=2,
                 dtype=jnp.uint32)                       # [Wr, 4] words
    basew = jnp.broadcast_to(bw[:, None, :], (w_real, 32, 4)).reshape(
        w_real, 128)
    basew = jnp.pad(basew, ((0, w - w_real), (0, 0)))
    return xex_fused_jnp(kp1.reshape(-1, 1), basew, ptw, decrypt=decrypt)


def _run_sectors(keys, sector_ids, data, sector_size: int, decrypt: bool):
    j = sector_size // BLOCK
    if j % 32 == 0:
        from .seal import host_stream, host_unstream

        kp1, kp2, _, tweaks, _ = _prepare(keys, sector_ids, data,
                                          sector_size, want_powers=False)
        flat = bytes(to_u8(data))
        n = len(flat) // BLOCK
        w = n // 32
        w += (-w) % 8
        out = xts_sectors_stream_kernel(
            kp1, kp2, _row_base_powers_t(j // 32), tweaks,
            jnp.asarray(host_stream(flat, 0, w)), decrypt=decrypt)
        return host_unstream(np.asarray(out), 0, len(flat))
    kp1, kp2, pows, tweaks, blocks = _prepare(keys, sector_ids, data,
                                              sector_size)
    out = xts_sectors_kernel(kp1, kp2, pows, tweaks, blocks,
                             decrypt=decrypt)
    return bytes(np.asarray(out).reshape(-1))


def xts_seal_sectors(keys, sector_ids, data, sector_size: int = 4096) -> bytes:
    """Encrypt S whole sectors, each under tweak sector_ids[i].
    keys = key1 || key2; sector_ids: ints or 16-byte tweaks."""
    return _run_sectors(keys, sector_ids, data, sector_size, False)


def xts_open_sectors(keys, sector_ids, data, sector_size: int = 4096) -> bytes:
    """Decrypt S whole sectors (inverse of xts_seal_sectors)."""
    return _run_sectors(keys, sector_ids, data, sector_size, True)
