"""Poly1305-AES MAC (Bernstein 2005) — parity with micro_aes.c:1901-1996.

The reference does schoolbook 17-byte-limb arithmetic; chunks are
processed back-to-front with rising powers of r (c:1976-1986), i.e.

    poly = sum_j chunk_j * r^(q+1-j)  mod 2^130-5,   tag = poly + AES_k(nonce) mod 2^128.

Host arithmetic uses Python ints (exact); AES_k(nonce) runs on device.
The powers-of-r form is the same parallel structure used for the sharded
bulk path (each shard computes a partial sum, combined with one psum).
"""
from __future__ import annotations

from .common import BLOCK, enc_block, to_u8

P1305 = (1 << 130) - 5

# poly1305_aes routes messages at/above this size through the device
# fold (poly1305_aes_bulk); below it the Horner host loop wins (no
# device dispatch, no power-table build).
_BULK_THRESHOLD = 1 << 16


def _clamp_r(r: bytes) -> int:
    """r-clamping (micro_aes.c:1969-1974)."""
    b = bytearray(r[:16])
    for i in (3, 7, 11, 15):
        b[i] &= 0x0F
    for i in (4, 8, 12):
        b[i] &= 0xFC
    return int.from_bytes(bytes(b), "little")


def poly1305_aes(keys, nonce, data) -> bytes:
    """AES_Poly1305 (micro_aes.c:1956-1996).
    keys = AES key (16/24/32 B) || r (16 B); nonce is one block."""
    keys = bytes(keys)
    klen = len(keys) - 16
    aes_key, r_bytes = keys[:klen], keys[klen:]
    nonce = to_u8(nonce)[:BLOCK]
    data = bytes(to_u8(data))

    if len(data) >= _BULK_THRESHOLD:
        # large messages ride the device fold (ops/poly_bulk) — the host
        # loop below is O(n) 130-bit multiplies, the device path is int8
        # matmuls over powers of r
        return poly1305_aes_bulk(keys, nonce, data)

    s = int.from_bytes(bytes(enc_block(aes_key, nonce)), "little")
    if not data:
        return int.to_bytes(s, 16, "little")

    r = _clamp_r(r_bytes)
    q = (len(data) - 1) // BLOCK  # chunks - 1
    # Horner form of sum_j chunk_j * r^(q+1-j): iterate chunks forward,
    # poly = (poly + c_j) * r — ONE 130-bit multiply per chunk instead
    # of a per-chunk modpow (the r4 host path ran pow(r, q+1-j, P) for
    # every chunk: 65k modpows for 1 MiB).  Same sum, same reference
    # semantics (micro_aes.c:1976-1986 builds the rising powers).
    poly = 0
    for j in range(q + 1):
        chunk = data[j * BLOCK: (j + 1) * BLOCK]
        c = int.from_bytes(chunk + b"\x01", "little")
        poly = ((poly + c) * r) % P1305
    return int.to_bytes((poly + s) % (1 << 128), 16, "little")


def poly1305_aes_bulk(keys, nonce, data) -> bytes:
    """Device Poly1305-AES: the whole-chunk body folds on device as
    batched int8 matmuls over powers of r (ops/poly_bulk — the same
    two-level + span design as the GHASH engine, over Z mod 2^130-5
    instead of GF(2^128)); only the ragged tail chunk and the final
    canonical reduction run host-side.  Bit-exact vs poly1305_aes."""
    import jax.numpy as jnp
    import numpy as np

    from ..ops.poly_bulk import (
        P1305 as _P,
        limbs_to_int,
        poly_fold_jnp,
        poly_power_tables,
    )

    keys = bytes(keys)
    klen = len(keys) - 16
    aes_key, r_bytes = keys[:klen], keys[klen:]
    nonce = to_u8(nonce)[:BLOCK]
    data = bytes(to_u8(data))

    s = int.from_bytes(bytes(enc_block(aes_key, nonce)), "little")
    if not data:
        return int.to_bytes(s, 16, "little")

    r = _clamp_r(r_bytes)
    nf, tail_len = divmod(len(data), BLOCK)
    poly = 0
    if nf:
        n = nf + ((-nf) % 32)
        tables = poly_power_tables(r, n)
        words = np.zeros((n, 4), np.uint32)
        words[n - nf:] = np.frombuffer(
            data[: nf * BLOCK], np.uint32).reshape(nf, 4)
        pad_mask = np.zeros(n, np.int32)
        pad_mask[n - nf:] = 1  # front-padded zero chunks get no pad bit
        limbs = poly_fold_jnp(tables, jnp.asarray(words.T),
                              jnp.asarray(pad_mask))
        poly = limbs_to_int(limbs)
    if tail_len:
        c_tail = int.from_bytes(data[nf * BLOCK:] + b"\x01", "little")
        poly = ((poly + c_tail) * r) % _P
    return int.to_bytes((poly + s) % (1 << 128), 16, "little")
