"""Bulk fused AES-OCB: the parallel body the reference itself advertises
(micro_aes.c:1653 "how to parallelize it by independent calculation of
the offset blocks"), as one fused XLA program.

The body C_i = Δ_i ^ E_K(P_i ^ Δ_i) runs through ops/stream.ocb_fused_jnp:
offsets are computed from the gray-code select on the stream words (no
offset table is uploaded), the cipher is the bitsliced round circuit,
and the open direction uses the inverse cipher.  Host-side per message: Δ_0 /
L-table setup, the ragged tail block, the checksum fold, the final tag
block, and PMAC over the AAD (all single-block oracle work).
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..core.bitslice import key_planes
from ..core.keyschedule import expand_key
from ..errors import AuthenticationError
from ..utils.bytesio import BLOCK, verify_tag
from .common import enc_block, to_u8
from .ocb import OCB_TAG_LEN, _offset0, _offsets, _subkeys


from ..utils.keycache import key_cache


@key_cache(maxsize=64)
def _ocb_key_setup(key: bytes):
    return jnp.asarray(key_planes(expand_key(key))).reshape(-1, 1)


def _lane_words(block: np.ndarray) -> np.ndarray:
    """uint8[16] -> lane-replicated u32[128]: lane l holds LE word l%4."""
    words = np.frombuffer(block.tobytes(), np.uint32)
    return np.tile(words, 32)


def _pmac_aad(key: bytes, aad: np.ndarray, ls, l_star) -> np.ndarray:
    """PMAC over the AAD (micro_aes.c:1746-1760); HASH offsets from 0."""
    an, ar = len(aad) // BLOCK, len(aad) % BLOCK
    acc = np.zeros(BLOCK, np.uint8)
    a_offs = _offsets(ls, np.zeros(BLOCK, np.uint8), an)
    if an:
        from .common import enc_blocks_np

        ab = aad[: an * BLOCK].reshape(an, BLOCK)
        acc ^= np.bitwise_xor.reduce(enc_blocks_np(key, ab ^ a_offs), axis=0)
    if ar:
        delta_an = a_offs[-1] if an else np.zeros(BLOCK, np.uint8)
        last = np.zeros(BLOCK, np.uint8)
        last[:ar] = aad[an * BLOCK:]
        last[ar] ^= 0x80
        acc ^= enc_block(key, delta_an ^ l_star ^ last)
    return acc


def _ocb_bulk_core(key: bytes, nonce, aad, data: bytes, encrypt: bool,
                   tag_len: int):
    """Returns (out_bytes, full_tag).  Body on device, edges on host."""
    from ..ops.stream import ocb_fused_jnp
    from .seal import host_stream, host_unstream

    nonce = to_u8(nonce)
    aad = to_u8(aad)
    l_star, l_dollar, ls = _subkeys(key)
    delta0 = _offset0(key, nonce, tag_len)

    n, r = len(data) // BLOCK, len(data) % BLOCK
    body, tail = data[: n * BLOCK], data[n * BLOCK:]

    out_body = b""
    if n:
        w = -(-n // 32)
        w += (-w) % 8
        nbits = max(1, (32 * w).bit_length())
        d0l = jnp.asarray(_lane_words(delta0)[None, :])
        lbl = jnp.asarray(np.stack([_lane_words(ls[b]) for b in range(nbits)]))
        kp_flat = _ocb_key_setup(key)
        ctw = ocb_fused_jnp(kp_flat, d0l, lbl,
                             jnp.asarray(host_stream(body, 0, w)),
                             nbits, decrypt=not encrypt)
        out_body = host_unstream(np.asarray(ctw), 0, n * BLOCK)

    # Δ_n from the gray select directly (host, O(log n))
    if n:
        gray = n ^ (n >> 1)
        delta_n = delta0.copy()
        b = 0
        while gray >> b:
            if (gray >> b) & 1:
                delta_n = delta_n ^ ls[b]
            b += 1
    else:
        delta_n = delta0

    out_tail = b""
    tail_pt = b""
    if r:
        pad = enc_block(key, l_star ^ delta_n)
        tail_np = np.frombuffer(tail, np.uint8) ^ pad[:r]
        out_tail = bytes(tail_np)
        tail_pt = tail if encrypt else out_tail
        delta_star = delta_n ^ l_star
    else:
        delta_star = delta_n

    # checksum over the PLAINTEXT (zero-padded tail + 0x80 marker)
    pt_body = body if encrypt else out_body
    checksum = np.zeros(BLOCK, np.uint8)
    if n:
        checksum ^= np.bitwise_xor.reduce(
            np.frombuffer(pt_body, np.uint8).reshape(n, BLOCK), axis=0)
    if r:
        checksum[:r] ^= np.frombuffer(tail_pt, np.uint8)
        checksum[r] ^= 0x80

    tag = enc_block(key, checksum ^ delta_star ^ l_dollar)
    tag = tag ^ _pmac_aad(key, aad, ls, l_star)
    return out_body + out_tail, tag


def ocb_seal(key, nonce, aad, plaintext, tag_len: int = OCB_TAG_LEN) -> bytes:
    """Bulk OCB encrypt: ct || tag; body fused on device."""
    key = bytes(key)
    ct, tag = _ocb_bulk_core(key, nonce, aad, bytes(to_u8(plaintext)),
                             True, tag_len)
    return ct + bytes(tag[:tag_len])


def ocb_open(key, nonce, aad, ct_and_tag, tag_len: int = OCB_TAG_LEN) -> bytes:
    """Bulk OCB decrypt-then-verify (constant-time compare)."""
    key = bytes(key)
    data = bytes(to_u8(ct_and_tag))
    ct, tag = data[: len(data) - tag_len], data[len(data) - tag_len:]
    pt, full_tag = _ocb_bulk_core(key, nonce, aad, ct, False, tag_len)
    if not verify_tag(full_tag[:tag_len], tag):
        raise AuthenticationError("OCB tag mismatch")
    return pt
