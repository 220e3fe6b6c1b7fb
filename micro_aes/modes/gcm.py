"""AES-GCM (NIST SP 800-38D) — parity with micro_aes.c:1124-1212.

Structure: the CTR body is a fully parallel batched cipher call;
GHASH is a GF(2)-linear fold using the per-key bit-matrix M_H
(ops/gf128.ghash_matrix) — serial-fold here, powers-of-H tree reduction on
the bulk path (parallel/).  Tag verification happens *before* decrypting,
matching the reference (micro_aes.c:1204-1209).
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..errors import AuthenticationError
from ..ops.gf128 import ghash_matrix
from ..ops.mac import ghash_fold
from ..utils.bytesio import block_bucket, verify_tag
from .common import (
    BLOCK,
    ctr_xcrypt,
    enc_block,
    to_u8,
    xmac_blocks,
)

GCM_NONCE_LEN = 12
GCM_TAG_LEN = 16


from ..utils.keycache import key_cache


@key_cache(maxsize=8192)  # 16 KB/entry; covers the 7875-key CAVP files
def _auth_matrix(key: bytes):
    """M_H for H = E_K(0) (GCMsetup, micro_aes.c:1140-1144), cached per key."""
    h = enc_block(key, np.zeros(16, np.uint8))
    return ghash_matrix(h)  # host numpy probe


def _ghash(key: bytes, aad, ct, aad_len: int, ct_len: int) -> np.ndarray:
    """gHash (micro_aes.c:1127-1137): fold AAD, then data, then bit-lengths."""
    lens = np.zeros(BLOCK, np.uint8)
    lens[:8] = np.frombuffer((aad_len * 8).to_bytes(8, "big"), np.uint8)
    lens[8:] = np.frombuffer((ct_len * 8).to_bytes(8, "big"), np.uint8)
    blocks = np.concatenate(
        [xmac_blocks(aad), xmac_blocks(ct), lens[None, :]], axis=0
    )
    n = blocks.shape[0]
    nb = block_bucket(n)
    buf = np.zeros((nb, BLOCK), np.uint8)
    buf[:n] = blocks
    g = ghash_fold(
        _auth_matrix(key),
        jnp.zeros(16, jnp.uint8),
        jnp.asarray(buf),
        jnp.int32(n),
    )
    return np.asarray(g)


def _gcm_iv(key: bytes, nonce) -> np.ndarray:
    """J0 derivation (GCMsetup, micro_aes.c:1145-1151)."""
    nonce = to_u8(nonce)
    if len(nonce) == 12:
        iv = np.zeros(BLOCK, np.uint8)
        iv[:12] = nonce
        iv[15] = 1
        return iv
    return _ghash(key, b"", nonce, 0, len(nonce))


def gcm_encrypt(key, nonce, aad, plaintext, tag_len: int = GCM_TAG_LEN) -> bytes:
    """AES_GCM_encrypt (micro_aes.c:1164-1179): returns ct || tag."""
    key = bytes(key)
    pt = to_u8(plaintext)
    iv = _gcm_iv(key, nonce)
    ct = ctr_xcrypt(key, iv, "ccm_gcm", pt)
    ek_iv = enc_block(key, iv)
    g = _ghash(key, aad, ct, len(to_u8(aad)), len(pt))
    tag = ek_iv ^ g
    return ct + bytes(tag[:tag_len])


def gcm_decrypt(key, nonce, aad, ct_and_tag, tag_len: int = GCM_TAG_LEN) -> bytes:
    """AES_GCM_decrypt (micro_aes.c:1192-1211): verify-then-decrypt."""
    key = bytes(key)
    data = to_u8(ct_and_tag)
    ct, tag = data[: len(data) - tag_len], data[len(data) - tag_len:]
    iv = _gcm_iv(key, nonce)
    g = _ghash(key, aad, ct, len(to_u8(aad)), len(ct))
    expect = (enc_block(key, iv) ^ g)[:tag_len]
    if not verify_tag(expect, tag):
        raise AuthenticationError("GCM tag mismatch")
    return ctr_xcrypt(key, iv, "ccm_gcm", ct)
