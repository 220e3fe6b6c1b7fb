"""Bulk AES-GCM-SIV seal/open entry points (RFC 8452; parity with
micro_aes.c:1418-1515): 12-byte nonce, no AAD, whole blocks.  Both run
the general per-message engine of modes/gcm_siv.py.
"""
from __future__ import annotations

from .gcm_siv import gcm_siv_decrypt, gcm_siv_encrypt


def gcm_siv_seal(key, nonce, plaintext) -> bytes:
    """Bulk GCM-SIV seal: ct || 16-byte tag."""
    nonce = bytes(nonce)
    assert len(nonce) == 12
    return gcm_siv_encrypt(bytes(key), nonce, b"", plaintext)


def gcm_siv_open(key, nonce, ct_and_tag) -> bytes:
    """Bulk GCM-SIV open: decrypt, recompute the tag, verify (raises
    AuthenticationError on mismatch)."""
    return gcm_siv_decrypt(bytes(key), bytes(nonce), b"", bytes(ct_and_tag))
