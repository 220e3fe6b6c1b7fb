"""Bulk GCM-SIV seal/open entry points (modes/siv_seal.py) against the
general per-message path, plus tag rejection."""
import numpy as np
import pytest

from micro_aes.errors import AuthenticationError
from micro_aes.modes.gcm_siv import gcm_siv_encrypt
from micro_aes.modes.siv_seal import gcm_siv_open, gcm_siv_seal


def test_siv_seal_matches_reference_path():
    rng = np.random.default_rng(21)
    key = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    nonce = bytes(rng.integers(0, 256, 12, dtype=np.uint8))
    pt = bytes(rng.integers(0, 256, 16 * 37, dtype=np.uint8))
    out = gcm_siv_seal(key, nonce, pt)
    assert out == gcm_siv_encrypt(key, nonce, b"", pt)
    assert gcm_siv_open(key, nonce, out) == pt
    bad = bytearray(out)
    bad[5] ^= 4
    with pytest.raises(AuthenticationError):
        gcm_siv_open(key, nonce, bytes(bad))
