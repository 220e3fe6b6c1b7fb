"""Security-opts parity (micro_aes.c:362-384 under INCREASE_SECURITY):
constant-time tag verification + strict nonce validation."""
import numpy as np
import pytest

import micro_aes as aes
from micro_aes.errors import AuthenticationError, DataLengthError
from micro_aes.utils.bytesio import verify_tag

pytestmark = pytest.mark.quick


class TestVerifyTag:
    def test_equal(self):
        assert verify_tag(b"\x01\x02\x03", b"\x01\x02\x03")
        assert verify_tag(np.array([1, 2, 3], np.uint8), b"\x01\x02\x03")
        assert verify_tag(np.array([1, 2], np.uint8), np.array([1, 2], np.uint8))

    def test_mismatch(self):
        assert not verify_tag(b"\x01\x02\x03", b"\x01\x02\x04")
        assert not verify_tag(b"\x01\x02\x03", b"\xff\x02\x03")

    def test_length_mismatch(self):
        assert not verify_tag(b"\x01\x02", b"\x01\x02\x03")
        assert not verify_tag(b"", b"\x00")

    def test_empty_equal(self):
        assert verify_tag(b"", b"")


def _flip_last(blob: bytes) -> bytes:
    return blob[:-1] + bytes([blob[-1] ^ 1])


class TestTamperedTagsRaise:
    """Every AEAD/KW verify path must go through the constant-time helper
    and still reject a tampered tag."""

    KEY = bytes(range(16))
    KEY32 = bytes(range(32))
    NONCE12 = bytes(range(12))
    PT = b"constant-time verification parity!!!"  # 36 bytes

    def test_gcm(self):
        blob = aes.gcm_encrypt(self.KEY, self.NONCE12, b"aad", self.PT)
        with pytest.raises(AuthenticationError):
            aes.gcm_decrypt(self.KEY, self.NONCE12, b"aad", _flip_last(blob))

    def test_ccm(self):
        blob = aes.ccm_encrypt(self.KEY, self.NONCE12[:11], b"aad", self.PT)
        with pytest.raises(AuthenticationError):
            aes.ccm_decrypt(self.KEY, self.NONCE12[:11], b"aad", _flip_last(blob))

    def test_eax(self):
        blob = aes.eax_encrypt(self.KEY, self.NONCE12, b"aad", self.PT)
        with pytest.raises(AuthenticationError):
            aes.eax_decrypt(self.KEY, self.NONCE12, b"aad", _flip_last(blob))

    def test_ocb(self):
        blob = aes.ocb_encrypt(self.KEY, self.NONCE12, b"aad", self.PT)
        with pytest.raises(AuthenticationError):
            aes.ocb_decrypt(self.KEY, self.NONCE12, b"aad", _flip_last(blob))

    def test_gcm_siv(self):
        blob = aes.gcm_siv_encrypt(self.KEY, self.NONCE12, b"aad", self.PT)
        with pytest.raises(AuthenticationError):
            aes.gcm_siv_decrypt(self.KEY, self.NONCE12, b"aad", _flip_last(blob))

    def test_siv(self):
        iv, ct = aes.siv_encrypt(self.KEY32, b"aad", self.PT)
        with pytest.raises(AuthenticationError):
            aes.siv_decrypt(self.KEY32, _flip_last(iv), b"aad", ct)

    def test_kw(self):
        blob = aes.key_wrap(self.KEY, bytes(range(32)))
        with pytest.raises(AuthenticationError):
            aes.key_unwrap(self.KEY, _flip_last(blob[:8]) + blob[8:])


class TestPurgeKeyCaches:
    """BURN analogue (micro_aes.c:362-368): every memo over key material
    is registered with @key_cache and cleared by purge_key_caches()."""

    def test_purge_clears_and_rederives(self):
        key, nonce, pt = bytes(range(32)), bytes(range(12)), b"burn parity" * 3
        blob = aes.gcm_encrypt(key, nonce, b"aad", pt)
        from micro_aes.utils.keycache import registered_key_caches

        n = aes.purge_key_caches()
        assert n == len(registered_key_caches()) >= 16
        for fn in registered_key_caches():
            assert fn.cache_info().currsize == 0, fn.__name__
        assert aes.gcm_encrypt(key, nonce, b"aad", pt) == blob

    def test_every_key_material_lru_cache_is_registered(self):
        """Audit: a bare functools.lru_cache in the package must be on
        the structural whitelist (holds no key-derived material);
        anything else must use @key_cache."""
        import pathlib
        import re

        import micro_aes

        root = pathlib.Path(micro_aes.__file__).parent
        structural = {
            # fixed-matrix powers / radix tables / alphabet LUTs — no keys
            ("modes/xts_bulk.py", "_double_powers_t"),
            ("modes/xts_bulk.py", "_row_base_powers_t"),
            ("fpe/device.py", "_num_table"),
            ("fpe/device.py", "_ydig_table"),
            ("fpe/device.py", "_ascii_luts"),
        }
        found = set()
        pat = re.compile(
            r"@functools\.lru_cache\([^)]*\)[^\n]*\ndef (\w+)")
        for py in root.rglob("*.py"):
            for m in pat.finditer(py.read_text()):
                found.add((str(py.relative_to(root)), m.group(1)))
        unregistered = found - structural
        assert not unregistered, (
            f"key-material caches must use @key_cache: {unregistered}")


class TestNonceValidation:
    KEY = bytes(range(16))

    def test_ocb_nonce_too_long(self):
        with pytest.raises(DataLengthError):
            aes.ocb_encrypt(self.KEY, bytes(16), b"", b"x" * 16)

    def test_ocb_nonce_empty(self):
        with pytest.raises(DataLengthError):
            aes.ocb_encrypt(self.KEY, b"", b"", b"x" * 16)

    def test_gcm_siv_nonce_wrong_length(self):
        for n in (0, 8, 11, 13, 16):
            with pytest.raises(DataLengthError):
                aes.gcm_siv_encrypt(self.KEY, bytes(n), b"", b"x" * 16)
            with pytest.raises(DataLengthError):
                aes.gcm_siv_decrypt(self.KEY, bytes(n), b"", b"x" * 32)
