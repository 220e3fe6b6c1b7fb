"""C-style compat layer: names, conventions and numeric codes."""
from micro_aes import compat
from micro_aes.testing import kat
import pytest

pytestmark = pytest.mark.quick


def test_error_code_values():
    # micro_aes.h:469-476 (0x1L is the long literal 1)
    assert compat.M_RESULT_SUCCESS == 0
    assert compat.M_ENCRYPTION_ERROR == 0x1E
    assert compat.M_DECRYPTION_ERROR == 0x1D
    assert compat.M_AUTHENTICATION_ERROR == 0x1A
    assert compat.M_DATALENGTH_ERROR == 1


def test_compat_gcm_roundtrip_and_codes():
    key, iv, aad, pt = kat.CIPHER_KEY[:16], kat.IVEC[:12], kat.AAD, kat.PLAINTEXT
    ct = compat.AES_GCM_encrypt(key, iv, aad, pt)
    assert ct == kat.GCM128
    code, out = compat.AES_GCM_decrypt(key, iv, aad, ct)
    assert code == compat.M_RESULT_SUCCESS and out == pt
    bad = bytearray(ct)
    bad[-1] ^= 1
    code, out = compat.AES_GCM_decrypt(key, iv, aad, bytes(bad))
    assert code == compat.M_AUTHENTICATION_ERROR and out == b""


def test_compat_length_errors():
    code, _ = compat.AES_CBC_encrypt(kat.CIPHER_KEY[:16], kat.IVEC, b"x")
    assert code == compat.M_DATALENGTH_ERROR
    code, _ = compat.AES_KEY_wrap(kat.CIPHER_KEY[:16], b"1234567")
    assert code == compat.M_DATALENGTH_ERROR


def test_compat_cipher_and_macs():
    assert compat.AES_Cipher(kat.FIPS_KEY128, "E", kat.FIPS_PT) == kat.FIPS_CT128
    assert compat.AES_CMAC(kat.CIPHER_KEY[:16], kat.PLAINTEXT) == kat.CMAC128
    assert compat.AES_Poly1305(kat.CIPHER_KEY, kat.IVEC, kat.PLAINTEXT) == kat.POLY1305_128


def test_compat_fpe():
    code, out = compat.AES_FPE_encrypt(kat.CIPHER_KEY[:16], kat.AAD, kat.FPE_PLAIN)
    assert code == 0 and out == kat.FPE_FF1_CIPHER
    code, out = compat.AES_FPE_encrypt(kat.CIPHER_KEY[:16], b"", "123")
    assert code == compat.M_ENCRYPTION_ERROR
