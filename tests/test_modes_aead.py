"""AEAD + MAC modes vs reference main.c vectors and RFC extras."""
import numpy as np
import pytest

from micro_aes.errors import AuthenticationError, DataLengthError
from micro_aes.modes import (
    ccm_decrypt, ccm_encrypt, cmac, eax_decrypt, eax_encrypt,
    eaxp_decrypt, eaxp_encrypt, gcm_decrypt, gcm_encrypt,
    gcm_siv_decrypt, gcm_siv_encrypt, key_unwrap, key_wrap,
    ocb_decrypt, ocb_encrypt, poly1305_aes, siv_decrypt, siv_encrypt,
)
from micro_aes.testing import kat
from micro_aes.utils.bytesio import hex2bytes

KEY128 = kat.CIPHER_KEY[:16]
KEY256 = kat.CIPHER_KEY
IV = kat.IVEC
AAD = kat.AAD
PT = kat.PLAINTEXT


def test_cmac():
    assert cmac(KEY128, PT) == kat.CMAC128


def test_gcm_128():
    out = gcm_encrypt(KEY128, IV[:12], AAD, PT)
    assert out == kat.GCM128
    assert gcm_decrypt(KEY128, IV[:12], AAD, out) == PT


def test_gcm_256():
    out = gcm_encrypt(KEY256, IV[:12], AAD, PT)
    assert out == kat.GCM256
    assert gcm_decrypt(KEY256, IV[:12], AAD, out) == PT


def test_gcm_tamper():
    out = bytearray(gcm_encrypt(KEY128, IV[:12], AAD, PT))
    out[3] ^= 1
    with pytest.raises(AuthenticationError):
        gcm_decrypt(KEY128, IV[:12], AAD, bytes(out))


def test_ccm():
    out = ccm_encrypt(KEY128, IV[:11], AAD, PT)
    assert out == kat.CCM128
    assert ccm_decrypt(KEY128, IV[:11], AAD, out) == PT


def test_siv():
    iv, ct = siv_encrypt(KEY256, AAD, PT)  # K1||K2 = 32 bytes
    assert iv + ct == kat.SIV128
    assert siv_decrypt(KEY256, iv, AAD, ct) == PT


def test_siv_rfc5297():
    key = hex2bytes("fffefdfcfbfaf9f8f7f6f5f4f3f2f1f0f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
    ad = hex2bytes("101112131415161718191a1b1c1d1e1f2021222324252627")
    pt = hex2bytes("112233445566778899aabbccddee")
    expect = hex2bytes(
        "85632d07c6e8f37f950acd320a2ecc9340c02b9690c4dc04daef7f6afe5c"
    )
    iv, ct = siv_encrypt(key, ad, pt)
    assert iv + ct == expect
    assert siv_decrypt(key, iv, ad, ct) == pt


def test_siv_no_aad_miscreant():
    key = hex2bytes("fffefdfcfbfaf9f8f7f6f5f4f3f2f1f0f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
    pt = hex2bytes("00112233445566778899aabbccddeeff")
    expect = hex2bytes(
        "f304f912863e303d5b540e5057c7010c942ffaf45b0e5ca5fb9a56a5263bb065"
    )
    iv, ct = siv_encrypt(key, b"", pt)
    assert iv + ct == expect


def test_gcm_siv():
    out = gcm_siv_encrypt(KEY128, IV[:12], AAD, PT)
    assert out == kat.GCMSIV128
    assert gcm_siv_decrypt(KEY128, IV[:12], AAD, out) == PT


def test_gcm_siv_rfc8452():
    key = hex2bytes("ee8e1ed9ff2540ae8f2ba9f50bc2f27c")
    nonce = hex2bytes("752abad3e0afb5f434dc4310")
    aad = b"example"
    pt = b"Hello world"
    expect = hex2bytes("5d349ead175ef6b1def6fd4fbcdeb7e4793f4a1d7e4faa70100af1")
    assert gcm_siv_encrypt(key, nonce, aad, pt) == expect
    key = hex2bytes("01000000000000000000000000000000")
    nonce = hex2bytes("030000000000000000000000")
    aad = hex2bytes("01")
    pt = hex2bytes(
        "0200000000000000000000000000000003000000000000000000000000000000"
    )
    expect = hex2bytes(
        "620048ef3c1e73e57e02bb8562c416a319e73e4caac8e96a1ecb2933145a1d71"
        "e6af6a7f87287da059a71684ed3498e1"
    )
    assert gcm_siv_encrypt(key, nonce, aad, pt) == expect


def test_eax():
    out = eax_encrypt(KEY128, IV, AAD, PT)
    assert out == kat.EAX128
    assert eax_decrypt(KEY128, IV, AAD, out) == PT


def test_eaxp_ieee1703():
    # Annex G of IEEE Std 1703-2012 (main.c:322-333): empty payload
    key = hex2bytes("01020304050607080102030405060708")
    cleartext = hex2bytes(
        "A20D060B607C86F7540116007BC175A803020100BE0D280B810984A60C060A60"
        "7C86F7540116007B040248F3C20403300005"
    )
    assert eaxp_encrypt(key, cleartext, b"") == hex2bytes("515AE775")
    assert eaxp_decrypt(key, cleartext, hex2bytes("515AE775")) == b""


def test_eaxp_mbpb_paper():
    # Moise-Beroset-Phinney-Burns vectors (main.c:334-348)
    key = hex2bytes("102030405060708090a0b0c0d0e0f000")
    nonce_data = hex2bytes(
        "a20e060c6086480186fc2f811caa4e01a806020439a00ebbac0fa20da00ba109"
        "80010081044bcee2c3be2528238121 88a60a06082b06010401828563004bcee2c3"
    )
    pt = hex2bytes("1751" + "30" * 20 + "000003300001")
    expect = hex2bytes(
        "9cf32c7ec24c250be7b0749feee71a220d0eee976ec23dbf0caa08ea00543e66"
    )
    out = eaxp_encrypt(key, nonce_data, pt)
    assert out == expect
    assert eaxp_decrypt(key, nonce_data, expect) == pt


def test_ocb():
    out = ocb_encrypt(KEY128, IV[:12], AAD, PT)
    assert out == kat.OCB128
    assert ocb_decrypt(KEY128, IV[:12], AAD, out) == PT


def test_ocb_rfc7253():
    key = hex2bytes("000102030405060708090A0B0C0D0E0F")
    nonce = hex2bytes("BBAA99887766554433221107")
    aad = hex2bytes("000102030405060708090A0B0C0D0E0F1011121314151617")
    pt = aad
    expect = hex2bytes(
        "1CA2207308C87C010756104D8840CE1952F09673A448A122"
        "C92C62241051F57356D7F3C90BB0E07F"
    )
    assert ocb_encrypt(key, nonce, aad, pt) == expect
    assert ocb_decrypt(key, nonce, aad, expect) == pt


def test_kw():
    # main.c:252-257: kek = SECRET_KEY[:16], secret = SECOND_KEY[:16]
    out = key_wrap(kat.SECRET_KEY[:16], kat.SECOND_KEY[:16])
    assert out == kat.KW128
    assert key_unwrap(kat.SECRET_KEY[:16], out) == kat.SECOND_KEY[:16]


def test_kw_256():
    # RFC-3394 p.34 (main.c:22-24): AES-256 KEK wraps 32-byte secret
    out = key_wrap(kat.SECRET_KEY, kat.SECOND_KEY)
    assert out == kat.KW256
    assert key_unwrap(kat.SECRET_KEY, out) == kat.SECOND_KEY


def test_kw_192():
    out = key_wrap(kat.SECRET_KEY[:24], kat.SECOND_KEY[:24])
    assert out == kat.KW192


def test_kw_errors():
    with pytest.raises(DataLengthError):
        key_wrap(KEY128, b"\x00" * 7)
    bad = bytearray(key_wrap(KEY128, kat.SECOND_KEY[:16]))
    bad[0] ^= 1
    with pytest.raises(AuthenticationError):
        key_unwrap(KEY128, bytes(bad))


def test_poly1305_main_c():
    assert poly1305_aes(kat.CIPHER_KEY, IV, PT) == kat.POLY1305_128


def test_poly1305_bernstein():
    data = hex2bytes(
        "663cea190ffb83d89593f3f476b6bc24d7e679107ea26adb8caf6652d0656136"
    )
    keys = hex2bytes(
        "6acb5f61a7176dd320c5c1eb2edcdc744844 3d0bb0d21109c89a100b5ce2c208"
    )
    nonce = hex2bytes("ae212a553997 29595dea458bc621ff0e")
    expect = hex2bytes("0ee1c16bb73f0f4fd19881753c01cdbe")
    assert poly1305_aes(keys, nonce, data) == expect
    data = hex2bytes(
        "ab0812724a7f1e342742cbed374d94d136c6b8795d45b3819830f2c04491faf0"
        "990c62e48b8018b2c3e4a0fa3134cb67fa83e158c994d961c4cb21095c1bf9"
    )
    keys = hex2bytes(
        "e1a5668a4d5b66a5f68cc5424ed5982d12976a08c4426d0ce8a82407c4f48207"
    )
    nonce = hex2bytes("9ae831e743978d3a23527c7128149e3a")
    expect = hex2bytes("5154ad0d2cb26e01274fc51148491f1b")
    assert poly1305_aes(keys, nonce, data) == expect
