"""SP 800-38A modes + XTS against the reference main.c known answers."""
import numpy as np
import pytest

from micro_aes.errors import DataLengthError, DecryptionError
from micro_aes.modes import common
from micro_aes.modes.cbc import cbc_decrypt, cbc_encrypt
from micro_aes.modes.cfb import cfb_decrypt, cfb_encrypt
from micro_aes.modes.ctr import ctr_decrypt, ctr_encrypt
from micro_aes.modes.ecb import ecb_decrypt, ecb_encrypt
from micro_aes.modes.ofb import ofb_decrypt, ofb_encrypt
from micro_aes.modes.xts import xts_decrypt, xts_encrypt
from micro_aes.testing import kat

pytestmark = pytest.mark.quick

KEY128 = kat.CIPHER_KEY[:16]
KEY256 = kat.CIPHER_KEY
IV = kat.IVEC
PT = kat.PLAINTEXT  # 57 bytes


def test_ecb_128():
    assert ecb_encrypt(KEY128, PT) == kat.ECB128
    assert ecb_decrypt(KEY128, kat.ECB128) == kat.ECB128 and False or ecb_decrypt(
        KEY128, kat.ECB128
    )[: len(PT)] == PT


def test_ecb_192_pkcs7():
    key192 = kat.CIPHER_KEY[:24]
    assert ecb_encrypt(key192, PT, padding=common.PAD_PKCS7) == kat.ECB192


def test_ecb_partial_block_decrypt_errors():
    with pytest.raises(DecryptionError):
        ecb_decrypt(KEY128, b"\x00" * 17)


def test_cbc_cts():
    assert cbc_encrypt(KEY128, IV, PT, cts=True) == kat.CBC128_CTS
    assert cbc_decrypt(KEY128, IV, kat.CBC128_CTS, cts=True) == PT


def test_cbc_zero_pad():
    assert cbc_encrypt(KEY128, IV, PT, cts=False) == kat.CBC128_PAD0
    got = cbc_decrypt(KEY128, IV, kat.CBC128_PAD0, cts=False)
    assert got[: len(PT)] == PT


def test_cbc_cts_too_short():
    with pytest.raises(DataLengthError):
        cbc_encrypt(KEY128, IV, b"short", cts=True)


def test_cbc_exact_blocks_roundtrip():
    pt = bytes(range(48))
    ct = cbc_encrypt(KEY128, IV, pt, cts=True)
    assert cbc_decrypt(KEY128, IV, ct, cts=True) == pt


def test_cfb():
    assert cfb_encrypt(KEY128, IV, PT) == kat.CFB128
    assert cfb_decrypt(KEY128, IV, kat.CFB128) == PT


def test_ofb():
    assert ofb_encrypt(KEY128, IV, PT) == kat.OFB128
    assert ofb_decrypt(KEY128, IV, kat.OFB128) == PT


def test_ctr():
    assert ctr_encrypt(KEY128, IV, PT) == kat.CTR128
    assert ctr_decrypt(KEY128, IV, kat.CTR128) == PT


def test_xts_128():
    assert xts_encrypt(KEY256, IV, PT) == kat.XTS128  # 2x16-byte keys
    assert xts_decrypt(KEY256, IV, kat.XTS128) == PT


def test_xts_256():
    keys = kat.CIPHER_KEY + kat.SECOND_KEY  # 2x32-byte keys (main.c:119-120)
    assert xts_encrypt(keys, IV, PT) == kat.XTS256
    assert xts_decrypt(keys, IV, kat.XTS256) == PT


def test_xts_too_short():
    with pytest.raises(DataLengthError):
        xts_encrypt(KEY256, IV, b"0123456789")
