"""FPE FF1/FF3/FF3-1 against the reference tv corpus + main.c vectors."""
import pytest

from micro_aes.errors import EncryptionError
from micro_aes.fpe import fpe_decrypt, fpe_encrypt
from micro_aes.testing import kat, rsp


def test_fpe_main_c_ff1():
    key, aad = kat.CIPHER_KEY[:16], kat.AAD
    out = fpe_encrypt(key, aad, kat.FPE_PLAIN, "digits", "ff1")
    assert out == kat.FPE_FF1_CIPHER
    assert fpe_decrypt(key, aad, out, "digits", "ff1") == kat.FPE_PLAIN


def test_fpe_main_c_ff3():
    key, tweak = kat.CIPHER_KEY[:16], kat.AAD[:7]
    pt = kat.FPE_PLAIN[:55]
    out = fpe_encrypt(key, tweak, pt, "digits", "ff3-1")
    assert out == kat.FPE_FF3_CIPHER
    assert fpe_decrypt(key, tweak, out, "digits", "ff3-1") == pt


def test_fpe_tv_corpus(vector_corpus):
    recs = rsp.load_fpe()
    assert len(recs) >= 50
    ran = 0
    for r in recs:
        method = r["Method"].strip().lower()
        if method == "ff3":
            # distinguish old-FF3 (8-byte tweak) from FF3-1 (7-byte)
            method = "ff3" if len(rsp.hexval(r, "Tweak")) == 8 else "ff3-1"
        alphabet = r["Alphabet"]
        key = rsp.hexval(r, "Key")
        tweak = rsp.hexval(r, "Tweak")
        pt, ct = r["PT"], r["CT"]
        got = fpe_encrypt(key, tweak, pt, alphabet, method)
        assert got == ct, f"FPE {method} count={r['Count']}: {got} != {ct}"
        assert fpe_decrypt(key, tweak, ct, alphabet, method) == pt
        ran += 1
    assert ran == len(recs)


def test_fpe_errors():
    with pytest.raises(EncryptionError):
        fpe_encrypt(kat.CIPHER_KEY[:16], b"", "123", "digits", "ff1")  # too short
    with pytest.raises(EncryptionError):
        fpe_encrypt(kat.CIPHER_KEY[:16], b"", "123456x", "digits", "ff1")  # bad char
