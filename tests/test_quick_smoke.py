"""Quick tier: ONE vector per conformance suite (the full corpora live in
test_cavp_gcm.py / test_cavp_suites.py).  This is the <5-minute smoke
gate to run before snapshot commits:

    python -m pytest tests/ -m quick -q

mirroring the reference's two-tier main.c (smoke) / testvectors (full)
split (SURVEY §4)."""
import pytest

from micro_aes.errors import AuthenticationError
from micro_aes.modes import (
    ccm_decrypt, ccm_encrypt, eax_decrypt, eax_encrypt,
    gcm_siv_decrypt, gcm_siv_encrypt, ocb_decrypt, ocb_encrypt,
    poly1305_aes,
)
from micro_aes.fpe import fpe_decrypt, fpe_encrypt
from micro_aes.modes.cmac import cmac
from micro_aes.modes.gcm import gcm_decrypt, gcm_encrypt
from micro_aes.modes.xts import xts_decrypt, xts_encrypt
from micro_aes.testing import rsp

pytestmark = [pytest.mark.quick, pytest.mark.usefixtures("vector_corpus")]


def _first(recs, want_pt="PT"):
    """First record with a nonempty payload (so the round-trip is
    meaningful, not a pure-AAD case)."""
    for r in recs:
        if r.get(want_pt):
            return r
    raise AssertionError("no record with payload")


def test_gcm_one_vector():
    r = _first(rsp.load_gcm(256))
    taglen = int(r["Taglen"]) // 8
    key, iv = rsp.hexval(r, "Key"), rsp.hexval(r, "IV")
    aad, pt = rsp.hexval(r, "AAD"), rsp.hexval(r, "PT")
    blob = rsp.hexval(r, "CT") + rsp.hexval(r, "Tag")
    assert gcm_encrypt(key, iv, aad, pt, tag_len=taglen) == blob
    assert gcm_decrypt(key, iv, aad, blob, tag_len=taglen) == pt
    tampered = blob[:-1] + bytes([blob[-1] ^ 1])
    with pytest.raises(AuthenticationError):
        gcm_decrypt(key, iv, aad, tampered, tag_len=taglen)


def test_ccm_one_vector():
    r = _first(rsp.load_ccm(128), "Payload")
    nlen, tlen = int(r["Nlen"]), int(r["Tlen"])
    key, nonce = rsp.hexval(r, "Key"), rsp.hexval(r, "Nonce")
    aad, pt = rsp.hexval(r, "Adata"), rsp.hexval(r, "Payload")
    expect = rsp.hexval(r, "CT")
    assert ccm_encrypt(key, nonce, aad, pt,
                       nonce_len=nlen, tag_len=tlen) == expect
    assert ccm_decrypt(key, nonce, aad, expect,
                       nonce_len=nlen, tag_len=tlen) == pt


def test_xts_one_vector_each_shape():
    recs = rsp.load_xts(128)
    whole = next(r for r in recs if int(r["DataUnitLen"]) % 128 == 0)
    ragged = next(r for r in recs if int(r["DataUnitLen"]) % 8 != 0)
    for r in (whole, ragged):
        nbits = int(r["DataUnitLen"])
        key, tweak = rsp.hexval(r, "Key"), rsp.hexval(r, "i")
        pt, ct = rsp.hexval(r, "PT"), rsp.hexval(r, "CT")
        assert xts_encrypt(key, tweak, pt, bit_len=nbits) == ct
        assert xts_decrypt(key, tweak, ct, bit_len=nbits) == pt


def test_cmac_one_vector():
    r = _first(rsp.load_cmac(128), "Msg")
    mlen, tlen = int(r["Mlen"]), int(r["Tlen"])
    out = cmac(rsp.hexval(r, "Key"), rsp.hexval(r, "Msg")[:mlen])
    assert out[:tlen] == rsp.hexval(r, "Mac")


def test_gcm_siv_one_vector():
    r = _first(rsp.load_gcm_siv(), "pt")
    key, iv = rsp.hexval(r, "key"), rsp.hexval(r, "iv")
    aad, pt = rsp.hexval(r, "aad"), rsp.hexval(r, "pt")
    expect = rsp.hexval(r, "ct")
    assert gcm_siv_encrypt(key, iv, aad, pt) == expect
    assert gcm_siv_decrypt(key, iv, aad, expect) == pt


def test_eax_one_vector():
    r = _first(rsp.load_eax(), "MSG")
    key, nonce = rsp.hexval(r, "KEY"), rsp.hexval(r, "NONCE")
    aad, pt = rsp.hexval(r, "HEADER"), rsp.hexval(r, "MSG")
    expect = rsp.hexval(r, "CIPHER")
    assert eax_encrypt(key, nonce, aad, pt) == expect
    assert eax_decrypt(key, nonce, aad, expect) == pt


def test_ocb_one_vector_plus_failure():
    recs = rsp.load_ocb()
    ok = _first(recs, "Plaintext")
    key, nonce = rsp.hexval(ok, "Key"), rsp.hexval(ok, "IV")
    aad = rsp.hexval(ok, "AAD")
    pt, ct = rsp.hexval(ok, "Plaintext"), rsp.hexval(ok, "Ciphertext")
    tag = rsp.hexval(ok, "Tag")
    assert ocb_encrypt(key, nonce, aad, pt, tag_len=len(tag)) == ct + tag
    bad = next(r for r in recs if r.get("Result") == "CIPHERFINAL_ERROR")
    with pytest.raises(AuthenticationError):
        ocb_decrypt(rsp.hexval(bad, "Key"), rsp.hexval(bad, "IV"),
                    rsp.hexval(bad, "AAD"),
                    rsp.hexval(bad, "Ciphertext") + rsp.hexval(bad, "Tag"),
                    tag_len=len(rsp.hexval(bad, "Tag")))


def test_poly1305_one_vector():
    r = _first(rsp.load_poly1305(), "Msg")
    mlen = int(r["Mlen"])
    out = poly1305_aes(rsp.hexval(r, "Keys"), rsp.hexval(r, "Nonce"),
                       rsp.hexval(r, "Msg")[:mlen])
    assert out == rsp.hexval(r, "PolyMac")


def test_fpe_one_vector():
    recs = [r for r in rsp.load_fpe() if r.get("Method", "").upper() == "FF1"]
    r = recs[0]
    key = rsp.hexval(r, "Key")
    tweak = rsp.hexval(r, "Tweak")
    alphabet = r.get("Alphabet", "digits")
    assert fpe_encrypt(key, tweak, r["PT"], alphabet, "ff1") == r["CT"]
    assert fpe_decrypt(key, tweak, r["CT"], alphabet, "ff1") == r["PT"]
