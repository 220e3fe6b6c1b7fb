"""Device-side batched FPE (fpe/device.py) vs the host oracle + tv corpus.

The device engine re-designs the reference's radix bignum arithmetic
(micro_aes.c:2039-2088) as matmul-against-power-tables + one carry scan;
these tests pin bit-exactness against the host path (itself validated
against the reference tv corpus) and the corpus directly.
"""
import collections

import numpy as np
import pytest

from micro_aes.errors import DecryptionError, EncryptionError
from micro_aes.fpe import fpe_encrypt
from micro_aes.fpe.device import fpe_decrypt_batch, fpe_encrypt_batch
from micro_aes.testing import kat, rsp


def test_device_main_c_ff1():
    key, aad = kat.CIPHER_KEY[:16], kat.AAD
    out = fpe_encrypt_batch(key, aad, [kat.FPE_PLAIN], "digits", "ff1")
    assert out == [kat.FPE_FF1_CIPHER]
    back = fpe_decrypt_batch(key, aad, out, "digits", "ff1")
    assert back == [kat.FPE_PLAIN]


def test_device_main_c_ff3():
    key, tweak = kat.CIPHER_KEY[:16], kat.AAD[:7]
    pt = kat.FPE_PLAIN[:55]
    out = fpe_encrypt_batch(key, tweak, [pt], "digits", "ff3-1")
    assert out == [kat.FPE_FF3_CIPHER]
    assert fpe_decrypt_batch(key, tweak, out, "digits", "ff3-1") == [pt]


def test_device_tv_corpus(vector_corpus):
    """Every tv-corpus record through the batched device path, grouped
    by (method, key, tweak, alphabet) so each group is one dispatch."""
    recs = rsp.load_fpe()
    groups = collections.defaultdict(list)
    for r in recs:
        method = r["Method"].strip().lower()
        if method == "ff3":
            method = "ff3" if len(rsp.hexval(r, "Tweak")) == 8 else "ff3-1"
        groups[(method, rsp.hexval(r, "Key"), rsp.hexval(r, "Tweak"),
                r["Alphabet"])].append(r)
    total = 0
    for (method, key, tweak, alpha), rs in groups.items():
        got = fpe_encrypt_batch(key, tweak, [r["PT"] for r in rs],
                                alpha, method)
        back = fpe_decrypt_batch(key, tweak, [r["CT"] for r in rs],
                                 alpha, method)
        for g, b, r in zip(got, back, rs):
            assert g == r["CT"], f"{method}/{alpha} #{r['Count']}: {g}"
            assert b == r["PT"], f"{method}/{alpha} #{r['Count']}: {b}"
            total += 1
    assert total == len(recs)


@pytest.mark.parametrize("method", ["ff1", "ff3-1"])
def test_device_matches_host_fuzz(method):
    """Random keys/tweaks/lengths/radixes: device == host oracle."""
    rng = np.random.default_rng(7)
    alphas = ["digits", "lower", "alnum_lower", "base64"]
    for trial in range(8):
        alpha = alphas[trial % len(alphas)]
        key = bytes(rng.integers(0, 256, 16 if trial % 2 else 32,
                                 dtype=np.uint8))
        tlen = 7 if method == "ff3-1" else int(rng.integers(0, 20))
        tweak = bytes(rng.integers(0, 256, tlen, dtype=np.uint8))
        from micro_aes.fpe.alphabet import resolve_alphabet

        a = resolve_alphabet(alpha)
        lo = a.min_len
        hi = min(a.max_len_ff3(), lo + 24)
        toks = []
        for _ in range(5):
            n = int(rng.integers(lo, hi + 1))
            toks.append("".join(
                a.chars[i] for i in rng.integers(0, a.radix, n)))
        dev = fpe_encrypt_batch(key, tweak, toks, alpha, method)
        host = [fpe_encrypt(key, tweak, t, alpha, method) for t in toks]
        assert dev == host, (alpha, method, trial)
        rt = fpe_decrypt_batch(key, tweak, dev, alpha, method)
        assert rt == toks


@pytest.mark.parametrize("method", ["ff1", "ff3-1"])
def test_device_bitsliced_prf_matches(method, monkeypatch):
    """The bitsliced-PRF variant (opt-in via MICRO_AES_FPE_BITSLICE=1)
    must be bit-identical to the default gather-PRF path.  One
    fixed (radix, length) config keeps the CPU compile bounded."""
    monkeypatch.setenv("MICRO_AES_FPE_BITSLICE", "1")
    key = kat.CIPHER_KEY[:16]
    tweak = kat.AAD[:7]
    rng = np.random.default_rng(11)
    toks = ["".join("0123456789"[i] for i in rng.integers(0, 10, 16))
            for _ in range(40)]  # > 32: exercises the pad-to-32 branch
    got = fpe_encrypt_batch(key, tweak, toks, "digits", method)
    monkeypatch.delenv("MICRO_AES_FPE_BITSLICE")
    exp = fpe_encrypt_batch(key, tweak, toks, "digits", method)
    assert got == exp
    monkeypatch.setenv("MICRO_AES_FPE_BITSLICE", "1")
    assert fpe_decrypt_batch(key, tweak, got, "digits", method) == toks


def test_device_error_contract():
    key = kat.CIPHER_KEY[:16]
    with pytest.raises(EncryptionError):
        fpe_encrypt_batch(key, b"", ["123"], "digits", "ff1")  # too short
    with pytest.raises(EncryptionError):
        fpe_encrypt_batch(key, b"", ["123456x"], "digits", "ff1")  # bad char
    with pytest.raises(DecryptionError):
        fpe_decrypt_batch(key, b"", ["123"], "digits", "ff1")


def test_device_mixed_lengths_one_call():
    """Tokens of different lengths in one batch (grouped dispatch)."""
    key = kat.CIPHER_KEY[:16]
    toks = ["1234567890", "55554444333322221111", "314159265358979"]
    out = fpe_encrypt_batch(key, b"tweak", toks, "digits", "ff1")
    exp = [fpe_encrypt(key, b"tweak", t, "digits", "ff1") for t in toks]
    assert out == exp
    assert fpe_decrypt_batch(key, b"tweak", out, "digits", "ff1") == toks


def test_digit_array_api_matches_string_batch():
    """fpe_{en,de}crypt_digits (the zero-string bulk path) agree with the
    string batch API and round-trip, including a non-32-aligned batch."""
    from micro_aes.fpe.device import fpe_decrypt_digits, fpe_encrypt_digits

    key = kat.CIPHER_KEY[:16]
    tweak = b"\x01\x02"
    rng = np.random.default_rng(23)
    d = rng.integers(0, 10, (37, 16), dtype=np.uint8)
    toks = ["".join("0123456789"[v] for v in row) for row in d]
    ct = fpe_encrypt_digits(key, tweak, d, 10, "ff1")
    assert ct.dtype == np.uint8 and ct.shape == d.shape
    want = fpe_encrypt_batch(key, tweak, toks, "digits", "ff1")
    assert ["".join("0123456789"[v] for v in row) for row in ct] == want
    back = fpe_decrypt_digits(key, tweak, ct, 10, "ff1")
    assert np.array_equal(back, d)


def test_digit_array_api_validation():
    from micro_aes.fpe.device import fpe_encrypt_digits

    key = kat.CIPHER_KEY[:16]
    with pytest.raises(EncryptionError):
        fpe_encrypt_digits(key, b"", np.zeros(16, np.uint8), 10)  # not 2-D
    with pytest.raises(EncryptionError):
        fpe_encrypt_digits(key, b"", np.zeros((4, 16), np.uint8), 1000)


@pytest.mark.parametrize("method", ["ff1", "ff3-1"])
def test_chunked_dispatch_matches_unchunked(method, monkeypatch):
    """b > FPE_CHUNK routes through the lax.map chunked program
    (_map_chunks pad/slice glue); with FPE_CHUNK shrunk, a small
    non-multiple batch drives the same glue on CPU and must agree
    bit-exactly with the flat dispatch (ADVICE r4)."""
    from micro_aes.fpe import device as fdev

    rng = np.random.default_rng(11)
    key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    tweak = b"\x01\x02" if method == "ff1" else bytes(7)
    dmat = rng.integers(0, 10, (77, 16), dtype=np.uint8)  # not % 32
    flat = fdev.fpe_encrypt_digits(key, tweak, dmat, 10, method)
    monkeypatch.setattr(fdev, "FPE_CHUNK", 32)
    chunked = fdev.fpe_encrypt_digits(key, tweak, dmat, 10, method)
    np.testing.assert_array_equal(flat, chunked)
    back = fdev.fpe_decrypt_digits(key, tweak, chunked, 10, method)
    np.testing.assert_array_equal(back, dmat)
