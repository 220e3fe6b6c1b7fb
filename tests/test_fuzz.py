"""Randomized differential fuzzing: round-trips and cross-implementation
agreement on edge lengths/parameters the official vectors don't cover."""
import numpy as np
import pytest

import micro_aes as aes
from micro_aes import native
from micro_aes.modes.bulk import gcm_encrypt_batch

RNG = np.random.default_rng(0xAE5)


def _rand(n):
    return bytes(RNG.integers(0, 256, n, dtype=np.uint8))


@pytest.mark.parametrize("klen", [16, 24, 32])
def test_roundtrip_all_modes_ragged_lengths(klen):
    key = _rand(klen)
    keypair = _rand(2 * klen)
    iv = _rand(16)
    for n in (16, 17, 31, 33, 48, 57, 64, 255):
        pt = _rand(n)
        assert aes.cbc_decrypt(key, iv, aes.cbc_encrypt(key, iv, pt)) == pt
        assert aes.cfb_decrypt(key, iv, aes.cfb_encrypt(key, iv, pt)) == pt
        assert aes.ofb_decrypt(key, iv, aes.ofb_encrypt(key, iv, pt)) == pt
        assert aes.ctr_decrypt(key, iv, aes.ctr_encrypt(key, iv, pt)) == pt
        assert aes.xts_decrypt(keypair, iv, aes.xts_encrypt(keypair, iv, pt)) == pt


@pytest.mark.parametrize("nonce_len", [1, 8, 12, 16, 60])
def test_gcm_arbitrary_nonce_lengths(nonce_len):
    key, nonce = _rand(16), _rand(nonce_len)
    aad, pt = _rand(7), _rand(33)
    out = aes.gcm_encrypt(key, nonce, aad, pt)
    assert aes.gcm_decrypt(key, nonce, aad, out) == pt
    # batch path agrees with the scalar path for every nonce length
    assert gcm_encrypt_batch([key], [nonce], [aad], [pt])[0] == out


@pytest.mark.parametrize("nlen,tlen", [(7, 4), (9, 8), (11, 16), (13, 10)])
def test_ccm_parameter_matrix(nlen, tlen):
    key, nonce = _rand(16), _rand(nlen)
    aad, pt = _rand(70000), _rand(40)  # aad > 0xFEFF hits the FFFE encoding
    out = aes.ccm_encrypt(key, nonce, aad, pt, nonce_len=nlen, tag_len=tlen)
    assert aes.ccm_decrypt(key, nonce, aad, out, nonce_len=nlen,
                           tag_len=tlen) == pt


@pytest.mark.parametrize("nonce_len,tag_len", [(1, 16), (12, 12), (15, 8)])
def test_ocb_parameter_matrix(nonce_len, tag_len):
    key = _rand(16)
    nonce, aad, pt = _rand(nonce_len), _rand(21), _rand(47)
    out = aes.ocb_encrypt(key, nonce, aad, pt, tag_len=tag_len)
    assert aes.ocb_decrypt(key, nonce, aad, out, tag_len=tag_len) == pt


def test_siv_gcm_siv_eax_roundtrips():
    for klen in (16, 32):
        keypair = _rand(2 * klen)
        key = _rand(klen)
        for n in (0, 1, 15, 16, 17, 100):
            pt, aad = _rand(n), _rand(n // 2)
            iv, ct = aes.siv_encrypt(keypair, aad, pt)
            assert aes.siv_decrypt(keypair, iv, aad, ct) == pt
            nonce12 = _rand(12)
            out = aes.gcm_siv_encrypt(key, nonce12, aad, pt)
            assert aes.gcm_siv_decrypt(key, nonce12, aad, out) == pt
            nonce = _rand(16)
            out = aes.eax_encrypt(key, nonce, aad, pt)
            assert aes.eax_decrypt(key, nonce, aad, out) == pt


def test_kw_various_sizes():
    for nbytes in (16, 24, 32, 40, 64):
        kek, secret = _rand(16), _rand(nbytes)
        assert aes.key_unwrap(kek, aes.key_wrap(kek, secret)) == secret


def test_cmac_poly1305_against_structure():
    key = _rand(16)
    # CMAC distributivity sanity: different messages -> different macs
    macs = {aes.cmac(key, _rand(n)) for n in (0, 1, 16, 17, 32, 100)}
    assert len(macs) == 6
    keys = _rand(32)
    m1 = aes.poly1305_aes(keys, _rand(16), _rand(63))
    m2 = aes.poly1305_aes(keys, _rand(16), _rand(63))
    assert m1 != m2


def test_cross_impl_cipher_fuzz():
    """C++ oracle, jnp table path and bitsliced path agree on random data."""
    import jax.numpy as jnp

    from micro_aes.core.bitslice import encrypt_blocks_bitsliced, key_planes
    from micro_aes.core.cipher import encrypt_blocks
    from micro_aes.core.keyschedule import expand_key

    for _ in range(3):
        klen = [16, 24, 32][int(RNG.integers(0, 3))]
        key = _rand(klen)
        blocks = RNG.integers(0, 256, (96, 16), dtype=np.uint8)
        a = native.oracle_encrypt(key, blocks)
        b = np.asarray(encrypt_blocks(jnp.asarray(expand_key(key)),
                                      jnp.asarray(blocks)))
        c = np.asarray(encrypt_blocks_bitsliced(
            jnp.asarray(key_planes(expand_key(key))), jnp.asarray(blocks)))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_fpe_roundtrip_alphabets():
    from micro_aes.fpe import ALPHABETS, fpe_decrypt, fpe_encrypt

    key = _rand(16)
    for name in ("digits", "lower", "base64", "printable", "greek"):
        alpha = ALPHABETS[name]
        n = max(alpha.min_len, 10)
        pt = "".join(alpha.chars[i] for i in
                     RNG.integers(0, alpha.radix, n))
        for method in ("ff1", "ff3-1"):
            tweak = _rand(7) if method == "ff3-1" else _rand(11)
            ct = fpe_encrypt(key, tweak, pt, alpha, method)
            assert ct != pt or n < 6
            assert fpe_decrypt(key, tweak, ct, alpha, method) == pt
