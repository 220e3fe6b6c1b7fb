"""Core Rijndael correctness: FIPS-197 appendix C vectors + round-trips."""
import numpy as np
import jax.numpy as jnp

from micro_aes.core import (
    aes_cipher,
    decrypt_blocks,
    encrypt_blocks,
    expand_key,
)
from micro_aes.testing import kat
from micro_aes.utils.bytesio import from_blocks, to_blocks
import pytest

pytestmark = pytest.mark.quick


def _enc1(key: bytes, pt: bytes) -> bytes:
    rk = jnp.asarray(expand_key(key))
    return from_blocks(encrypt_blocks(rk, jnp.asarray(to_blocks(pt))), 16)


def _dec1(key: bytes, ct: bytes) -> bytes:
    rk = jnp.asarray(expand_key(key))
    return from_blocks(decrypt_blocks(rk, jnp.asarray(to_blocks(ct))), 16)


def test_fips197_known_answers():
    assert _enc1(kat.FIPS_KEY128, kat.FIPS_PT) == kat.FIPS_CT128
    assert _enc1(kat.FIPS_KEY192, kat.FIPS_PT) == kat.FIPS_CT192
    assert _enc1(kat.FIPS_KEY256, kat.FIPS_PT) == kat.FIPS_CT256


def test_fips197_decrypt():
    assert _dec1(kat.FIPS_KEY128, kat.FIPS_CT128) == kat.FIPS_PT
    assert _dec1(kat.FIPS_KEY192, kat.FIPS_CT192) == kat.FIPS_PT
    assert _dec1(kat.FIPS_KEY256, kat.FIPS_CT256) == kat.FIPS_PT


def test_batch_roundtrip_all_keysizes():
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, size=(257, 16), dtype=np.uint8)
    for klen in (16, 24, 32):
        key = bytes(rng.integers(0, 256, size=klen, dtype=np.uint8))
        rk = jnp.asarray(expand_key(key))
        ct = encrypt_blocks(rk, jnp.asarray(blocks))
        pt = decrypt_blocks(rk, ct)
        np.testing.assert_array_equal(np.asarray(pt), blocks)
        # batch results match block-at-a-time results
        one = encrypt_blocks(rk, jnp.asarray(blocks[7:8]))
        np.testing.assert_array_equal(np.asarray(ct)[7], np.asarray(one)[0])


def test_raw_cipher_api():
    # parity with AES_Cipher (micro_aes.c:343-347)
    assert aes_cipher(kat.FIPS_KEY128, "E", kat.FIPS_PT) == kat.FIPS_CT128
    assert aes_cipher(kat.FIPS_KEY128, "D", kat.FIPS_CT128) == kat.FIPS_PT


def test_key_schedule_shapes():
    assert expand_key(b"\0" * 16).shape == (11, 16)
    assert expand_key(b"\0" * 24).shape == (13, 16)
    assert expand_key(b"\0" * 32).shape == (15, 16)
    # First round key is the key itself (micro_aes.c:147)
    np.testing.assert_array_equal(
        expand_key(kat.FIPS_KEY128)[0], np.frombuffer(kat.FIPS_KEY128, np.uint8)
    )


def test_expand_keys_batch_matches_per_key():
    """The vectorized batch schedule (one recurrence over B keys) must
    equal the per-key expansion bit-for-bit for every key size, and the
    batched plane packing must equal per-key key_planes."""
    from micro_aes.core.bitslice import key_planes, key_planes_batch
    from micro_aes.core.keyschedule import expand_keys_batch

    rng = np.random.default_rng(41)
    for klen in (16, 24, 32):
        keys = rng.integers(0, 256, (37, klen), dtype=np.uint8)
        got = expand_keys_batch(keys)
        for i in range(keys.shape[0]):
            np.testing.assert_array_equal(
                got[i], expand_key(keys[i].tobytes()), err_msg=f"{klen}:{i}")
        kp = key_planes_batch(got)
        for i in (0, 17, 36):
            np.testing.assert_array_equal(
                kp[i], key_planes(got[i]).reshape(-1, 1))


def test_sbox_circuit_gate_counts():
    """Pin the S-box circuit sizes (every fused kernel's dominant cost):
    a regression here silently costs double-digit throughput.  Forward
    is the Boyar-Peralta netlist; the inverse is derived at import, so
    its count depends on the randomized Paar factoring (fixed seed)."""
    from micro_aes.core import bitslice as bs

    class G:
        xor = 0
        and_ = 0
        not_ = 0

        def __xor__(self, o):
            G.xor += 1
            return G()

        def __and__(self, o):
            G.and_ += 1
            return G()

        def __invert__(self):
            G.not_ += 1
            return G()

    for fwd, limit in ((True, 119), (False, 132)):
        G.xor = G.and_ = G.not_ = 0
        bs.sbox_planes([G() for _ in range(8)], fwd)
        total = G.xor + G.and_ + G.not_
        assert total <= limit, (fwd, total)
        assert G.and_ == 32  # the shared nonlinear middle is fixed
