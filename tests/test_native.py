"""Differential tests: independent C++ oracle vs the JAX engines."""
import numpy as np
import jax.numpy as jnp
import pytest

from micro_aes.core.bitslice import encrypt_blocks_bitsliced, key_planes
from micro_aes.core.cipher import encrypt_blocks
from micro_aes.core.keyschedule import expand_key
from micro_aes import native
from micro_aes.testing import kat

pytestmark = pytest.mark.quick


def test_native_available():
    assert native.available(), "g++ toolchain expected in this environment"


@pytest.mark.parametrize("klen", [16, 24, 32])
def test_oracle_differential(klen):
    rng = np.random.default_rng(klen)
    key = bytes(rng.integers(0, 256, klen, dtype=np.uint8))
    blocks = rng.integers(0, 256, (128, 16), dtype=np.uint8)
    cpp = native.oracle_encrypt(key, blocks)
    rk = jnp.asarray(expand_key(key))
    jx = np.asarray(encrypt_blocks(rk, jnp.asarray(blocks)))
    bs = np.asarray(encrypt_blocks_bitsliced(
        jnp.asarray(key_planes(expand_key(key))), jnp.asarray(blocks)))
    np.testing.assert_array_equal(cpp, jx)
    np.testing.assert_array_equal(cpp, bs)
    np.testing.assert_array_equal(native.oracle_decrypt(key, cpp), blocks)


def test_oracle_fips():
    out = native.oracle_encrypt(
        kat.FIPS_KEY256, np.frombuffer(kat.FIPS_PT, np.uint8).reshape(1, 16))
    assert bytes(out[0]) == kat.FIPS_CT256


def test_native_hex_decode():
    assert native.hex_decode("8EA2B7 CA51 zz 67") == bytes.fromhex("8ea2b7ca5167")
