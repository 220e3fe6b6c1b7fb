"""Fused seal/open engine coverage on the CPU:

* the XLA engine (seal_fused_jnp) drives the full fused orchestration —
  trailing-pad compensation, AAD shift, open direction;
* the GPU keystream kernel's path through the seal (kernel output +
  XLA GHASH of the ciphertext words) runs with the kernel in interpret
  mode and must equal the XLA engine bit-for-bit;
* the *sharded* fused engine (gcm_sharded_fused_fn) runs on the
  8-virtual-device mesh, both directions, with and without AAD.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from micro_aes.modes.gcm import gcm_decrypt, gcm_encrypt
from micro_aes.modes.seal import gcm_key_setup, gcm_open, gcm_seal
from micro_aes.modes.common import enc_blocks_np
from micro_aes.errors import AuthenticationError
from micro_aes.parallel.mesh import make_mesh
from micro_aes.parallel.sharded import (
    gcm_sharded_fused_fn,
    shard_adjust_matrices_fused,
    sharded_aad_args,
)
from micro_aes.utils.bytesio import BLOCK


def _j0(nonce: bytes) -> np.ndarray:
    j = np.zeros(BLOCK, np.uint8)
    j[:12] = np.frombuffer(nonce, np.uint8)
    j[15] = 1
    return j


class TestFusedOrchestration:
    """gcm_seal/gcm_open now run the fused path on every backend."""

    KEY = bytes(range(32))
    NONCE = bytes(range(12))

    @pytest.mark.parametrize("nblocks", [1, 33, 257])
    def test_seal_matches_host_gcm(self, nblocks):
        rng = np.random.default_rng(nblocks)
        pt = rng.integers(0, 256, nblocks * BLOCK, dtype=np.uint8).tobytes()
        assert gcm_seal(self.KEY, self.NONCE, pt) == \
            gcm_encrypt(self.KEY, self.NONCE, b"", pt)

    @pytest.mark.parametrize("alen", [1, 16, 100])
    def test_seal_with_aad_matches_host_gcm(self, alen):
        rng = np.random.default_rng(alen)
        pt = rng.integers(0, 256, 48 * BLOCK, dtype=np.uint8).tobytes()
        aad = rng.integers(0, 256, alen, dtype=np.uint8).tobytes()
        assert gcm_seal(self.KEY, self.NONCE, pt, aad=aad) == \
            gcm_encrypt(self.KEY, self.NONCE, aad, pt)

    def test_open_roundtrip_and_reject(self):
        rng = np.random.default_rng(5)
        pt = rng.integers(0, 256, 64 * BLOCK, dtype=np.uint8).tobytes()
        blob = gcm_seal(self.KEY, self.NONCE, pt, aad=b"hdr")
        assert gcm_open(self.KEY, self.NONCE, blob, aad=b"hdr") == pt
        bad = blob[:-1] + bytes([blob[-1] ^ 1])
        with pytest.raises(AuthenticationError):
            gcm_open(self.KEY, self.NONCE, bad, aad=b"hdr")
        with pytest.raises(AuthenticationError):
            gcm_open(self.KEY, self.NONCE, blob, aad=b"other")

    def test_open_matches_host_decrypt(self):
        rng = np.random.default_rng(6)
        pt = rng.integers(0, 256, 33 * BLOCK, dtype=np.uint8).tobytes()
        blob = gcm_encrypt(self.KEY, self.NONCE, b"", pt)
        assert gcm_open(self.KEY, self.NONCE, blob) == pt
        assert gcm_decrypt(self.KEY, self.NONCE, b"", blob) == pt


@pytest.mark.parametrize("dp,sp", [(2, 4), (1, 8)])
@pytest.mark.parametrize("use_aad", [False, True])
def test_sharded_fused_seal_and_open(dp, sp, use_aad):
    """The fused sharded engine (the code path a device mesh runs) on the
    virtual mesh: seal must equal the host reference, open must invert."""
    assert len(jax.devices()) >= 8
    mesh = make_mesh(dp, sp)
    rng = np.random.default_rng(11 + dp)
    key = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    kp, tables = gcm_key_setup(key, chunk=32, chunk2=2)
    n_blocks = sp * 32  # 32 blocks per shard (minimum 32-aligned)
    b = dp * 2
    aad = b"sharded-aad-bytes!" if use_aad else b""
    nonces = [bytes(rng.integers(0, 256, 12, dtype=np.uint8)) for _ in range(b)]
    pts = rng.integers(0, 256, (b, n_blocks, BLOCK), dtype=np.uint8)

    j0 = np.stack([_j0(n) for n in nonces])
    ek_j0 = enc_blocks_np(key, j0)
    adj = shard_adjust_matrices_fused(tables[3], n_blocks // sp, sp, chunk2=2)
    aad_acc, aad_shift_t, alen = sharded_aad_args(key, aad, n_blocks, b)

    seal = gcm_sharded_fused_fn(mesh, n_blocks, aad_bytes=alen)
    ct, tag = seal(kp, tables, adj, jnp.asarray(j0), jnp.asarray(ek_j0),
                   jnp.asarray(pts), aad_acc, aad_shift_t)
    ct, tag = np.asarray(ct), np.asarray(tag)

    for i in range(b):
        expect = gcm_encrypt(key, nonces[i], aad, bytes(pts[i].reshape(-1)))
        got = bytes(ct[i].reshape(-1)) + bytes(tag[i])
        assert got == expect, f"sharded seal msg {i} mismatch ({dp},{sp})"

    # open direction: decrypt the ciphertext, recompute the tag over it
    opener = gcm_sharded_fused_fn(mesh, n_blocks, aad_bytes=alen,
                                  open_direction=True)
    pt2, tag2 = opener(kp, tables, adj, jnp.asarray(j0), jnp.asarray(ek_j0),
                       jnp.asarray(ct), aad_acc, aad_shift_t)
    assert np.array_equal(np.asarray(pt2), pts)
    assert np.array_equal(np.asarray(tag2), tag)


def test_xex_matches_doubling_oracle():
    """xex_fused_jnp (XTS body with the alpha^jj offsets expanded from
    one base per stream row) vs a per-block doubling oracle, both
    directions."""
    from micro_aes.core.bitslice import key_planes
    from micro_aes.core.cipher import decrypt_blocks, encrypt_blocks
    from micro_aes.core.keyschedule import expand_key
    from micro_aes.ops.gf128 import double_le
    from micro_aes.ops.stream import (
        bytes_to_stream,
        stream_to_bytes,
        xex_fused_jnp,
    )

    rng = np.random.default_rng(3)
    key = bytes(range(16))
    rk = jnp.asarray(expand_key(key))
    kp = jnp.asarray(key_planes(expand_key(key)).reshape(-1, 1))
    w, n = 8, 8 * 32
    bases = rng.integers(0, 256, (w, 16), dtype=np.uint8)
    data = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    offs = np.zeros((n, 16), np.uint8)
    for row in range(w):
        t = jnp.asarray(bases[row])
        for jj in range(32):
            offs[32 * row + jj] = np.asarray(t)
            t = double_le(t)
    basew = jnp.asarray(np.broadcast_to(
        bases.view(np.uint32)[:, None, :], (w, 32, 4)).reshape(w, 128).copy())
    ptw = bytes_to_stream(jnp.asarray(data), 0, w)
    for dec, cipher in ((False, encrypt_blocks), (True, decrypt_blocks)):
        expect = np.asarray(cipher(rk, jnp.asarray(data ^ offs))) ^ offs
        got = np.asarray(stream_to_bytes(
            xex_fused_jnp(kp, basew, ptw, decrypt=dec), 0, n))
        assert np.array_equal(got, expect), f"decrypt={dec}"


@pytest.mark.quick
def test_ghash1_stream_bits_match_planes():
    """The level-1 GHASH/POLYVAL partials from direct word-to-bit
    expansion (ghash1_fused_jnp, the path after the GPU kernel) equal
    the ones folded from bit planes (seal_fused_jnp's own path)."""
    from micro_aes.core.bitslice import words_to_planes
    from micro_aes.ops.ghash_bulk import planes_to_bits_i8
    from micro_aes.ops.stream import (
        _ghash_level1,
        _stream_to_kwords,
        ghash1_fused_jnp,
        stream_bits_i8,
    )

    rng = np.random.default_rng(4)
    _, tables = gcm_key_setup(bytes(range(32)))
    w1t = jnp.transpose(tables[0]).astype(jnp.int8)
    w = 24
    ghm = jnp.asarray(rng.integers(0, 2**32, (1, w), dtype=np.uint32))
    ptw = jnp.asarray(rng.integers(0, 2**32, (w, 128), dtype=np.uint32))
    planes = words_to_planes(_stream_to_kwords(ptw))
    assert np.array_equal(np.asarray(stream_bits_i8(ptw)),
                          np.asarray(planes_to_bits_i8(planes)))
    assert np.array_equal(
        np.asarray(ghash1_fused_jnp(ghm, w1t, ptw)),
        np.asarray(_ghash_level1(planes_to_bits_i8(planes), ghm, w1t)))


@pytest.mark.parametrize("open_direction", [False, True])
def test_ctr_kernel_interpret_matches_jnp_twin(open_direction, monkeypatch):
    """The seal through the keystream kernel (interpret mode) equals the
    XLA engine: out words, E(J0) and the level-1..2 GHASH partial, for
    seal and open, on a ragged stream width (the wrapper pads to the
    kernel tile) with a 24-bit counter extension."""
    import functools

    from micro_aes.modes.seal import fused_seal_stream, seal_stream_words
    from micro_aes.ops import ctr_kernel

    key = bytes(range(32))
    kp, tables = gcm_key_setup(key)
    n = 40 * 32 - 2
    w = seal_stream_words(n)
    assert w % ctr_kernel.TILE
    rng = np.random.default_rng(6)
    j0 = rng.integers(0, 256, 16, dtype=np.uint8)
    j0[12:] = (0, 0, 0, 1)
    ptw = jnp.asarray(rng.integers(0, 2**32, (w, 128), dtype=np.uint32))
    monkeypatch.setattr(ctr_kernel, "ctr_fused_kernel", functools.partial(
        ctr_kernel.ctr_fused_kernel, interpret=True))
    got = fused_seal_stream(kp, tables, jnp.asarray(j0), ptw, n,
                            open_direction, kernel=True)
    want = fused_seal_stream(kp, tables, jnp.asarray(j0), ptw, n,
                             open_direction, kernel=False)
    for g, x in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(x))
