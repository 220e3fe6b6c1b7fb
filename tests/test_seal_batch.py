"""Multi-key fused GCM (modes/seal_batch + ops/stream's multi-key engine)
vs the per-message conformance-validated path."""
import jax.numpy as jnp
import numpy as np

from micro_aes.modes.gcm import gcm_encrypt
from micro_aes.modes.seal_batch import gcm_open_batch, gcm_seal_batch


def test_seal_batch_mixed_lengths_and_aad():
    rng = np.random.default_rng(0)
    B = 6
    keys = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)) for _ in range(B)]
    nonces = [bytes(rng.integers(0, 256, 12, dtype=np.uint8))
              for _ in range(B)]
    aads = [b"", b"x", b"0123456789abcdef", b"hdr" * 30, b"a" * 16,
            b"\x00" * 33]
    pts = [bytes(rng.integers(0, 256, 16 * n, dtype=np.uint8))
           for n in (1, 7, 32, 100, 33, 64)]
    got = gcm_seal_batch(keys, nonces, aads, pts)
    for i in range(B):
        assert got[i] == gcm_encrypt(keys[i], nonces[i], aads[i], pts[i]), i


def test_seal_batch_aes256_and_192():
    rng = np.random.default_rng(1)
    for klen in (24, 32):
        keys = [bytes(rng.integers(0, 256, klen, dtype=np.uint8))
                for _ in range(3)]
        nonces = [bytes(rng.integers(0, 256, 12, dtype=np.uint8))
                  for _ in range(3)]
        pts = [bytes(rng.integers(0, 256, 16 * n, dtype=np.uint8))
               for n in (5, 40, 12)]
        got = gcm_seal_batch(keys, nonces, [b""] * 3, pts)
        for i in range(3):
            assert got[i] == gcm_encrypt(keys[i], nonces[i], b"", pts[i]), \
                (klen, i)


def test_open_batch_verify_before_release():
    rng = np.random.default_rng(2)
    B = 4
    keys = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)) for _ in range(B)]
    nonces = [bytes(rng.integers(0, 256, 12, dtype=np.uint8))
              for _ in range(B)]
    aads = [b"h"] * B
    pts = [bytes(rng.integers(0, 256, 16 * 20, dtype=np.uint8))
           for _ in range(B)]
    sealed = gcm_seal_batch(keys, nonces, aads, pts)
    assert gcm_open_batch(keys, nonces, aads, sealed) == pts
    bad = list(sealed)
    bad[1] = bad[1][:-1] + bytes([bad[1][-1] ^ 1])   # tag bit flip
    bad[3] = bytes([bad[3][0] ^ 1]) + bad[3][1:]     # ct bit flip
    out = gcm_open_batch(keys, nonces, aads, bad)
    assert out[0] == pts[0] and out[2] == pts[2]
    assert out[1] is None and out[3] is None


def test_seal_batch_fallback_paths():
    """Non-12-byte nonce and ragged length route to the general batch
    engine and still match the per-message path."""
    rng = np.random.default_rng(3)
    keys = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
            for _ in range(2)]
    nonces = [bytes(rng.integers(0, 256, 8, dtype=np.uint8)),
              bytes(rng.integers(0, 256, 12, dtype=np.uint8))]
    pts = [bytes(rng.integers(0, 256, 100, dtype=np.uint8)),
           bytes(rng.integers(0, 256, 160, dtype=np.uint8))]
    got = gcm_seal_batch(keys, nonces, [b"", b""], pts)
    for i in range(2):
        assert got[i] == gcm_encrypt(keys[i], nonces[i], b"", pts[i]), i


def test_multikey_engine_matches_per_key():
    """ctrw_fused_multikey_jnp (B windows, B keys, one program) equals
    the single-key engine run on each window with its own key, both
    directions."""
    from micro_aes.core.bitslice import key_planes
    from micro_aes.core.keyschedule import expand_key
    from micro_aes.ops.stream import ctrw_fused_jnp, ctrw_fused_multikey_jnp

    rng = np.random.default_rng(4)
    b, wm = 3, 16
    kps = [jnp.asarray(key_planes(expand_key(
        bytes(rng.integers(0, 256, 16, dtype=np.uint8))))) for _ in range(b)]
    ctrw = jnp.asarray(rng.integers(0, 2**32, (b * wm, 128),
                                    dtype=np.uint32))
    ptw = jnp.asarray(rng.integers(0, 2**32, (b * wm, 128),
                                   dtype=np.uint32))
    for dec in (False, True):
        stack = jnp.concatenate([kp.reshape(-1, 1) for kp in kps])
        got = np.asarray(ctrw_fused_multikey_jnp(stack, ctrw, ptw, b,
                                                 decrypt=dec))
        for i in range(b):
            rows = slice(i * wm, (i + 1) * wm)
            want = np.asarray(ctrw_fused_jnp(kps[i].reshape(-1, 1),
                                             ctrw[rows], ptw[rows],
                                             decrypt=dec))
            assert np.array_equal(got[rows], want), (dec, i)


def test_seal_batch_edge_cases():
    """Empty batch, empty plaintext (AAD-only), and fully empty message."""
    keys, nonces = [bytes(range(16))], [bytes(12)]
    assert gcm_seal_batch([], [], [], []) == []
    assert gcm_open_batch([], [], [], []) == []
    out = gcm_seal_batch(keys, nonces, [b"header-only"], [b""])
    assert out[0] == gcm_encrypt(keys[0], nonces[0], b"header-only", b"")
    assert gcm_open_batch(keys, nonces, [b"header-only"], out) == [b""]
    out2 = gcm_seal_batch(keys, nonces, [b""], [b""])
    assert out2[0] == gcm_encrypt(keys[0], nonces[0], b"", b"")


def test_window_and_tile_contract():
    """The per-message window is the block count in 32-block rows,
    rounded up to a multiple of 8 rows and no further: a 513-row window
    (256 KiB message) must not balloon to a power of two."""
    from micro_aes.ops.stream import mk_window_words

    for need in (1, 31, 32, 33, 255, 256, 1024, 1027, 16384, 16387,
                 17149, 536 * 32):
        wm = mk_window_words(need)
        assert wm % 8 == 0 and 32 * wm >= need
        assert wm - (-(-need // 32)) < 8
    assert mk_window_words(16387) == 520
    assert mk_window_words(536 * 32) == 536


def test_warm_tables_match_cold_and_purge():
    """reuse_tables=True (memoized per-key-set GHASH tables) must be
    bit-identical to the cold in-dispatch derivation,
    hit its cache on the second call, and register with the purge
    audit surface."""
    from micro_aes.modes.seal_batch import (
        _tables_cached,
        gcm_open_batch,
        gcm_seal_batch,
    )
    from micro_aes.utils.keycache import registered_key_caches

    rng = np.random.default_rng(57)
    B = 32
    keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            for _ in range(B)]
    nonces = [rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
              for _ in range(B)]
    aads = [b"hdr"] * B
    pts = [rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
           for _ in range(B)]
    cold = gcm_seal_batch(keys, nonces, aads, pts)
    _tables_cached.cache_clear()
    warm = gcm_seal_batch(keys, nonces, aads, pts, reuse_tables=True)
    assert warm == cold
    info0 = _tables_cached.cache_info()
    warm2 = gcm_seal_batch(keys, nonces, aads, pts, reuse_tables=True)
    assert warm2 == cold
    assert _tables_cached.cache_info().hits == info0.hits + 1
    opened = gcm_open_batch(keys, nonces, aads, warm, reuse_tables=True)
    assert opened == pts
    assert _tables_cached in registered_key_caches()
    _tables_cached.cache_clear()
