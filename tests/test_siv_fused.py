"""Fused-SIV batch engine (parallel/batch.siv_sharded_fn: masked CMAC fold
with the S2V last-block constants + SIV-CTR, one program per shard) on
the virtual CPU mesh against the per-message RFC 5297 path, and the
batch API's open with decrypt-then-verify failure isolation
(micro_aes.c:1404-1408).

The S2V last-block algebra the engine receives as constants
(micro_aes.c:1336-1356): whole-block finals (y ^ D), ragged finals with
the xorend straddle onto the previous block, and sub-block messages
(dbl(y) ^ pad ^ D)."""
import jax.numpy as jnp
import numpy as np
import pytest

# lengths exercising every S2V final-block branch: sub-block (incl. the
# 0x80-at-0 empty pad), exact blocks, ragged with straddle, multi-block
_LENS = [0, 1, 5, 15, 16, 17, 31, 32, 33, 47, 48, 100]


@pytest.mark.parametrize("keybytes", [32, 64])
def test_siv_fused_seal_vs_single(keybytes):
    from micro_aes.modes.bulk import (
        _eax_subkeys,
        _s2v_y,
        _siv_s2v_consts,
        stack_round_keys,
    )
    from micro_aes.modes.siv import siv_encrypt
    from micro_aes.parallel.batch import siv_sharded_fn
    from micro_aes.parallel.mesh import make_mesh

    rng = np.random.default_rng(17 + keybytes)
    keys = [rng.integers(0, 256, keybytes, dtype=np.uint8).tobytes()
            for _ in _LENS]
    aads = [rng.integers(0, 256, (7 * n) % 37, dtype=np.uint8).tobytes()
            for n in _LENS]
    pts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in _LENS]
    half = keybytes // 2
    rks1 = jnp.asarray(stack_round_keys([k[:half] for k in keys]))
    rks2 = jnp.asarray(stack_round_keys([k[half:] for k in keys]))
    b = len(_LENS)
    y = _s2v_y(rks1, [np.frombuffer(a, np.uint8) for a in aads])
    d, q = _eax_subkeys(rks1, b)
    tail, lastadd, prevadd, nv = _siv_s2v_consts(d, q, y, _LENS)
    blocks = np.zeros((b, int(nv.max()), 16), np.uint8)
    for i, p in enumerate(pts):
        blocks[i].reshape(-1)[: len(p)] = np.frombuffer(p, np.uint8)

    fn = siv_sharded_fn(make_mesh(2, 1))
    ct, iv = fn(rks1, rks2, jnp.zeros((b, 16), jnp.uint8),
                jnp.asarray(blocks), jnp.asarray(nv), jnp.asarray(tail),
                jnp.asarray(lastadd), jnp.asarray(prevadd))
    ct, iv = np.asarray(ct), np.asarray(iv)
    for i, n in enumerate(_LENS):
        got = (bytes(iv[i]), ct[i].reshape(-1)[:n].tobytes())
        assert got == siv_encrypt(keys[i], aads[i], pts[i]), \
            f"fused SIV seal mismatch at len={n}"


def test_siv_fused_open_roundtrip_and_tamper():
    from micro_aes.modes.bulk import siv_decrypt_batch, siv_encrypt_batch

    rng = np.random.default_rng(23)
    keys = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
            for _ in _LENS]
    aads = [rng.integers(0, 256, n % 19, dtype=np.uint8).tobytes()
            for n in _LENS]
    pts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in _LENS]
    outs = siv_encrypt_batch(keys, aads, pts)
    ivs = [iv for iv, _ in outs]
    cts = [ct for _, ct in outs]
    assert siv_decrypt_batch(keys, ivs, aads, cts) == pts
    bad = list(ivs)
    bad[4] = bytes([bad[4][0] ^ 1]) + bad[4][1:]
    backs = siv_decrypt_batch(keys, bad, aads, cts)
    for i in range(len(_LENS)):
        assert backs[i] == (None if i == 4 else pts[i])
