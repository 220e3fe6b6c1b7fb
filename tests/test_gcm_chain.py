"""Value-chain multi-key GCM (parallel/batch.gcm_chain_sharded_fn: per
block G <- (G ^ C) * H, no per-key tables) on the virtual CPU mesh,
against the per-message GCM path: ragged whole-block lengths, AAD folded
in as the chain's initial value, AES-128 and AES-256, dp = 2 and 4."""
import jax.numpy as jnp
import numpy as np
import pytest

from micro_aes.modes.bulk import _enc_vmap, stack_round_keys
from micro_aes.modes.gcm import gcm_encrypt
from micro_aes.ops.mac import ghash_fold_batch
from micro_aes.parallel.batch import gcm_chain_sharded_fn
from micro_aes.parallel.mesh import make_mesh
from micro_aes.utils.bytesio import BLOCK


def _drive(dp: int, klen: int, ns: list[int], aad_lens: list[int],
           seed: int):
    rng = np.random.default_rng(seed)
    b, nb = len(ns), max(ns)
    keys = [rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
            for _ in range(b)]
    nonces = [rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
              for _ in range(b)]
    aads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in aad_lens]
    pts = [rng.integers(0, 256, BLOCK * n, dtype=np.uint8).tobytes()
           for n in ns]

    rksj = jnp.asarray(stack_round_keys(keys))
    zero_j0 = np.zeros((b, 2, BLOCK), np.uint8)
    for i in range(b):
        zero_j0[i, 1, :12] = np.frombuffer(nonces[i], np.uint8)
        zero_j0[i, 1, 15] = 1
    enc2 = np.asarray(_enc_vmap(rksj, jnp.asarray(zero_j0)))
    h, ej0 = enc2[:, 0], enc2[:, 1]
    c0 = zero_j0[:, 1].copy()
    c0[:, 15] = 2
    na = max(1, -(-max(aad_lens) // BLOCK))
    blocks = np.zeros((b, nb, BLOCK), np.uint8)
    aadb = np.zeros((b, na, BLOCK), np.uint8)
    nva = np.zeros(b, np.int32)
    lenb = np.zeros((b, BLOCK), np.uint8)
    for i in range(b):
        blocks[i, : ns[i]] = np.frombuffer(pts[i], np.uint8).reshape(
            ns[i], BLOCK)
        aadb[i].reshape(-1)[: len(aads[i])] = np.frombuffer(aads[i],
                                                            np.uint8)
        nva[i] = -(-len(aads[i]) // BLOCK)
        lenb[i, :8] = np.frombuffer((len(aads[i]) * 8).to_bytes(8, "big"),
                                    np.uint8)
        lenb[i, 8:] = np.frombuffer((ns[i] * BLOCK * 8).to_bytes(8, "big"),
                                    np.uint8)
    init = ghash_fold_batch(jnp.asarray(h), jnp.zeros((b, BLOCK), jnp.uint8),
                            jnp.asarray(aadb), jnp.asarray(nva))

    fn = gcm_chain_sharded_fn(make_mesh(dp, 1))
    out, tags = fn(rksj, jnp.asarray(h), jnp.asarray(ej0), jnp.asarray(c0),
                   init, jnp.asarray(blocks),
                   jnp.asarray(np.array(ns, np.int32)), jnp.asarray(lenb))
    out, tags = np.asarray(out), np.asarray(tags)
    for i in range(b):
        got = out[i, : ns[i]].tobytes() + tags[i].tobytes()
        assert got == gcm_encrypt(keys[i], nonces[i], aads[i], pts[i]), \
            f"value-chain GCM mismatch at tenant {i} (n={ns[i]})"


def test_gcm_chain_sharded_ragged_lengths():
    _drive(2, 16, [1, 7, 3, 12], [0, 5, 16, 33], seed=7)


@pytest.mark.parametrize("dp", [2, 4])
def test_gcm_chain_sharded_aad_classes(dp):
    _drive(dp, 16, [4, 4, 2, 9, 1, 6, 3, 5], [0, 1, 15, 16, 17, 31, 32, 70],
           seed=9 + dp)


def test_gcm_chain_sharded_aes256():
    _drive(2, 32, [5, 5, 8, 2], [12, 0, 40, 3], seed=11)
