"""parallel/multihost helpers exercised on the virtual 8-device mesh."""
import jax
import jax.numpy as jnp
import numpy as np

from micro_aes.modes.common import enc_blocks_np
from micro_aes.modes.gcm import gcm_encrypt
from micro_aes.modes.seal import gcm_key_setup
from micro_aes.parallel.multihost import (
    global_mesh,
    host_local_batch,
    init_distributed,
)
from micro_aes.parallel.sharded import (
    gcm_sharded_fused_fn,
    shard_adjust_matrices_fused,
    sharded_aad_args,
)
from micro_aes.utils.bytesio import BLOCK


def test_init_distributed_is_idempotent_single_process():
    # single-process: either initializes trivially or no-ops; never raises
    init_distributed()
    init_distributed()


def test_global_mesh_default_factorization():
    mesh = global_mesh()
    assert set(mesh.shape.keys()) == {"dp", "sp"}
    assert mesh.shape["dp"] * mesh.shape["sp"] <= len(jax.devices())
    # explicit factorization
    mesh2 = global_mesh(2, 4)
    assert mesh2.shape["dp"] == 2 and mesh2.shape["sp"] == 4


def test_host_local_batch_feeds_sharded_seal():
    """End-to-end: per-host local IO assembled via host_local_batch,
    fed through the fused sharded GCM seal, checked against the host
    reference path (single-process: local data == global data)."""
    mesh = global_mesh(2, 4)
    rng = np.random.default_rng(21)
    key = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    kp, tables = gcm_key_setup(key, chunk=32, chunk2=2)
    sp = mesh.shape["sp"]
    n_blocks = sp * 32
    b = 2
    nonces = [bytes(rng.integers(0, 256, 12, dtype=np.uint8)) for _ in range(b)]
    pts = rng.integers(0, 256, (b, n_blocks, BLOCK), dtype=np.uint8)

    pts_global = host_local_batch(mesh, pts)  # dp-sharded global array
    assert pts_global.shape == pts.shape

    j0 = np.zeros((b, BLOCK), np.uint8)
    for i, nc in enumerate(nonces):
        j0[i, :12] = np.frombuffer(nc, np.uint8)
        j0[i, 15] = 1
    ek_j0 = enc_blocks_np(key, j0)
    adj = shard_adjust_matrices_fused(tables[3], n_blocks // sp, sp, chunk2=2)
    aad_acc, aad_shift_t, alen = sharded_aad_args(key, b"", n_blocks, b)

    seal = gcm_sharded_fused_fn(mesh, n_blocks)
    ct, tag = seal(kp, tables, adj, jnp.asarray(j0), jnp.asarray(ek_j0),
                   pts_global, aad_acc, aad_shift_t)
    ct, tag = np.asarray(ct), np.asarray(tag)
    for i in range(b):
        expect = gcm_encrypt(key, nonces[i], b"", bytes(pts[i].reshape(-1)))
        assert bytes(ct[i].reshape(-1)) + bytes(tag[i]) == expect
