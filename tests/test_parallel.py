"""Sharded bulk GCM on the 8-virtual-device CPU mesh: must equal the
conformance-validated single-device path bit-for-bit."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from micro_aes.modes.gcm import gcm_encrypt
from micro_aes.modes.seal import gcm_key_setup, gcm_seal
from micro_aes.modes.common import enc_blocks_np
from micro_aes.parallel.mesh import make_mesh
from micro_aes.parallel.sharded import gcm_seal_sharded_fn, shard_adjust_matrices
from micro_aes.utils.bytesio import BLOCK


def _j0(nonce: bytes) -> np.ndarray:
    j = np.zeros(BLOCK, np.uint8)
    j[:12] = np.frombuffer(nonce, np.uint8)
    j[15] = 1
    return j


@pytest.mark.parametrize("dp,sp", [(2, 4), (1, 8), (4, 2)])
def test_gcm_sharded_matches_reference_path(dp, sp):
    assert len(jax.devices()) >= 8
    mesh = make_mesh(dp, sp)
    rng = np.random.default_rng(7)
    key = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    # tiny GHASH tiles so each shard's length is divisible: chunk=chunk2=2
    kp, tables = gcm_key_setup(key, chunk=32, chunk2=2)
    n_blocks = sp * 64  # 64 blocks per shard (32-aligned, tile=64)
    b = dp * 2
    nonces = [bytes(rng.integers(0, 256, 12, dtype=np.uint8)) for _ in range(b)]
    pts = rng.integers(0, 256, (b, n_blocks, BLOCK), dtype=np.uint8)

    j0 = np.stack([_j0(n) for n in nonces])
    ek_j0 = enc_blocks_np(key, j0)
    m_h = tables[3]
    adj = shard_adjust_matrices(m_h, n_blocks // sp, sp)
    fn = gcm_seal_sharded_fn(mesh, n_blocks)
    ct, tag = fn(kp, tables, adj, jnp.asarray(j0), jnp.asarray(ek_j0),
                 jnp.asarray(pts))
    ct, tag = np.asarray(ct), np.asarray(tag)

    for i in range(b):
        expect = gcm_encrypt(key, nonces[i], b"", bytes(pts[i].reshape(-1)))
        got = bytes(ct[i].reshape(-1)) + bytes(tag[i])
        assert got == expect, f"message {i} mismatch on mesh ({dp},{sp})"


def test_fused_seal_matches_gcm():
    rng = np.random.default_rng(3)
    key = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    nonce = bytes(rng.integers(0, 256, 12, dtype=np.uint8))
    pt = bytes(rng.integers(0, 256, 16 * 1024, dtype=np.uint8))
    assert gcm_seal(key, nonce, pt) == gcm_encrypt(key, nonce, b"", pt)


def test_seal_batch_sharded_matches_unsharded():
    """Multi-key fused GCM over a dp mesh (zero collectives) == the
    unsharded core, and == the per-message GCM oracle."""
    import jax.numpy as jnp

    from micro_aes.modes.gcm import gcm_encrypt
    from micro_aes.modes.seal_batch import _prep, _seal_batch_core
    from micro_aes.parallel.batch import seal_batch_sharded_fn
    from micro_aes.parallel.mesh import make_mesh

    rng = np.random.default_rng(61)
    B = 8
    keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            for _ in range(B)]
    nonces = [rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
              for _ in range(B)]
    aads = [b"hdr%d" % i for i in range(B)]
    pts = [rng.integers(0, 256, 32 * (i + 1), dtype=np.uint8).tobytes()
           for i in range(B)]
    (b, wm, _, ns, front_np, kp_stack, j0w, front, mask, sel,
     len_bits, ptw) = _prep(keys, nonces, aads, pts)

    ref_out, ref_tags = _seal_batch_core(kp_stack, j0w, front, mask, sel,
                                         len_bits, ptw, b, wm)
    for dp in (2, 4, 8):
        mesh = make_mesh(dp, 1)
        fn = seal_batch_sharded_fn(mesh, b, wm)
        out, tags = fn(kp_stack, j0w, front, mask, sel, len_bits, ptw)
        assert np.array_equal(np.asarray(out), np.asarray(ref_out)), dp
        assert np.array_equal(np.asarray(tags), np.asarray(ref_tags)), dp

    # anchor one message against the conformance-validated path
    out_np = np.asarray(ref_out).reshape(B, -1)
    f = int(front_np[0])
    ct = out_np[0, 4 * f: 4 * (f + ns[0])].tobytes()
    tag = bytes(np.asarray(ref_tags)[0])
    assert ct + tag == gcm_encrypt(keys[0], nonces[0], aads[0], pts[0])


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_xts_sectors_sharded_matches_per_sector(dp):
    """dp-sharded disk-sector XTS == the per-sector conformance path
    (zero collectives; sectors shard with their tweaks)."""
    from micro_aes.modes.xts import xts_encrypt
    from micro_aes.parallel.batch import xts_sectors_sharded_fn
    from micro_aes.parallel.mesh import make_mesh

    rng = np.random.default_rng(63)
    sector = 512  # 32 blocks -> r_per_sector = 1
    s = 2 * dp
    keys = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    data = rng.integers(0, 256, s * sector, dtype=np.uint8).tobytes()
    ids = list(range(1000, 1000 + s))

    from micro_aes.core.bitslice import key_planes
    from micro_aes.core.keyschedule import expand_key
    from micro_aes.modes.seal import host_stream, host_unstream

    kp1 = jnp.asarray(key_planes(expand_key(keys[:16])))
    kp2 = jnp.asarray(key_planes(expand_key(keys[16:])))
    tweaks = np.zeros((s, BLOCK), np.uint8)
    for i, sid in enumerate(ids):
        tweaks[i, :8] = np.frombuffer(sid.to_bytes(8, "little"), np.uint8)
    w = len(data) // BLOCK // 32
    ptw = jnp.asarray(host_stream(data, 0, w))

    mesh = make_mesh(dp, 1)
    seal = xts_sectors_sharded_fn(mesh, r_per_sector=1)
    got = host_unstream(np.asarray(seal(kp1, kp2, jnp.asarray(tweaks), ptw)),
                        0, len(data))
    want = b"".join(
        xts_encrypt(keys, sid.to_bytes(16, "little"),
                    data[i * sector:(i + 1) * sector])
        for i, sid in enumerate(ids))
    assert got == want

    opener = xts_sectors_sharded_fn(mesh, r_per_sector=1, decrypt=True)
    back = host_unstream(
        np.asarray(opener(kp1, kp2, jnp.asarray(tweaks),
                          jnp.asarray(host_stream(got, 0, w)))), 0, len(data))
    assert back == data


def test_chain_sharded_matches_unsharded():
    """Lane-packed CBC/CFB/OFB chains over a dp mesh == unsharded."""
    import jax.numpy as jnp

    from micro_aes.core.bitslice import key_planes_packed
    from micro_aes.modes._scan import (
        cbc_encrypt_scan_packed,
        cfb_encrypt_scan_packed,
        ofb_keystream_scan_packed,
    )
    from micro_aes.modes.bulk import stack_round_keys
    from micro_aes.parallel.batch import chain_sharded_fn
    from micro_aes.parallel.mesh import make_mesh

    rng = np.random.default_rng(62)
    B, nb = 64, 5  # dp=2 -> 32 lanes (one word) per device
    keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            for _ in range(B)]
    kpw = jnp.asarray(key_planes_packed(stack_round_keys(keys)))
    ivs = jnp.asarray(rng.integers(0, 256, (B, 16), dtype=np.uint8))
    blocks = jnp.asarray(rng.integers(0, 256, (B, nb, 16), dtype=np.uint8))
    dummy = jnp.zeros(nb, jnp.uint8)

    mesh = make_mesh(2, 1)
    for kind, ref_fn, data in (("cbc", cbc_encrypt_scan_packed, blocks),
                               ("cfb", cfb_encrypt_scan_packed, blocks),
                               ("ofb", ofb_keystream_scan_packed, dummy)):
        got = np.asarray(chain_sharded_fn(mesh, kind)(kpw, ivs, data))
        want = np.asarray(ref_fn(kpw, ivs, data))
        assert np.array_equal(got, want), kind
