"""Multi-message batch engines (modes/chain_bulk) vs the per-message
modes as oracle, across ragged lengths, CTS, padding, and mixed keys."""
import numpy as np
import pytest

from micro_aes.errors import DataLengthError
from micro_aes.modes import cbc, cfb, ctr, ecb, ofb
from micro_aes.modes.chain_bulk import (
    cbc_decrypt_batch,
    cbc_encrypt_batch,
    cfb_decrypt_batch,
    cfb_encrypt_batch,
    ctr_xcrypt_batch,
    ecb_decrypt_batch,
    ecb_encrypt_batch,
    ofb_xcrypt_batch,
)
from micro_aes.modes.common import PAD_ISO7816, PAD_PKCS7, PAD_ZERO

LENS = [16, 17, 31, 32, 33, 48, 100, 256, 1000]


def _mk(rng, lens, keylen=16):
    keys = [rng.integers(0, 256, keylen, dtype=np.uint8).tobytes()
            for _ in lens]
    ivs = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in lens]
    pts = [rng.integers(0, 256, ln, dtype=np.uint8).tobytes() for ln in lens]
    return keys, ivs, pts


@pytest.mark.parametrize("keylen", [16, 32])
def test_cbc_cts_batch_roundtrip(keylen):
    rng = np.random.default_rng(31)
    keys, ivs, pts = _mk(rng, LENS, keylen)
    outs = cbc_encrypt_batch(keys, ivs, pts, cts=True)
    for i in range(len(pts)):
        assert outs[i] == cbc.cbc_encrypt(keys[i], ivs[i], pts[i], cts=True), \
            f"CBC-CTS len={LENS[i]}"
    backs = cbc_decrypt_batch(keys, ivs, outs, cts=True)
    assert backs == pts


@pytest.mark.parametrize("padding", [PAD_ZERO, PAD_PKCS7, PAD_ISO7816])
def test_cbc_padded_batch(padding):
    rng = np.random.default_rng(32)
    keys, ivs, pts = _mk(rng, [16, 32, 100, 240])
    outs = cbc_encrypt_batch(keys, ivs, pts, cts=False, padding=padding)
    for i in range(len(pts)):
        assert outs[i] == cbc.cbc_encrypt(keys[i], ivs[i], pts[i],
                                          cts=False, padding=padding)
    backs = cbc_decrypt_batch(keys, ivs, outs, cts=False)
    for i, p in enumerate(pts):
        assert backs[i][: len(p)] == p  # padding not stripped, like the ref


def test_cbc_cts_too_short():
    with pytest.raises(DataLengthError):
        cbc_encrypt_batch([b"k" * 16], [b"i" * 16], [b"short"], cts=True)


def test_cfb_batch_matches_single():
    rng = np.random.default_rng(33)
    keys, ivs, pts = _mk(rng, [0, 1, 15] + LENS)
    outs = cfb_encrypt_batch(keys, ivs, pts)
    for i in range(len(pts)):
        assert outs[i] == cfb.cfb_encrypt(keys[i], ivs[i], pts[i]), \
            f"CFB len={len(pts[i])}"
    backs = cfb_decrypt_batch(keys, ivs, outs)
    assert backs == pts


def test_ofb_batch_matches_single():
    rng = np.random.default_rng(34)
    keys, ivs, pts = _mk(rng, [0, 1, 15] + LENS, keylen=32)
    outs = ofb_xcrypt_batch(keys, ivs, pts)
    for i in range(len(pts)):
        assert outs[i] == ofb.ofb_encrypt(keys[i], ivs[i], pts[i])
    assert ofb_xcrypt_batch(keys, ivs, outs) == pts


def test_ecb_batch_matches_single():
    rng = np.random.default_rng(35)
    keys, _, pts = _mk(rng, [16, 17, 32, 100])
    outs = ecb_encrypt_batch(keys, pts, padding=PAD_PKCS7)
    for i in range(len(pts)):
        assert outs[i] == ecb.ecb_encrypt(keys[i], pts[i], padding=PAD_PKCS7)
    backs = ecb_decrypt_batch(keys, outs)
    for i, p in enumerate(pts):
        assert backs[i][: len(p)] == p


def test_ctr_batch_matches_single():
    rng = np.random.default_rng(36)
    keys, _, pts = _mk(rng, [0, 1] + LENS)
    nonces = [rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
              for _ in pts]
    outs = ctr_xcrypt_batch(keys, nonces, pts)
    for i in range(len(pts)):
        assert outs[i] == ctr.ctr_encrypt(keys[i], nonces[i], pts[i]), \
            f"CTR len={len(pts[i])}"
    assert ctr_xcrypt_batch(keys, nonces, outs) == pts
    # preset-counter variant (full 16-byte IV)
    fulls = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
             for _ in pts]
    outs = ctr_xcrypt_batch(keys, fulls, pts, preset_counter=True)
    for i in range(len(pts)):
        assert outs[i] == ctr.ctr_encrypt(keys[i], fulls[i], pts[i],
                                          preset_counter=True)


def test_cipher_blocks_multikey_mixed_key_sizes():
    """Direct helper check: a batch mixing AES-128/192/256 keys must
    split into per-size groups (round counts differ) and still match the
    per-message oracle."""
    import numpy as np

    from micro_aes.core.cipher import encrypt_blocks
    from micro_aes.core.keyschedule import expand_key
    from micro_aes.modes.bulk import cipher_blocks_multikey
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    keys = [bytes(rng.integers(0, 256, klen, dtype=np.uint8))
            for klen in (16, 32, 24, 16)]
    blocks = rng.integers(0, 256, (4, 5, 16), dtype=np.uint8)
    got = cipher_blocks_multikey(keys, blocks)
    for i, k in enumerate(keys):
        exp = np.asarray(encrypt_blocks(jnp.asarray(expand_key(k)),
                                        jnp.asarray(blocks[i])))
        assert np.array_equal(got[i], exp), i


def test_packed_chain_scans_match_vmapped():
    """The lane-packed bitsliced chain scans (32 messages per word,
    per-lane keys — the local body of parallel/batch.chain_sharded_fn)
    are bit-exact vs the vmapped per-message scans — mixed per-lane
    keys, a ragged batch padded to 32 lanes, CBC/CFB/OFB."""
    import jax
    import jax.numpy as jnp

    from micro_aes.core.bitslice import key_planes_packed
    from micro_aes.modes._scan import (
        cbc_encrypt_scan,
        cbc_encrypt_scan_packed,
        cfb_encrypt_scan,
        cfb_encrypt_scan_packed,
        ofb_keystream_scan,
        ofb_keystream_scan_packed,
    )
    from micro_aes.modes.bulk import stack_round_keys

    rng = np.random.default_rng(21)
    nmsg, nb = 5, 7
    keys = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
            for _ in range(nmsg)]
    rks = stack_round_keys(keys)
    ivs = rng.integers(0, 256, (nmsg, 16), dtype=np.uint8)
    blocks = rng.integers(0, 256, (nmsg, nb, 16), dtype=np.uint8)
    pad = (-nmsg) % 32
    kpw = jnp.asarray(key_planes_packed(
        np.concatenate([rks, np.repeat(rks[-1:], pad, 0)])))
    ivp = jnp.asarray(np.pad(ivs, ((0, pad), (0, 0))))
    blp = jnp.asarray(np.pad(blocks, ((0, pad), (0, 0), (0, 0))))
    rj, ivj, bj = jnp.asarray(rks), jnp.asarray(ivs), jnp.asarray(blocks)
    dummy = jnp.zeros((nmsg, nb, 1), jnp.uint8)
    for packed, data, scan, arg in (
            (cbc_encrypt_scan_packed, blp, cbc_encrypt_scan, bj),
            (cfb_encrypt_scan_packed, blp, cfb_encrypt_scan, bj),
            (ofb_keystream_scan_packed, jnp.zeros(nb, jnp.uint8),
             ofb_keystream_scan, dummy)):
        got = np.asarray(packed(kpw, ivp, data))[:nmsg]
        want = np.asarray(jax.vmap(scan)(rj, ivj, arg))
        assert np.array_equal(got, want), packed.__name__


@pytest.mark.parametrize("decrypt", [False, True])
def test_aead_sharded_ccm_matches_per_message(decrypt):
    """The dp-sharded CTR+CBC-MAC engine (parallel/batch.aead_sharded_fn,
    CCM form: whiten step + plaintext MAC) on a 2-device mesh against
    the per-message CCM path, seal and open, including a counter base
    at the 56-bit carry window edge."""
    import jax.numpy as jnp

    from micro_aes.modes.bulk import _ccm_prefix_batch, stack_round_keys
    from micro_aes.modes.ccm import _iv0, ccm_encrypt
    from micro_aes.ops.mac import cbcmac_fold_batch
    from micro_aes.parallel.batch import aead_sharded_fn
    from micro_aes.parallel.mesh import make_mesh

    rng = np.random.default_rng(47)
    b, nb = 4, 5
    keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            for _ in range(b)]
    nonces = [rng.integers(0, 256, 11, dtype=np.uint8).tobytes()
              for _ in range(b)]
    nonces[2] = nonces[2][:8] + b"\xff\xff\xff"
    aads = [b"aead-%d" % i * i for i in range(b)]
    pts = [rng.integers(0, 256, nb * 16, dtype=np.uint8).tobytes()
           for _ in range(b)]
    want = [ccm_encrypt(k, n, a, p)
            for k, n, a, p in zip(keys, nonces, aads, pts)]
    rks = stack_round_keys(keys)
    iv0s = np.stack([_iv0(np.frombuffer(n, np.uint8)) for n in nonces])
    pb, nv1 = _ccm_prefix_batch(iv0s, [np.frombuffer(a, np.uint8)
                                       for a in aads],
                                [len(p) for p in pts], 16)
    init = cbcmac_fold_batch(jnp.asarray(rks),
                             jnp.zeros((b, 16), jnp.uint8),
                             jnp.asarray(pb), jnp.asarray(nv1))
    src = [w[:-16] for w in want] if decrypt else pts
    blocks = np.stack([np.frombuffer(x, np.uint8).reshape(nb, 16)
                       for x in src])
    fn = aead_sharded_fn(make_mesh(2, 1), "ccm", decrypt=decrypt)
    out, tags = fn(jnp.asarray(rks), jnp.asarray(iv0s), init,
                   jnp.asarray(blocks), jnp.full(b, nb, jnp.int32),
                   jnp.full((b, 16), 0xFF, jnp.uint8),
                   jnp.zeros((b, 16), jnp.uint8))
    out, tags = np.asarray(out), np.asarray(tags)
    for i in range(b):
        if decrypt:
            assert bytes(out[i].reshape(-1)) == pts[i], i
            assert bytes(tags[i]) == want[i][-16:], i
        else:
            assert bytes(out[i].reshape(-1)) + bytes(tags[i]) == want[i], i
