"""Batched CCM / EAX engines (modes/bulk): full conformance corpora and
randomized differential checks against the per-message host paths."""
import numpy as np
import pytest

from micro_aes.modes.bulk import (
    ccm_decrypt_batch,
    ccm_encrypt_batch,
    eax_decrypt_batch,
    eax_encrypt_batch,
)
from micro_aes.modes.ccm import ccm_encrypt
from micro_aes.modes.eax import eax_encrypt
from micro_aes.testing import rsp


@pytest.mark.parametrize("keylen", [128, 192, 256])
def test_ccm_vnt_batched(keylen, vector_corpus):
    recs = rsp.load_ccm(keylen)
    assert len(recs) == 70
    keys = [rsp.hexval(r, "Key") for r in recs]
    nonces = [rsp.hexval(r, "Nonce") for r in recs]
    aads = [rsp.hexval(r, "Adata") for r in recs]
    pts = [rsp.hexval(r, "Payload") for r in recs]
    tlen = len(rsp.hexval(recs[0], "CT")) - len(pts[0])
    outs = ccm_encrypt_batch(keys, nonces, aads, pts, tag_len=tlen)
    for r, out in zip(recs, outs):
        assert out == rsp.hexval(r, "CT"), f"CCM-{keylen} count={r['Count']}"
    backs = ccm_decrypt_batch(keys, nonces, aads, outs, tag_len=tlen)
    for r, back in zip(recs, backs):
        assert back == rsp.hexval(r, "Payload")


def test_ccm_batch_random_vs_single():
    rng = np.random.default_rng(3)
    keys, nonces, aads, pts = [], [], [], []
    for ln in [0, 1, 15, 16, 17, 100, 300]:
        keys.append(rng.integers(0, 256, 16, dtype=np.uint8).tobytes())
        nonces.append(rng.integers(0, 256, 11, dtype=np.uint8).tobytes())
        aads.append(rng.integers(0, 256, (ln * 7) % 60, dtype=np.uint8).tobytes())
        pts.append(rng.integers(0, 256, ln, dtype=np.uint8).tobytes())
    outs = ccm_encrypt_batch(keys, nonces, aads, pts)
    for i in range(len(keys)):
        assert outs[i] == ccm_encrypt(keys[i], nonces[i], aads[i], pts[i])
    tampered = list(outs)
    tampered[2] = tampered[2][:-1] + bytes([tampered[2][-1] ^ 1])
    backs = ccm_decrypt_batch(keys, nonces, aads, tampered)
    for i in range(len(keys)):
        if i == 2:
            assert backs[i] is None
        else:
            assert backs[i] == pts[i]


def test_eax_tv_batched(vector_corpus):
    recs = rsp.load_eax()
    assert len(recs) == 10
    keys = [rsp.hexval(r, "KEY") for r in recs]
    nonces = [rsp.hexval(r, "NONCE") for r in recs]
    aads = [rsp.hexval(r, "HEADER") for r in recs]
    pts = [rsp.hexval(r, "MSG") for r in recs]
    outs = eax_encrypt_batch(keys, nonces, aads, pts)
    for r, out in zip(recs, outs):
        assert out == rsp.hexval(r, "CIPHER"), f"EAX count mismatch"
    backs = eax_decrypt_batch(keys, nonces, aads, outs)
    for r, back in zip(recs, backs):
        assert back == rsp.hexval(r, "MSG")


def test_eax_batch_random_vs_single():
    rng = np.random.default_rng(4)
    keys, nonces, aads, pts = [], [], [], []
    for ln in [0, 1, 16, 33, 200]:
        keys.append(rng.integers(0, 256, 16, dtype=np.uint8).tobytes())
        nonces.append(rng.integers(0, 256, 16, dtype=np.uint8).tobytes())
        aads.append(rng.integers(0, 256, (ln * 3) % 40, dtype=np.uint8).tobytes())
        pts.append(rng.integers(0, 256, ln, dtype=np.uint8).tobytes())
    outs = eax_encrypt_batch(keys, nonces, aads, pts)
    for i in range(len(keys)):
        assert outs[i] == eax_encrypt(keys[i], nonces[i], aads[i], pts[i])
    tampered = list(outs)
    tampered[1] = tampered[1][:-1] + bytes([tampered[1][-1] ^ 1])
    backs = eax_decrypt_batch(keys, nonces, aads, tampered)
    for i in range(len(keys)):
        if i == 1:
            assert backs[i] is None
        else:
            assert backs[i] == pts[i]


def test_siv_batch_random_vs_single():
    """Batched SIV == per-message SIV on mixed shapes + RFC-5297 KAT."""
    from micro_aes.modes.bulk import siv_decrypt_batch, siv_encrypt_batch
    from micro_aes.modes.siv import siv_encrypt

    rng = np.random.default_rng(11)
    keys, aads, pts = [], [], []
    for ln in [0, 1, 15, 16, 17, 31, 32, 33, 100]:
        keys.append(rng.integers(0, 256, 32, dtype=np.uint8).tobytes())
        aads.append(rng.integers(0, 256, (ln * 5) % 40,
                                 dtype=np.uint8).tobytes())
        pts.append(rng.integers(0, 256, ln, dtype=np.uint8).tobytes())
    outs = siv_encrypt_batch(keys, aads, pts)
    for i in range(len(keys)):
        iv, ct = siv_encrypt(keys[i], aads[i], pts[i])
        assert outs[i] == (iv, ct), f"SIV batch mismatch at {i}"
    ivs = [iv for iv, _ in outs]
    cts = [ct for _, ct in outs]
    backs = siv_decrypt_batch(keys, ivs, aads, cts)
    assert backs == pts
    # tamper one iv -> that message fails, others unaffected
    bad = list(ivs)
    bad[3] = bytes([bad[3][0] ^ 1]) + bad[3][1:]
    backs = siv_decrypt_batch(keys, bad, aads, cts)
    for i in range(len(keys)):
        assert backs[i] == (None if i == 3 else pts[i])


def test_kw_batch_random_vs_single():
    """Batched KW == per-message KW; ICV failures isolate per message."""
    from micro_aes.modes.bulk import key_unwrap_batch, key_wrap_batch
    from micro_aes.modes.kw import key_wrap

    rng = np.random.default_rng(12)
    keks, secrets = [], []
    for nsb in [2, 2, 3, 4, 8, 16]:
        keks.append(rng.integers(0, 256, 16 if nsb % 2 else 32,
                                 dtype=np.uint8).tobytes())
        secrets.append(rng.integers(0, 256, nsb * 8,
                                    dtype=np.uint8).tobytes())
    outs = key_wrap_batch(keks, secrets)
    for i in range(len(keks)):
        assert outs[i] == key_wrap(keks[i], secrets[i]), f"KW mismatch {i}"
    backs = key_unwrap_batch(keks, outs)
    assert backs == secrets
    bad = list(outs)
    bad[1] = bytes([bad[1][0] ^ 1]) + bad[1][1:]
    backs = key_unwrap_batch(keks, bad)
    for i in range(len(keks)):
        assert backs[i] == (None if i == 1 else secrets[i])


def test_mixed_key_sizes_in_one_batch():
    """Every bulk engine accepts AES-128/192/256 keys in ONE batch call
    (split per key-size group and reassembled in order — round-key
    schedules of different round counts cannot stack)."""
    from micro_aes.modes import bulk
    from micro_aes.modes.cmac import cmac
    from micro_aes.modes.gcm import gcm_encrypt
    from micro_aes.modes.siv import siv_encrypt

    keys = [bytes(range(16)), bytes(range(32)), bytes(range(24))]
    nonces = [bytes(12), bytes(range(12)), bytes(range(11, 23))]
    aads = [b"", b"aad-two", b"x" * 40]
    pts = [b"A" * 64, b"B" * 33, b""]

    out = bulk.gcm_encrypt_batch(keys, nonces, aads, pts)
    assert out == [gcm_encrypt(k, n, a, p)
                   for k, n, a, p in zip(keys, nonces, aads, pts)]
    assert bulk.gcm_decrypt_batch(keys, nonces, aads, out) == pts
    assert bulk.gcm_encrypt_batch([], [], [], []) == []

    msgs = [b"m" * 7, b"n" * 32, b""]
    assert bulk.cmac_batch(keys, msgs) == [cmac(k, m)
                                           for k, m in zip(keys, msgs)]

    n11 = [n[:11] for n in nonces]
    got = bulk.ccm_encrypt_batch(keys, n11, aads, pts)
    assert bulk.ccm_decrypt_batch(keys, n11, aads, got) == pts

    got = bulk.eax_encrypt_batch(keys, nonces, aads, pts)
    assert bulk.eax_decrypt_batch(keys, nonces, aads, got) == pts

    sivkeys = [bytes(range(32)), bytes(range(64)), bytes(range(48))]
    got = bulk.siv_encrypt_batch(sivkeys, aads, pts)
    assert got == [siv_encrypt(k, a, p)
                   for k, a, p in zip(sivkeys, aads, pts)]
    assert bulk.siv_decrypt_batch(sivkeys, [iv for iv, _ in got], aads,
                                  [ct for _, ct in got]) == pts


def test_device_resident_paths_match_host():
    """The device-resident multi-key cipher (no host round trip between
    the batch engines' stages) equals the host-returning form, both
    directions, and the full CCM engine with mixed key sizes passed by
    keyword (signature-bound regrouping) equals the per-message path."""
    import jax.numpy as jnp

    from micro_aes.modes import bulk
    from micro_aes.modes.ccm import ccm_encrypt

    rng = np.random.default_rng(71)
    B, nb = 64, 32
    keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            for _ in range(B)]
    blocks = rng.integers(0, 256, (B, nb, 16), dtype=np.uint8)
    want = bulk.cipher_blocks_multikey(keys, blocks)
    got = np.asarray(
        bulk.cipher_blocks_multikey_dev(keys, jnp.asarray(blocks)))
    assert np.array_equal(got, want)
    gotd = np.asarray(bulk.cipher_blocks_multikey_dev(
        keys, jnp.asarray(want), decrypt=True))
    assert np.array_equal(gotd, blocks)

    keys3 = [bytes(range(16)), bytes(range(32)), bytes(range(24))]
    nonces3 = [bytes(range(11))] * 3
    aads3 = [b"", b"hdr", b"x" * 20]
    pts3 = [b"A" * 40, b"", b"B" * 16]
    got = bulk.ccm_encrypt_batch(keys3, nonces3, aads3, pts=pts3)
    assert got == [ccm_encrypt(k, n, a, p)
                   for k, n, a, p in zip(keys3, nonces3, aads3, pts3)]
    assert bulk.ccm_decrypt_batch(keys3, nonces3, aads3, got) == pts3


def test_ccm_prefix_batch_matches_per_message():
    """The vectorized B0/A-prefix assembly (one ragged scatter) must
    equal the per-message reference-mirroring builder across every AAD
    length regime, incl. the 0xFFFE long-AAD encoding boundary."""
    from micro_aes.modes.bulk import _ccm_b0_prefix, _ccm_prefix_batch

    rng = np.random.default_rng(5)
    alens = [0, 1, 3, 13, 14, 15, 16, 30, 255, 4096, 0xFEFF, 0xFF00, 70000]
    B = len(alens)
    iv0s = rng.integers(0, 256, (B, 16), dtype=np.uint8)
    aads = [rng.integers(0, 256, n, dtype=np.uint8) for n in alens]
    ptlens = [int(x) for x in rng.integers(0, 1 << 20, B)]
    for tag_len in (4, 16):
        pb, nv1 = _ccm_prefix_batch(iv0s, aads, ptlens, tag_len)
        for i in range(B):
            ref = _ccm_b0_prefix(iv0s[i], aads[i], ptlens[i], tag_len)
            assert nv1[i] == ref.shape[0]
            assert np.array_equal(pb[i, : nv1[i]], ref), alens[i]
            assert not pb[i, nv1[i]:].any()


@pytest.mark.full
def test_aead_batch_engines_ragged_and_tamper():
    """The CCM and EAX batch engines against the per-message oracles:
    ragged lengths, empty payloads, AAD of every size class, and one
    tampered tag per direction that must come back None without
    disturbing its neighbours."""
    from micro_aes.modes import bulk
    from micro_aes.modes.ccm import ccm_encrypt
    from micro_aes.modes.eax import eax_encrypt

    rng = np.random.default_rng(73)
    keys, nonces, aads, pts = [], [], [], []
    for ln in [0, 1, 15, 16, 17, 33, 100]:
        keys.append(rng.integers(0, 256, 16, dtype=np.uint8).tobytes())
        nonces.append(rng.integers(0, 256, 11, dtype=np.uint8).tobytes())
        aads.append(rng.integers(0, 256, (ln * 5) % 40,
                                 dtype=np.uint8).tobytes())
        pts.append(rng.integers(0, 256, ln, dtype=np.uint8).tobytes())
    got = bulk.ccm_encrypt_batch(keys, nonces, aads, pts)
    want = [ccm_encrypt(k, n, a, p)
            for k, n, a, p in zip(keys, nonces, aads, pts)]
    assert got == want
    assert bulk.ccm_decrypt_batch(keys, nonces, aads, got) == pts
    bad = list(got)
    bad[3] = bad[3][:-1] + bytes([bad[3][-1] ^ 1])
    outs = bulk.ccm_decrypt_batch(keys, nonces, aads, bad)
    assert outs[3] is None and outs[:3] == pts[:3]

    nonces12 = [n + b"\x00" for n in nonces]
    got = bulk.eax_encrypt_batch(keys, nonces12, aads, pts)
    want = [eax_encrypt(k, n, a, p)
            for k, n, a, p in zip(keys, nonces12, aads, pts)]
    assert got == want
    assert bulk.eax_decrypt_batch(keys, nonces12, aads, got) == pts
    bad = list(got)
    bad[5] = bad[5][:-1] + bytes([bad[5][-1] ^ 1])
    outs = bulk.eax_decrypt_batch(keys, nonces12, aads, bad)
    assert outs[5] is None and outs[4] == pts[4]


@pytest.mark.full
def test_kw_batch_matches_per_message_and_tamper():
    """key_wrap_batch/key_unwrap_batch against the per-message KW path,
    plus ICV failure isolation on unwrap."""
    from micro_aes.modes.bulk import key_unwrap_batch, key_wrap_batch
    from micro_aes.modes.kw import key_wrap

    rng = np.random.default_rng(89)
    b, n = 100, 3
    keks = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            for _ in range(b)]
    secrets = [rng.integers(0, 256, n * 8, dtype=np.uint8).tobytes()
               for _ in range(b)]
    got = key_wrap_batch(keks, secrets)
    for i in (0, 7, b - 1):
        assert got[i] == key_wrap(keks[i], secrets[i])
    assert key_unwrap_batch(keks, got) == secrets
    bad = list(got)
    bad[7] = bad[7][:1] + bytes([bad[7][1] ^ 1]) + bad[7][2:]
    outs = key_unwrap_batch(keks, bad)
    assert outs[7] is None and outs[6] == secrets[6]
