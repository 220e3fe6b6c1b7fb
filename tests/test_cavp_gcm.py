"""CAVP GCM conformance: GcmEncryptExtIV{128,192,256}.rsp — all cases,
both directions, batched (7875 vectors per file, a handful of device
dispatches each).

Two tiers (mirroring the reference's two-tier
main.c/testvectors split): the complete corpora run under `-m full`
(nightly); the default run covers a DETERMINISTIC 1-in-16 sample of the
same files (~492 vectors per key size, every IV/AAD/PT length class
present) so the default suite stays under 20 minutes."""
import numpy as np
import pytest

from micro_aes.modes.bulk import gcm_decrypt_batch, gcm_encrypt_batch
from micro_aes.modes.gcm import gcm_decrypt, gcm_encrypt
from micro_aes.testing import rsp

pytestmark = pytest.mark.usefixtures("vector_corpus")

SAMPLE_STRIDE = 16  # deterministic default-tier sample: recs[::16]


def _encrypt_corpus(recs):
    keys = [rsp.hexval(r, "Key") for r in recs]
    ivs = [rsp.hexval(r, "IV") for r in recs]
    aads = [rsp.hexval(r, "AAD") for r in recs]
    pts = [rsp.hexval(r, "PT") for r in recs]
    outs = gcm_encrypt_batch(keys, ivs, aads, pts)
    bad = 0
    for r, out in zip(recs, outs):
        taglen = int(r["Taglen"]) // 8
        ct, tag = rsp.hexval(r, "CT"), rsp.hexval(r, "Tag")
        if out[: len(ct)] != ct or out[len(ct): len(ct) + taglen] != tag:
            bad += 1
    return bad


def _decrypt_corpus(recs):
    by_taglen: dict[int, list] = {}
    for r in recs:
        by_taglen.setdefault(int(r["Taglen"]) // 8, []).append(r)
    bad = 0
    for r in recs:
        by_taglen.setdefault(int(r["Taglen"]) // 8, []).append(r)
    bad = 0
    for taglen, group in sorted(by_taglen.items()):
        outs = gcm_decrypt_batch(
            [rsp.hexval(r, "Key") for r in group],
            [rsp.hexval(r, "IV") for r in group],
            [rsp.hexval(r, "AAD") for r in group],
            [rsp.hexval(r, "CT") + rsp.hexval(r, "Tag") for r in group],
            tag_len=taglen)
        for r, pt in zip(group, outs):
            if pt is None or pt != rsp.hexval(r, "PT"):
                bad += 1
    return bad


@pytest.mark.full
@pytest.mark.parametrize("keylen", [128, 192, 256])
def test_gcm_cavp_encrypt_all(keylen):
    recs = rsp.load_gcm(keylen)
    assert len(recs) == 7875
    bad = _encrypt_corpus(recs)
    assert bad == 0, f"{bad}/{len(recs)} GCM-{keylen} vectors failed"


@pytest.mark.full
@pytest.mark.parametrize("keylen", [128, 192, 256])
def test_gcm_cavp_decrypt_all(keylen):
    """Full decrypt corpus through the batched verify-before-decrypt open:
    every vector, grouped by tag length."""
    recs = rsp.load_gcm(keylen)
    assert len(recs) == 7875
    bad = _decrypt_corpus(recs)
    assert bad == 0, f"{bad}/{len(recs)} GCM-{keylen} decrypt vectors failed"


@pytest.mark.parametrize("keylen", [128, 192, 256])
def test_gcm_cavp_encrypt_sample(keylen):
    """Default-tier deterministic sample of the encrypt corpus."""
    recs = rsp.load_gcm(keylen)[::SAMPLE_STRIDE]
    assert len(recs) >= 400
    bad = _encrypt_corpus(recs)
    assert bad == 0, f"{bad}/{len(recs)} GCM-{keylen} sample vectors failed"


@pytest.mark.parametrize("keylen", [128, 192, 256])
def test_gcm_cavp_decrypt_sample(keylen):
    """Default-tier deterministic sample of the decrypt corpus."""
    recs = rsp.load_gcm(keylen)[::SAMPLE_STRIDE]
    assert len(recs) >= 400
    bad = _decrypt_corpus(recs)
    assert bad == 0, f"{bad}/{len(recs)} GCM-{keylen} sample failed"


def test_gcm_decrypt_batch_rejects_tampered():
    recs = rsp.load_gcm(128)[100:104]
    taglens = [int(r["Taglen"]) // 8 for r in recs]
    assert len(set(taglens)) == 1
    blobs = [rsp.hexval(r, "CT") + rsp.hexval(r, "Tag") for r in recs]
    blobs[2] = blobs[2][:-1] + bytes([blobs[2][-1] ^ 1])  # tamper one tag
    outs = gcm_decrypt_batch([rsp.hexval(r, "Key") for r in recs],
                             [rsp.hexval(r, "IV") for r in recs],
                             [rsp.hexval(r, "AAD") for r in recs],
                             blobs, tag_len=taglens[0])
    assert outs[2] is None
    for i in (0, 1, 3):
        assert outs[i] == rsp.hexval(recs[i], "PT")


def test_gcm_cavp_decrypt_singles_sample():
    recs = rsp.load_gcm(128)[::500]  # per-message host path, sampled
    for r in recs:
        taglen = int(r["Taglen"]) // 8
        ct_tag = rsp.hexval(r, "CT") + rsp.hexval(r, "Tag")
        pt = gcm_decrypt(rsp.hexval(r, "Key"), rsp.hexval(r, "IV"),
                         rsp.hexval(r, "AAD"), ct_tag, tag_len=taglen)
        assert pt == rsp.hexval(r, "PT")


def test_gcm_single_matches_batch():
    recs = rsp.load_gcm(128)[1000:1003]
    for r in recs:
        taglen = int(r["Taglen"]) // 8
        out = gcm_encrypt(rsp.hexval(r, "Key"), rsp.hexval(r, "IV"),
                          rsp.hexval(r, "AAD"), rsp.hexval(r, "PT"),
                          tag_len=taglen)
        assert out == rsp.hexval(r, "CT") + rsp.hexval(r, "Tag")
