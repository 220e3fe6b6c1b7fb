"""Device Poly1305 (ops/poly_bulk): the device matmul fold must be
bit-exact against the exact-integer host reference on the full tv corpus
and on randomized lengths (incl. ragged tails and >32^2-chunk messages
that exercise the span levels)."""
import numpy as np

from micro_aes.modes.poly1305 import poly1305_aes, poly1305_aes_bulk
from micro_aes.testing import rsp


def test_poly1305_bulk_tv_corpus(vector_corpus):
    """Poly1305AES128.tv through the DEVICE path."""
    recs = rsp.load_poly1305()
    assert len(recs) == 96
    for r in recs:
        mlen = int(r["Mlen"])
        msg = rsp.hexval(r, "Msg")[:mlen]
        out = poly1305_aes_bulk(rsp.hexval(r, "Keys"),
                                rsp.hexval(r, "Nonce"), msg)
        assert out == rsp.hexval(r, "PolyMac"), f"count={r['Count']}"


def test_poly1305_bulk_random_lengths():
    rng = np.random.default_rng(7)
    for ln in [0, 1, 16, 17, 1023, 1024, 16 * 1024 + 5, 40000]:
        keys = rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
        nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        data = rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
        assert poly1305_aes_bulk(keys, nonce, data) == \
            poly1305_aes(keys, nonce, data), f"len={ln}"


def test_poly1305_host_routes_bulk_above_threshold(monkeypatch):
    """poly1305_aes sends >= _BULK_THRESHOLD messages to the device fold;
    the Horner host loop and the routed path must agree exactly at the
    boundary."""
    from micro_aes.modes import poly1305 as p

    rng = np.random.default_rng(9)
    keys = rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
    nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    data = rng.integers(0, 256, p._BULK_THRESHOLD + 7,
                        dtype=np.uint8).tobytes()
    routed = poly1305_aes(keys, nonce, data)
    monkeypatch.setattr(p, "_BULK_THRESHOLD", 1 << 60)  # force host Horner
    assert poly1305_aes(keys, nonce, data) == routed


def test_poly1305_bulk_span_levels():
    """> 32^2 chunks forces the level-3 span table."""
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
    nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    data = rng.integers(0, 256, 16 * 1100, dtype=np.uint8).tobytes()
    assert poly1305_aes_bulk(keys, nonce, data) == \
        poly1305_aes(keys, nonce, data)
