"""Bulk XTS sector engine vs the conformance-validated per-sector path."""
import numpy as np

from micro_aes.modes.xts import xts_encrypt
from micro_aes.modes.xts_bulk import xts_open_sectors, xts_seal_sectors


def test_xts_sectors_match_reference_path():
    rng = np.random.default_rng(5)
    keys = bytes(rng.integers(0, 256, 64, dtype=np.uint8))  # AES-256 pair
    sector = 512
    s = 7
    data = bytes(rng.integers(0, 256, s * sector, dtype=np.uint8))
    sids = [3, 0, 2**40 + 17, 5, 6, 7, 255]
    out = xts_seal_sectors(keys, sids, data, sector_size=sector)
    for i, sid in enumerate(sids):
        expect = xts_encrypt(keys, None, data[i * sector:(i + 1) * sector],
                             sector_id=sid)
        assert out[i * sector:(i + 1) * sector] == expect, f"sector {i}"
    assert xts_open_sectors(keys, sids, out, sector_size=sector) == data


def test_xts_sectors_explicit_tweaks_128():
    rng = np.random.default_rng(6)
    keys = bytes(rng.integers(0, 256, 32, dtype=np.uint8))  # AES-128 pair
    sector = 4096
    s = 3
    data = bytes(rng.integers(0, 256, s * sector, dtype=np.uint8))
    tweaks = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)) for _ in range(s)]
    out = xts_seal_sectors(keys, tweaks, data)
    for i in range(s):
        expect = xts_encrypt(keys, tweaks[i], data[i * sector:(i + 1) * sector])
        assert out[i * sector:(i + 1) * sector] == expect
    assert xts_open_sectors(keys, tweaks, out) == data
