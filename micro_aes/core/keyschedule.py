"""AES key expansion (FIPS-197 §5.2) as a pure host-side function.

The reference expands into a single static global `RoundKey`
(micro_aes.c:72, 144-178), making the library non-reentrant.  Here the
schedule is a pure function `key -> uint8[rounds+1, 16]` passed explicitly
to every kernel — the functional design removes the shared-state hazard
and lets XLA treat round keys as ordinary (constant-foldable) operands.

Key expansion is inherently serial but tiny (≤ 15 blocks), so it runs in
numpy on the host; the result is reused across all blocks of a message
and across jit calls (hashable via bytes key caching in mode wrappers).
"""
from __future__ import annotations

import functools

import numpy as np

from .sbox import RCON, SBOX

VALID_KEY_SIZES = (16, 24, 32)


def num_rounds(key_len: int) -> int:
    """10/12/14 rounds for AES-128/192/256 (ROUNDS = Nk + 6)."""
    if key_len not in VALID_KEY_SIZES:
        raise ValueError(f"AES key must be 16/24/32 bytes, got {key_len}")
    return key_len // 4 + 6


from ..utils.keycache import key_cache


@key_cache(maxsize=512)
def _expand_cached(key: bytes) -> np.ndarray:
    nk = len(key) // 4
    rounds = nk + 6
    nwords = 4 * (rounds + 1)
    w = np.zeros((nwords, 4), dtype=np.uint8)
    w[:nk] = np.frombuffer(key, dtype=np.uint8).reshape(nk, 4)
    for i in range(nk, nwords):
        t = w[i - 1].copy()
        if i % nk == 0:
            t = SBOX[np.roll(t, -1)]
            t[0] ^= RCON[i // nk]
        elif nk > 6 and i % nk == 4:
            t = SBOX[t]
        w[i] = w[i - nk] ^ t
    rk = w.reshape(rounds + 1, 16)
    rk.setflags(write=False)
    return rk


def expand_key(key) -> np.ndarray:
    """key bytes -> round keys uint8[rounds+1, 16] (cached per key)."""
    key = bytes(key)
    if len(key) not in VALID_KEY_SIZES:
        raise ValueError(f"AES key must be 16/24/32 bytes, got {len(key)}")
    return _expand_cached(key)


def expand_keys_batch(keys: np.ndarray) -> np.ndarray:
    """Vectorized key expansion: uint8[B, klen] -> uint8[B, rounds+1, 16].

    Same schedule as `_expand_cached` but the word recurrence runs over
    the whole batch at once — ≤ 60 small numpy ops total instead of
    ~60 per key.  The batch engines feed thousands of single-use CAVP /
    multi-tenant keys per call, where per-key Python dominated the wall
    time."""
    keys = np.asarray(keys, np.uint8)
    b, klen = keys.shape
    if klen not in VALID_KEY_SIZES:
        raise ValueError(f"AES key must be 16/24/32 bytes, got {klen}")
    nk = klen // 4
    rounds = nk + 6
    nwords = 4 * (rounds + 1)
    w = np.zeros((nwords, b, 4), dtype=np.uint8)
    w[:nk] = keys.reshape(b, nk, 4).transpose(1, 0, 2)
    for i in range(nk, nwords):
        t = w[i - 1]
        if i % nk == 0:
            t = SBOX[np.roll(t, -1, axis=-1)].copy()
            t[:, 0] ^= RCON[i // nk]
        elif nk > 6 and i % nk == 4:
            t = SBOX[t]
        w[i] = w[i - nk] ^ t
    return np.ascontiguousarray(
        w.transpose(1, 0, 2).reshape(b, rounds + 1, 16))
