"""FF1 format-preserving encryption (NIST SP 800-38G §5.1) — parity with
the reference's FF1_cipher/FF1round (micro_aes.c:2091-2147).

Ten strictly serial Feistel rounds (SURVEY §3.3 calls this the least
accelerator-friendly component); the per-round PRF (CBC-MAC) and S-expansion run
on device, big-number radix arithmetic uses exact Python ints on host.
"""
from __future__ import annotations

import math

import numpy as np

from ..modes.common import BLOCK, cbcmac_np, enc_blocks_np


def _prf(key: bytes, data: bytes) -> np.ndarray:
    """CBC-MAC over whole blocks (the PRF of SP 800-38G §4.5)."""
    blocks = np.frombuffer(data, np.uint8).reshape(-1, BLOCK)
    return cbcmac_np(key, np.zeros(BLOCK, np.uint8), blocks)


def _num(digits, radix: int) -> int:
    x = 0
    for d in digits:
        x = x * radix + int(d)
    return x


def _str(x: int, radix: int, m: int) -> list[int]:
    out = [0] * m
    for i in range(m - 1, -1, -1):
        out[i] = x % radix
        x //= radix
    return out


def ff1_cipher(key: bytes, tweak: bytes, digits: list[int], radix: int,
               encrypt: bool) -> list[int]:
    n = len(digits)
    t = len(tweak)
    u = n // 2
    v = n - u
    b = (math.ceil(v * math.log2(radix)) + 7) // 8
    d = 4 * ((b + 3) // 4) + 4

    p = (bytes([1, 2, 1]) + radix.to_bytes(3, "big") + bytes([10, u % 256])
         + n.to_bytes(4, "big") + t.to_bytes(4, "big"))
    q_pad = (-t - b - 1) % BLOCK

    a, bb = digits[:u], digits[u:]
    rounds = range(10) if encrypt else range(9, -1, -1)
    for i in rounds:
        q = tweak + b"\x00" * q_pad + bytes([i]) + _num(bb if encrypt else a, radix).to_bytes(b, "big")
        r = _prf(key, p + q)
        s = bytes(r)
        if d > len(s):
            nblk = (d - 1) // BLOCK  # extra blocks E(R ^ [j])
            xs = np.zeros((nblk, BLOCK), np.uint8)
            for j in range(1, nblk + 1):
                xs[j - 1] = r ^ np.frombuffer(j.to_bytes(16, "big"), np.uint8)
            s += bytes(enc_blocks_np(key, xs).reshape(-1))
        y = int.from_bytes(s[:d], "big")
        m = u if i % 2 == 0 else v
        if encrypt:
            c = (_num(a, radix) + y) % radix**m
            a, bb = bb, _str(c, radix, m)
        else:
            c = (_num(bb, radix) - y) % radix**m
            a, bb = _str(c, radix, m), a
    return a + bb
