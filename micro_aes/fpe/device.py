"""Device-side FPE: batched FF1/FF3/FF3-1 with vectorized radix bignums.

This is the bulk engine the host paths (ff1.py / ff3.py) cannot be: N
tokens encrypt in ONE jitted dispatch.  The reference's arbitrary-
precision numeral arithmetic (numRadix/strRadix/numstrAdd/numstrSub,
micro_aes.c:2039-2088) is re-designed for an accelerator instead of
translated:

* NUM_radix(digits) -> bytes becomes a single small matmul against a
  precomputed power table (byte limbs of radix^j) followed by ONE
  base-256 carry-propagation scan — no per-digit bignum loop.
* bytes -> digits mod radix^m (the y of each Feistel round, SP 800-38G
  step 6c) becomes a matmul against digit vectors of 256^j mod radix^m,
  FUSED with the numstrAdd/Sub: one base-radix carry scan yields
  (NUM(A) ± y) mod radix^m directly.  The mod is free (drop the carry).
* The per-round PRF (CBC-MAC over P||Q, micro_aes.c:2091-2114) runs as a
  short chain of batched single-block encrypts; the S-expansion blocks
  E(R ^ [j]) are one batched encrypt.

All shapes are static per (radix, token length, tweak length) and the
Feistel runs as a lax.fori_loop over DOUBLE-rounds: one round pair
restores the (u, v) half shapes, so the loop body traces once instead of
10 (FF1) / 8 (FF3) unrolled rounds — compile time, not correctness, is
why.  The AES oracle inside is likewise lax.scan'd over its rounds.
The batch axis is where the parallelism lives.  Bit-exactness is
asserted against the host oracle and the reference tv corpus in
tests/test_fpe_device.py.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.cipher import _SBOX_J, SHIFT_PERM, _mix_columns
from ..core.keyschedule import expand_key
from ..errors import DecryptionError, EncryptionError
from .alphabet import resolve_alphabet
from .ff3 import _split_tweak

# Device bignums use byte-limb products in int32; radix must fit a byte
# times a byte times the digit count.  Every reference alphabet (radix
# <= 95) qualifies; exotic wide alphabets fall back to the host path.
MAX_DEVICE_RADIX = 256


def encrypt_blocks(round_keys, blocks):
    """Batched single-block AES with rounds under lax.scan — same math as
    core.cipher.encrypt_blocks, but the round body traces ONCE.  Used for
    the odd single blocks (the P-block CBC seed) and, unless
    _use_bitslice() says otherwise, for the batched PRF calls too."""
    rounds = round_keys.shape[0] - 1
    s = blocks ^ round_keys[0]

    def body(st, rk):
        st = jnp.take(_SBOX_J, st)[..., SHIFT_PERM]
        shape = st.shape
        st = _mix_columns(st.reshape(shape[:-1] + (4, 4))).reshape(shape)
        return st ^ rk, None

    s, _ = jax.lax.scan(body, s, round_keys[1:rounds])
    return jnp.take(_SBOX_J, s)[..., SHIFT_PERM] ^ round_keys[rounds]


def _use_bitslice() -> bool:
    """MICRO_AES_FPE_BITSLICE=1 selects the bitsliced plane circuit for
    the batched PRF; the default is the table-form gather.  The circuit
    is unrolled 4-6 times inside each Feistel double-round body, so it
    compiles for minutes on XLA CPU; on a GPU the two forms have not
    been compared yet."""
    import os

    return os.environ.get("MICRO_AES_FPE_BITSLICE") == "1"


def _enc_batch(rks, kp, blocks, bitslice: bool):
    """Batch cipher dispatch: the bitsliced plane circuit when the batch
    is 32-aligned (the front-end pads every group to 32) and the caller
    asked for it, else the scan/gather fallback."""
    from ..core.bitslice import encrypt_blocks_bitsliced

    if bitslice and blocks.shape[0] % 32 == 0:
        return encrypt_blocks_bitsliced(kp, blocks)
    return encrypt_blocks(rks, blocks)


# ---------------------------------------------------------------------------
# Power tables (host ints -> constants folded into the jitted program)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=512)
def _num_table(radix: int, length: int, nbytes: int, msd_first: bool):
    """U[j, l] = byte l (LSB first) of radix^e(j), e = length-1-j for
    MSD-first digit input, j for LSD-first.  digits @ U followed by a
    base-256 carry scan is NUM_radix (micro_aes.c:2039-2052)."""
    u = np.zeros((length, nbytes), np.int32)
    for j in range(length):
        e = length - 1 - j if msd_first else j
        p = pow(radix, e)
        for l in range(nbytes):
            u[j, l] = (p >> (8 * l)) & 0xFF
    return u


@functools.lru_cache(maxsize=512)
def _ydig_table(radix: int, nbytes: int, m: int):
    """V[j, p] = digit p (LSD first) of 256^(nbytes-1-j) mod radix^m, so
    S_bytes(BE) @ V accumulates y mod radix^m in positional radix form
    (normalized by the same carry scan that applies numstrAdd/Sub)."""
    mod = pow(radix, m)
    v = np.zeros((nbytes, m), np.int32)
    for j in range(nbytes):
        p = pow(256, nbytes - 1 - j, mod)
        for k in range(m):
            v[j, k] = p % radix
            p //= radix
    return v


def _carry_scan(acc, base: int):
    """Normalize positional LSD-first int32 values [B, L] into digits in
    [0, base); the final carry is dropped (i.e. result is mod base^L).
    floor-division carries make one scan serve add AND subtract."""
    def step(carry, a):
        t = a + carry
        q = jnp.floor_divide(t, base)
        return q, t - q * base

    _, out = jax.lax.scan(step, jnp.zeros(acc.shape[0], jnp.int32),
                          jnp.swapaxes(acc, 0, 1))
    return jnp.swapaxes(out, 0, 1)


def _num_bytes(h, radix: int, nbytes: int, msd_first: bool):
    """NUM_radix as matmul + carry scan -> LSB-first byte limbs [B, nbytes]."""
    u = jnp.asarray(_num_table(radix, h.shape[1], nbytes, msd_first))
    return _carry_scan(h.astype(jnp.int32) @ u, 256)


# ---------------------------------------------------------------------------
# FF1 (SP 800-38G §5.1; reference FF1_cipher micro_aes.c:2117-2147)
# ---------------------------------------------------------------------------


def _wire_packed(radix: int) -> bool:
    """radix <= 16 digit matrices travel 2 digits/byte: the host<->device
    bytes halve in BOTH directions, and the pack/unpack is a shift
    and a mask on either end.  Radix 10 — the reference's default
    alphabet (micro_aes.c:2008-2013) and the production-credential
    shape — qualifies."""
    return radix <= 16


def _unpack_nibbles_j(xw, n: int):
    """uint8[B, ceil(n/2)] LE-nibble wire -> int32[B, n] digits."""
    lo = (xw & 0xF).astype(jnp.int32)
    hi = (xw >> 4).astype(jnp.int32)
    d = jnp.stack([lo, hi], axis=-1).reshape(xw.shape[0], -1)
    return d[:, :n]


def _pack_nibbles_j(d):
    """int32[B, n] digits (< 16) -> uint8[B, ceil(n/2)] LE-nibble wire."""
    n = d.shape[1]
    if n % 2:
        d = jnp.pad(d, ((0, 0), (0, 1)))
    dd = d.astype(jnp.uint8).reshape(d.shape[0], -1, 2)
    return dd[..., 0] | (dd[..., 1] << 4)


def _pack_nibbles_np(x: np.ndarray) -> np.ndarray:
    n = x.shape[1]
    if n % 2:
        x = np.concatenate([x, np.zeros((x.shape[0], 1), np.uint8)], axis=1)
    xx = x.reshape(x.shape[0], -1, 2)
    return xx[..., 0] | (xx[..., 1] << 4)


def _unpack_nibbles_np(xw: np.ndarray, n: int) -> np.ndarray:
    d = np.empty((xw.shape[0], xw.shape[1] * 2), np.uint8)
    d[:, 0::2] = xw & 0xF
    d[:, 1::2] = xw >> 4
    return d[:, :n]


def _ff1_core(rks, kp, tweak1, x, radix: int, n: int, t: int,
              encrypt: bool, bitslice: bool):
    u = n // 2
    v = n - u
    b = (math.ceil(v * math.log2(radix)) + 7) // 8
    d = 4 * ((b + 3) // 4) + 4
    qpad = (-t - b - 1) % 16
    nq = (t + qpad + 1 + b) // 16
    B = x.shape[0]
    # one tweak serves the whole batch: broadcast on DEVICE (a [B, t]
    # host broadcast would be as large as the digits themselves at
    # t >= n/2)
    tweaks = jnp.broadcast_to(tweak1[None, :], (B, t))
    if _wire_packed(radix):
        x = _unpack_nibbles_j(x, n)

    p_blk = np.frombuffer(
        bytes([1, 2, 1]) + radix.to_bytes(3, "big") + bytes([10, u % 256])
        + n.to_bytes(4, "big") + t.to_bytes(4, "big"), np.uint8)
    e_p = encrypt_blocks(rks, jnp.asarray(p_blk)[None, :])  # CBC state after P

    zpad = jnp.zeros((B, qpad), jnp.uint8)

    def prf_y(half, m: int, round_i: int):
        """One round's y accumulated as unnormalized radix-m digits."""
        numb = _num_bytes(half, radix, b, msd_first=True)  # LSB-first
        rb = jnp.full((B, 1), round_i, jnp.uint8)
        q = jnp.concatenate(
            [tweaks, zpad, rb, jnp.flip(numb, 1).astype(jnp.uint8)],
            axis=1).reshape(B, nq, 16)
        acc = jnp.broadcast_to(e_p, (B, 16))
        for k in range(nq):
            acc = _enc_batch(rks, kp, acc ^ q[:, k], bitslice)
        s = acc
        if d > 16:
            nxb = (d - 1) // 16
            xs = jnp.stack(
                [acc ^ jnp.asarray(np.frombuffer(j.to_bytes(16, "big"),
                                                 np.uint8))
                 for j in range(1, nxb + 1)], axis=1)
            ext = _enc_batch(rks, kp, xs.reshape(B * nxb, 16), bitslice)
            s = jnp.concatenate([acc, ext.reshape(B, nxb * 16)], axis=1)
        vt = jnp.asarray(_ydig_table(radix, d, m))
        return s[:, :d].astype(jnp.int32) @ vt

    def enc_round(a, bb, m: int, i):
        yacc = prf_y(bb, m, i)
        c = _carry_scan(jnp.flip(a, 1).astype(jnp.int32) + yacc, radix)
        return bb, jnp.flip(c, 1)

    def dec_round(a, bb, m: int, i):
        yacc = prf_y(a, m, i)
        c = _carry_scan(jnp.flip(bb, 1).astype(jnp.int32) - yacc, radix)
        return jnp.flip(c, 1), a

    # A round PAIR restores the (u, v) half shapes, so fori_loop over 5
    # double-rounds traces the body once (vs 10 unrolled rounds).
    # int32 carries keep the fori_loop dtype-stable whatever x's dtype
    # (uint8 on the wire; the carry scans produce int32).
    a, bb = x[:, :u].astype(jnp.int32), x[:, u:].astype(jnp.int32)
    if encrypt:
        def dbl(j, st):
            a, bb = enc_round(*st, u, 2 * j)
            return enc_round(a, bb, v, 2 * j + 1)
    else:
        def dbl(j, st):
            a, bb = dec_round(*st, v, 9 - 2 * j)
            return dec_round(a, bb, u, 8 - 2 * j)
    a, bb = jax.lax.fori_loop(0, 5, dbl, (a, bb))
    out = jnp.concatenate([a, bb], axis=1)
    if _wire_packed(radix):
        return _pack_nibbles_j(out)
    # digits < radix <= 256: uint8 on the wire (the device-to-host copy
    # of the result is 4x smaller than the int32 carry-scan output)
    return out.astype(jnp.uint8)


_ff1_device = jax.jit(_ff1_core, static_argnames=(
    "radix", "n", "t", "encrypt", "bitslice"))


def _map_chunks(body, x2):
    """Run `body` over FPE_CHUNK-row chunks of x2 [B, wire] inside one
    jitted program: pad to a chunk multiple ON DEVICE (the pad rows
    never cross the link), lax.map so the chunk body traces/compiles
    ONCE (a single flat dispatch at B=100k compiled pathologically
    slowly), slice back to B ON DEVICE (the pad rows don't download
    either).  One upload + one dispatch + one download total."""
    b = x2.shape[0]
    nch = -(-b // FPE_CHUNK)
    x3 = jnp.pad(x2, ((0, nch * FPE_CHUNK - b), (0, 0))).reshape(
        nch, FPE_CHUNK, x2.shape[1])
    out = jax.lax.map(body, x3)
    return out.reshape(nch * FPE_CHUNK, -1)[:b]


@functools.partial(jax.jit, static_argnames=("radix", "n", "t", "encrypt",
                                             "bitslice"))
def _ff1_device_chunked(rks, kp, tweak1, x2, radix: int, n: int, t: int,
                        encrypt: bool, bitslice: bool):
    return _map_chunks(
        lambda c: _ff1_core(rks, kp, tweak1, c, radix, n, t, encrypt,
                            bitslice), x2)


# ---------------------------------------------------------------------------
# FF3 / FF3-1 (SP 800-38G §5.2; reference FF3_cipher micro_aes.c:2218-2248)
# ---------------------------------------------------------------------------


def _ff3_core(rks_rev, kp_rev, tl1, tr1, x, radix: int, n: int,
              encrypt: bool, bitslice: bool):
    """FF3 halves live MSD-first at the boundary but every NUM/STR in the
    spec reverses them first — NUM(REV(h)) = sum h[j]*radix^j, i.e. the
    boundary array read LSD-first.  So device-side the halves are used
    as-is with LSD-first tables and no data movement."""
    u, v = (n + 1) // 2, n - (n + 1) // 2
    B = x.shape[0]
    rev16 = jnp.arange(15, -1, -1)
    tl = jnp.broadcast_to(tl1[None, :], (B, 4))  # device-side broadcast
    tr = jnp.broadcast_to(tr1[None, :], (B, 4))
    if _wire_packed(radix):
        x = _unpack_nibbles_j(x, n)

    i_lane = (jnp.arange(4) == 3).astype(jnp.uint8)

    def round_y(half, m: int, even: bool, i):
        numb = _num_bytes(half, radix, 12, msd_first=False)
        w = tr if even else tl
        p = jnp.concatenate(
            [w ^ i_lane * i.astype(jnp.uint8),
             jnp.flip(numb, 1).astype(jnp.uint8)], axis=1)
        s = _enc_batch(rks_rev, kp_rev, p[:, rev16], bitslice)[:, rev16]
        vt = jnp.asarray(_ydig_table(radix, 16, m))
        return s.astype(jnp.int32) @ vt

    def enc_round(a, bb, m: int, even: bool, i):
        yacc = round_y(bb, m, even, i)
        return bb, _carry_scan(a.astype(jnp.int32) + yacc, radix)

    def dec_round(a, bb, m: int, even: bool, i):
        yacc = round_y(a, m, even, i)
        return _carry_scan(bb.astype(jnp.int32) - yacc, radix), a

    # fori_loop over double-rounds: shapes are (u, v)-periodic (see FF1)
    a, bb = x[:, :u].astype(jnp.int32), x[:, u:].astype(jnp.int32)
    if encrypt:
        def dbl(j, st):
            a, bb = enc_round(*st, u, True, 2 * j)
            return enc_round(a, bb, v, False, 2 * j + 1)
    else:
        def dbl(j, st):
            a, bb = dec_round(*st, v, False, 7 - 2 * j)
            return dec_round(a, bb, u, True, 6 - 2 * j)
    a, bb = jax.lax.fori_loop(0, 4, dbl, (a, bb))
    out = jnp.concatenate([a, bb], axis=1)
    if _wire_packed(radix):
        return _pack_nibbles_j(out)
    return out.astype(jnp.uint8)


_ff3_device = jax.jit(_ff3_core, static_argnames=(
    "radix", "n", "encrypt", "bitslice"))


@functools.partial(jax.jit, static_argnames=("radix", "n", "encrypt",
                                             "bitslice"))
def _ff3_device_chunked(rks_rev, kp_rev, tl1, tr1, x2, radix: int, n: int,
                        encrypt: bool, bitslice: bool):
    """Chunked-in-one-dispatch FF3 (see _map_chunks)."""
    return _map_chunks(
        lambda c: _ff3_core(rks_rev, kp_rev, tl1, tr1, c, radix, n,
                            encrypt, bitslice), x2)


# ---------------------------------------------------------------------------
# Batched front-end (groups tokens by length -> one dispatch per group)
# ---------------------------------------------------------------------------


from ..utils.keycache import key_cache


@key_cache(maxsize=64)
def _rks(key: bytes):
    return jnp.asarray(expand_key(key))


@key_cache(maxsize=64)
def _kp(key: bytes):
    from ..core.bitslice import key_planes

    return jnp.asarray(key_planes(expand_key(key)))


@functools.lru_cache(maxsize=64)
def _ascii_luts(chars: str):
    """(char->digit, digit->char) numpy LUTs for pure-ASCII alphabets, or
    None — the vectorized codec for the bulk path (the per-char
    chars.index of FPE_cipher's boundary, micro_aes.c:2287-2303, is
    host-Python cost that would dwarf the device work at 10k tokens)."""
    if any(ord(c) > 126 for c in chars):
        return None
    enc = np.full(128, -1, np.int32)
    for i, c in enumerate(chars):
        enc[ord(c)] = i
    dec = np.frombuffer(chars.encode("ascii"), np.uint8)
    return enc, dec


# Batches above one chunk run as a lax.map over fixed-size chunks INSIDE
# one jitted dispatch: one upload, one dispatch, one download, and the
# program compiles at the chunk shape however large the batch is.
FPE_CHUNK = 32768


def _dispatch_digits(key: bytes, tweak: bytes, x: np.ndarray, radix: int,
                     n: int, method: str, encrypt: bool) -> np.ndarray:
    """Bulk device FPE over a digit matrix: pad the batch to a 32
    multiple (so the PRF can ride the bitsliced plane cipher), ship
    packed digits (2/byte for radix <= 16,
    else 1/byte), one device dispatch regardless of batch size."""
    b = x.shape[0]
    bitslice = _use_bitslice()
    packed = _wire_packed(radix)
    xu = np.ascontiguousarray(x, np.uint8)

    if method == "ff1":
        tw1 = jnp.asarray(np.frombuffer(tweak, np.uint8))
        args = (_rks(key), _kp(key), tw1)
        statics = (radix, n, len(tweak), encrypt, bitslice)
        run, run_chunked = _ff1_device, _ff1_device_chunked
    elif method in ("ff3", "ff3-1"):
        tl, tr = _split_tweak(tweak)
        rkey = bytes(reversed(key))
        tl1 = jnp.asarray(np.frombuffer(tl, np.uint8))
        tr1 = jnp.asarray(np.frombuffer(tr, np.uint8))
        args = (_rks(rkey), _kp(rkey), tl1, tr1)
        statics = (radix, n, encrypt, bitslice)
        run, run_chunked = _ff3_device, _ff3_device_chunked
    else:
        raise ValueError(f"unknown FPE method {method!r}")

    # only the REAL rows cross the link; above one chunk the lax.map
    # form runs and its chunk padding happens (and stays) on device
    # inside _map_chunks
    bp = b + ((-b) % 32)
    if bp != b:
        xu = np.concatenate([xu, np.broadcast_to(xu[:1], (bp - b, n))])
    wire = _pack_nibbles_np(xu) if packed else xu
    fn = run_chunked if b > FPE_CHUNK else run
    res = np.asarray(fn(*args, jnp.asarray(wire), *statics))
    if packed:
        return _unpack_nibbles_np(res[:b], n)
    return res[:b]


def fpe_encrypt_digits(key, tweak, digits: np.ndarray, radix: int,
                       method: str = "ff1") -> np.ndarray:
    """Zero-string bulk FPE: encrypt a uint8[B, n] digit matrix (values
    in [0, radix)) in one device dispatch.  This is the production bulk
    path — the string APIs (fpe_encrypt_batch) cost a per-token Python
    boundary the reference's char* interface forces (micro_aes.c:
    2287-2303) but an array interface does not."""
    d = np.asarray(digits)
    if d.ndim != 2:
        raise EncryptionError("digits must be a [B, n] matrix")
    if not 2 <= radix <= MAX_DEVICE_RADIX:
        raise EncryptionError(f"radix {radix} outside device range")
    return _dispatch_digits(bytes(key), bytes(tweak) if tweak else b"",
                            d, radix, d.shape[1], method.lower(), True)


def fpe_decrypt_digits(key, tweak, digits: np.ndarray, radix: int,
                       method: str = "ff1") -> np.ndarray:
    """Inverse of fpe_encrypt_digits."""
    d = np.asarray(digits)
    if d.ndim != 2:
        raise DecryptionError("digits must be a [B, n] matrix")
    if not 2 <= radix <= MAX_DEVICE_RADIX:
        raise DecryptionError(f"radix {radix} outside device range")
    return _dispatch_digits(bytes(key), bytes(tweak) if tweak else b"",
                            d, radix, d.shape[1], method.lower(), False)


def _fpe_batch(key, tweak, tokens, alphabet, method: str,
               encrypt: bool) -> list[str]:
    alpha = resolve_alphabet(alphabet)
    method = method.lower()
    err = EncryptionError if encrypt else DecryptionError
    if alpha.radix > MAX_DEVICE_RADIX:
        from . import fpe_decrypt, fpe_encrypt  # host fallback

        fn = fpe_encrypt if encrypt else fpe_decrypt
        return [fn(key, tweak, tok, alpha, method) for tok in tokens]

    key = bytes(key)
    tweak = bytes(tweak) if tweak else b""
    tokens = [str(t) for t in tokens]
    for tok in tokens:
        if len(tok) < alpha.min_len:
            raise err(f"input shorter than MINLEN={alpha.min_len}")
        if method in ("ff3", "ff3-1") and len(tok) > alpha.max_len_ff3():
            raise err(f"input longer than MAXLEN={alpha.max_len_ff3()}")

    groups: dict[int, list[int]] = {}
    for i, tok in enumerate(tokens):
        groups.setdefault(len(tok), []).append(i)
    luts = _ascii_luts(alpha.chars)

    out: list[str | None] = [None] * len(tokens)
    for n, idxs in groups.items():
        joined = "".join(tokens[i] for i in idxs)
        if luts is not None and joined.isascii():
            codes = np.frombuffer(joined.encode("ascii"), np.uint8)
            x = luts[0][codes].reshape(len(idxs), n)
            if (x < 0).any():
                raise err("invalid character for alphabet")
        else:
            try:
                x = np.asarray([alpha.encode(tokens[i]) for i in idxs],
                               np.int32)
            except EncryptionError:
                raise err("invalid character for alphabet")
        res = _dispatch_digits(key, tweak, x, alpha.radix, n, method,
                               encrypt)[: len(idxs)]
        if luts is not None:
            flat = luts[1][res.reshape(-1)].tobytes().decode("ascii")
            for k, i in enumerate(idxs):
                out[i] = flat[k * n: (k + 1) * n]
        else:
            for k, i in enumerate(idxs):
                out[i] = alpha.decode(res[k])
    return out  # type: ignore[return-value]


def fpe_encrypt_batch(key, tweak, plaintexts, alphabet="digits",
                      method: str = "ff1") -> list[str]:
    """AES_FPE_encrypt over N tokens in one device dispatch per distinct
    token length (micro_aes.c:2326-2331, batched)."""
    return _fpe_batch(key, tweak, plaintexts, alphabet, method, True)


def fpe_decrypt_batch(key, tweak, ciphertexts, alphabet="digits",
                      method: str = "ff1") -> list[str]:
    """AES_FPE_decrypt over N tokens, batched (micro_aes.c:2343-2348)."""
    return _fpe_batch(key, tweak, ciphertexts, alphabet, method, False)
