"""Multi-message batch engines for the serial-chain + basic modes.

CBC/CFB encrypt and the OFB keystream are loop-carried chains (reference
loops micro_aes.c:712-717, 808-814, 872-876): within one message they
must run serially, so across messages is where the device parallelism
lives (SURVEY §2.6 "sequential-chain engine").  These engines vmap the
_scan.py chains over a message batch — one device dispatch per
(block-bucket, key-size) group instead of one per message — and batch
the already-parallel directions (CBC/CFB decrypt, ECB, CTR) the same
way.  CTS splicing, padding, and ragged tails are host glue exactly
mirroring the per-message modules (cbc.py / cfb.py / ofb.py / ecb.py /
ctr.py), which the tests use as the oracle.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import DataLengthError, DecryptionError
from ..ops.counter import counter_blocks
from ..utils.bytesio import BLOCK, block_bucket
from ._scan import cbc_encrypt_scan, cfb_encrypt_scan, ofb_keystream_scan
from .common import PAD_ZERO, pad_message, to_u8
from .ctr import CTR_START_VALUE

_cbc_vscan = jax.jit(jax.vmap(cbc_encrypt_scan, in_axes=(0, 0, 0)))
_cfb_vscan = jax.jit(jax.vmap(cfb_encrypt_scan, in_axes=(0, 0, 0)))
_ofb_vscan = jax.jit(jax.vmap(ofb_keystream_scan, in_axes=(0, 0, 0)))

from .bulk import cipher_blocks_multikey, stack_round_keys  # noqa: E402


def _grouped(blocklists: list[np.ndarray], keys: list[bytes]):
    """Yield (bucket, idxs, rks[B,R+1,16] numpy, padded_blocks[B,nb,16])
    with one jit specialization per (bucket, key size)."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, bl in enumerate(blocklists):
        b = block_bucket(max(len(bl), 1))
        groups.setdefault((b, len(keys[i])), []).append(i)
    for (b, _), idxs in groups.items():
        rks = stack_round_keys([keys[i] for i in idxs])
        buf = np.zeros((len(idxs), b, BLOCK), np.uint8)
        for k, i in enumerate(idxs):
            buf[k, : len(blocklists[i])] = blocklists[i]
        yield idxs, rks, buf


def _chain_group(kind: str, rks: np.ndarray, ivb: np.ndarray,
                 buf: np.ndarray) -> np.ndarray:
    """Run one (bucket, key-size) group of serial chains as the vmapped
    per-message scan.  For OFB, buf's block contents are ignored
    (keystream only)."""
    rj, ivj = jnp.asarray(rks), jnp.asarray(ivb)
    if kind == "cbc":
        return np.asarray(_cbc_vscan(rj, ivj, jnp.asarray(buf)))
    if kind == "cfb":
        return np.asarray(_cfb_vscan(rj, ivj, jnp.asarray(buf)))
    return np.asarray(_ofb_vscan(rj, ivj, jnp.asarray(buf[..., :1])))


# ---------------------------------------------------------------------------
# CBC (+CS3 ciphertext stealing) — micro_aes.c:687-783, batched
# ---------------------------------------------------------------------------


def cbc_encrypt_batch(keys, ivs, pts, cts: bool = True,
                      padding: int = PAD_ZERO) -> list[bytes]:
    """AES_CBC_encrypt over B messages: the per-message serial chains run
    vmapped.  The CTS stolen block is just one more chain step
    (stolen = E(c_last ^ padded_tail)), so it rides the same scan."""
    keys = [bytes(k) for k in keys]
    iv_arr = [to_u8(iv)[:BLOCK] for iv in ivs]
    datas = [to_u8(p) for p in pts]
    chains: list[np.ndarray] = []
    meta: list[tuple[int, int]] = []  # (n full chain blocks, r tail bytes)
    for d in datas:
        n, r = len(d) // BLOCK, len(d) % BLOCK
        if cts:
            if n > 1 and r == 0:
                n -= 1
                r = BLOCK
            if n == 0:
                raise DataLengthError("CBC-CTS needs at least one full block")
            blocks = d[: n * BLOCK].reshape(n, BLOCK)
            if r:
                tail = np.zeros(BLOCK, np.uint8)
                tail[:r] = d[n * BLOCK: n * BLOCK + r]
                blocks = np.concatenate([blocks, tail[None, :]], axis=0)
            chains.append(blocks)
            meta.append((n, r))
        else:
            padded, _ = pad_message(d, padding)
            chains.append(padded.reshape(-1, BLOCK))
            meta.append((len(padded) // BLOCK, 0))

    out: list[bytes | None] = [None] * len(datas)
    for idxs, rks, buf in _grouped(chains, keys):
        ivb = np.stack([iv_arr[i] for i in idxs])
        ys = _chain_group("cbc", rks, ivb, buf)
        for k, i in enumerate(idxs):
            n, r = meta[i]
            c = ys[k]
            if cts and r:
                # CS3 swap (micro_aes.c:718-732): stolen replaces C_{n-1};
                # its first r bytes become the final chunk
                out[i] = bytes(np.concatenate(
                    [c[: n - 1].reshape(-1), c[n], c[n - 1][:r]]))
            else:
                out[i] = bytes(c[: n].reshape(-1))
    return out  # type: ignore[return-value]


def cbc_decrypt_batch(keys, ivs, cts_in, cts: bool = True) -> list[bytes]:
    """AES_CBC_decrypt over B messages (block-parallel per message, so
    the batch is one flat decrypt; the CTS tail adds a second one-block
    stage for the spliced Y blocks, micro_aes.c:753-778)."""
    keys = [bytes(k) for k in keys]
    iv_arr = [to_u8(iv)[:BLOCK] for iv in ivs]
    datas = [to_u8(c) for c in cts_in]
    blocklists: list[np.ndarray] = []
    meta: list[tuple[int, int]] = []
    for d in datas:
        n, r = len(d) // BLOCK, len(d) % BLOCK
        if cts:
            if n > 1 and r == 0:
                n -= 1
                r = BLOCK
            if n == 0:
                raise DataLengthError("CBC-CTS needs at least one full block")
        elif r != 0:
            raise DataLengthError("ciphertext must be a block multiple")
        blocklists.append(d[: n * BLOCK].reshape(n, BLOCK))
        meta.append((n, r))

    out: list[bytes | None] = [None] * len(datas)
    pending: list[tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
    for idxs, rks, buf in _grouped(blocklists, keys):
        dec = cipher_blocks_multikey([keys[i] for i in idxs], buf,
                                     decrypt=True)
        for k, i in enumerate(idxs):
            n, r = meta[i]
            d = datas[i]
            if r == 0:
                blocks = blocklists[i]
                prev = np.concatenate([iv_arr[i][None, :], blocks[:-1]],
                                      axis=0)
                out[i] = bytes((dec[k, : n] ^ prev).reshape(-1))
                continue
            # CTS: chunks are head (m full), X (full), Z (r bytes)
            m = n - 1
            head = blocklists[i][:m]
            dx = dec[k, m]  # D(X): X was appended as block m
            z = d[m * BLOCK + BLOCK:]
            p_tail = dx[:r] ^ z
            y = dx.copy()
            y[:r] = z
            body = (dec[k, :m] ^ np.concatenate(
                [iv_arr[i][None, :], head[:-1]], axis=0)).reshape(-1) \
                if m else np.zeros(0, np.uint8)
            prev_iv = head[-1] if m else iv_arr[i]
            pending.append((i, y, prev_iv, p_tail))
            out[i] = bytes(body)  # completed below
    if pending:
        ys = np.stack([y for _, y, _, _ in pending])[:, None, :]
        dy = cipher_blocks_multikey(
            [keys[i] for i, _, _, _ in pending], ys, decrypt=True)[:, 0]
        for k, (i, _, prev_iv, p_tail) in enumerate(pending):
            out[i] = out[i] + bytes(dy[k] ^ prev_iv) + bytes(p_tail)
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# CFB — micro_aes.c:789-846, batched
# ---------------------------------------------------------------------------


def cfb_encrypt_batch(keys, ivs, pts) -> list[bytes]:
    """CFB encrypt chains vmapped; the ragged-tail keystream E(y_last) is
    the scan's next step over a zero block (y = E(carry) ^ 0)."""
    keys = [bytes(k) for k in keys]
    iv_arr = [to_u8(iv)[:BLOCK] for iv in ivs]
    datas = [to_u8(p) for p in pts]
    chains, meta = [], []
    for d in datas:
        n, r = len(d) // BLOCK, len(d) % BLOCK
        blocks = np.zeros((n + (1 if r else 0), BLOCK), np.uint8)
        if n:
            blocks[:n] = d[: n * BLOCK].reshape(n, BLOCK)
        chains.append(blocks)
        meta.append((n, r))
    out: list[bytes | None] = [None] * len(datas)
    for idxs, rks, buf in _grouped(chains, keys):
        ivb = np.stack([iv_arr[i] for i in idxs])
        ys = _chain_group("cfb", rks, ivb, buf)
        for k, i in enumerate(idxs):
            n, r = meta[i]
            body = ys[k, :n].reshape(-1)
            if r:
                tail = ys[k, n][:r] ^ datas[i][n * BLOCK:]
                body = np.concatenate([body, tail])
            out[i] = bytes(body)
    return out  # type: ignore[return-value]


def cfb_decrypt_batch(keys, ivs, cts_in) -> list[bytes]:
    """CFB decrypt is parallel: keystream blocks are E([iv, C_0..]) —
    one flat batched encrypt (micro_aes.c:799-817, mode=0)."""
    keys = [bytes(k) for k in keys]
    iv_arr = [to_u8(iv)[:BLOCK] for iv in ivs]
    datas = [to_u8(c) for c in cts_in]
    ins, meta = [], []
    for i, d in enumerate(datas):
        n, r = len(d) // BLOCK, len(d) % BLOCK
        nin = n + (1 if r else 0)
        blocks = np.zeros((max(nin, 1), BLOCK), np.uint8)
        blocks[0] = iv_arr[i]
        if nin > 1:
            blocks[1:nin] = d[: (nin - 1) * BLOCK].reshape(nin - 1, BLOCK)
        ins.append(blocks)
        meta.append(nin)
    out: list[bytes | None] = [None] * len(datas)
    for idxs, rks, buf in _grouped(ins, keys):
        ks = cipher_blocks_multikey([keys[i] for i in idxs], buf)
        for k, i in enumerate(idxs):
            d = datas[i]
            out[i] = bytes(ks[k].reshape(-1)[: len(d)] ^ d)
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# OFB — micro_aes.c:852-893, batched (decrypt == encrypt)
# ---------------------------------------------------------------------------


def ofb_xcrypt_batch(keys, ivs, datas_in) -> list[bytes]:
    keys = [bytes(k) for k in keys]
    iv_arr = [to_u8(iv)[:BLOCK] for iv in ivs]
    datas = [to_u8(p) for p in datas_in]
    dummies = [np.zeros(((len(d) + BLOCK - 1) // BLOCK, 1), np.uint8)
               for d in datas]
    out: list[bytes | None] = [None] * len(datas)
    for idxs, rks, buf in _grouped(dummies, keys):
        ivb = np.stack([iv_arr[i] for i in idxs])
        ks = _chain_group("ofb", rks, ivb, buf)
        for k, i in enumerate(idxs):
            d = datas[i]
            out[i] = bytes(ks[k].reshape(-1)[: len(d)] ^ d)
    return out  # type: ignore[return-value]


ofb_encrypt_batch = ofb_xcrypt_batch
ofb_decrypt_batch = ofb_xcrypt_batch


# ---------------------------------------------------------------------------
# ECB — micro_aes.c:628-681, batched
# ---------------------------------------------------------------------------


def ecb_encrypt_batch(keys, pts, padding: int = PAD_ZERO) -> list[bytes]:
    keys = [bytes(k) for k in keys]
    blocklists = [pad_message(to_u8(p), padding)[0].reshape(-1, BLOCK)
                  for p in pts]
    out: list[bytes | None] = [None] * len(pts)
    for idxs, rks, buf in _grouped(blocklists, keys):
        enc = cipher_blocks_multikey([keys[i] for i in idxs], buf)
        for k, i in enumerate(idxs):
            n = len(blocklists[i])
            out[i] = bytes(enc[k, :n].reshape(-1))
    return out  # type: ignore[return-value]


def ecb_decrypt_batch(keys, cts_in) -> list[bytes]:
    keys = [bytes(k) for k in keys]
    datas = [to_u8(c) for c in cts_in]
    for d in datas:
        if len(d) % BLOCK:
            raise DecryptionError("ciphertext has a partial block")
    blocklists = [d.reshape(-1, BLOCK) for d in datas]
    out: list[bytes | None] = [None] * len(datas)
    for idxs, rks, buf in _grouped(blocklists, keys):
        dec = cipher_blocks_multikey([keys[i] for i in idxs], buf,
                                     decrypt=True)
        for k, i in enumerate(idxs):
            n = len(blocklists[i])
            out[i] = bytes(dec[k, :n].reshape(-1))
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# CTR — micro_aes.c:953-991, batched (embarrassingly parallel both ways)
# ---------------------------------------------------------------------------


def ctr_xcrypt_batch(keys, ivs, datas_in,
                     preset_counter: bool = False) -> list[bytes]:
    """AES-CTR over B messages: per-message counter streams generated on
    device, one flat batched encrypt per group."""
    keys = [bytes(k) for k in keys]
    datas = [to_u8(p) for p in datas_in]
    bases = []
    for iv in ivs:
        base = np.zeros(BLOCK, np.uint8)
        if preset_counter:
            base[:] = to_u8(iv)[:BLOCK]
        else:
            base[:12] = to_u8(iv)[:12]
            base[BLOCK - 1] ^= CTR_START_VALUE
        bases.append(base)
    dummies = [np.zeros(((len(d) + BLOCK - 1) // BLOCK, 1), np.uint8)
               for d in datas]
    out: list[bytes | None] = [None] * len(datas)
    for idxs, rks, buf in _grouped(dummies, keys):
        nb = buf.shape[1]
        bb = jnp.asarray(np.stack([bases[i] for i in idxs]))
        ctrs = jax.vmap(lambda b: counter_blocks(b, nb, 0, "be"))(bb)
        ks = cipher_blocks_multikey([keys[i] for i in idxs],
                                    np.asarray(ctrs))
        for k, i in enumerate(idxs):
            d = datas[i]
            out[i] = bytes(ks[k].reshape(-1)[: len(d)] ^ d)
    return out  # type: ignore[return-value]


ctr_encrypt_batch = ctr_xcrypt_batch
ctr_decrypt_batch = ctr_xcrypt_batch
