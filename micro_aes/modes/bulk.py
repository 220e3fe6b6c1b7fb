"""Batched multi-message engines: many independent (key, nonce, message)
tuples in one device dispatch.

This is both the conformance-suite workhorse (CAVP files carry thousands
of single-use keys, so per-key precomputation can't amortize — instead the
whole file becomes a handful of batched device calls) and the multi-stream
serving path (parallel/ shards the batch axis over the mesh).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.cipher import encrypt_blocks, decrypt_blocks
from ..core.keyschedule import expand_key
from ..ops.counter import counter_blocks
from ..ops.mac import cbcmac_fold_batch, ghash_fold_batch
from ..utils.bytesio import BLOCK
from .common import to_u8

_enc_vmap = jax.jit(jax.vmap(encrypt_blocks))
_dec_vmap = jax.jit(jax.vmap(decrypt_blocks))


from ..utils.keycache import key_cache


@key_cache(maxsize=65536)
def _expand_cached(key: bytes) -> np.ndarray:
    return expand_key(key)


def stack_round_keys(keys: list[bytes]) -> np.ndarray:
    """uint8[B, rounds+1, 16] round-key stack.  Large same-size batches
    expand VECTORIZED (one schedule recurrence over the whole batch,
    core/keyschedule.expand_keys_batch) — the batch engines see
    thousands of single-use keys per call, where per-key expansion was
    the top host cost; small batches keep the per-key cache."""
    keys = [bytes(k) for k in keys]
    if len(keys) >= 32 and len({len(k) for k in keys}) == 1:
        from ..core.keyschedule import expand_keys_batch

        return expand_keys_batch(
            np.frombuffer(b"".join(keys), np.uint8)
            .reshape(len(keys), len(keys[0])))
    return np.stack([_expand_cached(k) for k in keys])


def _regroup_mixed_keys(nlists: int):
    """Make a batch engine accept mixed AES key sizes in one call.

    Round-key schedules of different key sizes have different round
    counts and cannot stack into one array, so a mixed batch is split
    into per-key-size sub-batches (at most 3) and the results are
    reassembled in order.  `nlists` counts the per-message list
    arguments that follow `keys`; anything after them passes through
    unchanged.  Arguments are bound by SIGNATURE, so keyword-passed
    lists regroup correctly too.  An empty batch returns []."""
    import inspect

    def deco(fn):
        params = list(inspect.signature(fn).parameters)

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            bound = inspect.signature(fn).bind(*args, **kw)
            bound.apply_defaults()
            keys = [bytes(k) for k in bound.arguments[params[0]]]
            sizes = {len(k) for k in keys}
            if not keys:
                return []
            if len(sizes) == 1:
                bound.arguments[params[0]] = keys
                return fn(*bound.args, **bound.kwargs)
            lists = [list(bound.arguments[p]) for p in params[1: 1 + nlists]]
            out: list = [None] * len(keys)
            for klen in sorted(sizes):
                idxs = [i for i, k in enumerate(keys) if len(k) == klen]
                bound.arguments[params[0]] = [keys[i] for i in idxs]
                for p, lst in zip(params[1: 1 + nlists], lists):
                    bound.arguments[p] = [lst[i] for i in idxs]
                sub = fn(*bound.args, **bound.kwargs)
                for j, i in enumerate(idxs):
                    out[i] = sub[j]
            return out
        return wrapper
    return deco


def cipher_blocks_multikey(keys: list, blocks, decrypt: bool = False
                           ) -> np.ndarray:
    """E/D over uint8[B, nb, 16] with a key per row (the vmapped
    table-form cipher)."""
    blocks = np.ascontiguousarray(blocks, np.uint8)
    keys = [bytes(k) for k in keys]
    if len({len(k) for k in keys}) > 1:
        # mixed key sizes: per-row round counts differ, so the stacked
        # path cannot mix them — process each size class and reassemble
        out = np.empty_like(blocks)
        for klen in sorted({len(k) for k in keys}):
            idxs = [i for i, k in enumerate(keys) if len(k) == klen]
            out[idxs] = cipher_blocks_multikey(
                [keys[i] for i in idxs], blocks[idxs], decrypt)
        return out
    return np.asarray(cipher_blocks_multikey_dev(keys, blocks, decrypt))


def cipher_blocks_multikey_dev(keys: list, blocks, decrypt: bool = False):
    """Device-resident form of cipher_blocks_multikey: uint8[B,nb,16] in
    (host or device) -> jnp uint8[B,nb,16] out, so intermediate data of
    the batch engines never leaves the device."""
    keys = [bytes(k) for k in keys]
    if len({len(k) for k in keys}) > 1:
        return jnp.asarray(
            cipher_blocks_multikey(keys, np.asarray(blocks), decrypt))
    rks = jnp.asarray(stack_round_keys(keys))
    return (_dec_vmap if decrypt else _enc_vmap)(rks, jnp.asarray(blocks))


def _pad_blocks_batch(datas: list[np.ndarray], nblocks: int) -> np.ndarray:
    out = np.zeros((len(datas), nblocks, BLOCK), np.uint8)
    for i, d in enumerate(datas):
        out[i].reshape(-1)[: len(d)] = d
    return out


def _batch_j0(rks, nonces: list[np.ndarray], h: np.ndarray) -> np.ndarray:
    """Per-message J0: 12-byte fast path on host, GHASH path batched."""
    B = len(nonces)
    j0 = np.zeros((B, BLOCK), np.uint8)
    long_idx = [i for i, n in enumerate(nonces) if len(n) != 12]
    for i, n in enumerate(nonces):
        if len(n) == 12:
            j0[i, :12] = n
            j0[i, 15] = 1
    if long_idx:
        miv = max((len(nonces[i]) + BLOCK - 1) // BLOCK for i in long_idx) + 1
        ivb = np.zeros((len(long_idx), miv, BLOCK), np.uint8)
        nv = np.zeros(len(long_idx), np.int32)
        for k, i in enumerate(long_idx):
            n = nonces[i]
            nb = (len(n) + BLOCK - 1) // BLOCK
            ivb[k].reshape(-1)[: len(n)] = n
            ivb[k, nb, 8:] = np.frombuffer((len(n) * 8).to_bytes(8, "big"), np.uint8)
            nv[k] = nb + 1
        g = ghash_fold_batch(
            jnp.asarray(h[long_idx]),
            jnp.zeros((len(long_idx), BLOCK), jnp.uint8),
            jnp.asarray(ivb), jnp.asarray(nv),
        )
        j0[long_idx] = np.asarray(g)
    return j0


def _batch_tag_ghash(h: np.ndarray, aads: list[np.ndarray],
                     cts: list[np.ndarray], nks: int) -> np.ndarray:
    """GHASH(AAD, CT, len-block) for every message, batched."""
    B = len(aads)
    maad = max((len(a) + BLOCK - 1) // BLOCK for a in aads) if aads else 0
    m = maad + nks + 1
    gb = np.zeros((B, m, BLOCK), np.uint8)
    nv = np.zeros(B, np.int32)
    for i in range(B):
        a, c = aads[i], cts[i]
        na = (len(a) + BLOCK - 1) // BLOCK
        nc = (len(c) + BLOCK - 1) // BLOCK
        gb[i, :na].reshape(-1)[: len(a)] = a
        gb[i, na: na + nc].reshape(-1)[: len(c)] = c
        gb[i, na + nc, :8] = np.frombuffer((len(a) * 8).to_bytes(8, "big"), np.uint8)
        gb[i, na + nc, 8:] = np.frombuffer((len(c) * 8).to_bytes(8, "big"), np.uint8)
        nv[i] = na + nc + 1
    return np.asarray(
        ghash_fold_batch(jnp.asarray(h), jnp.zeros((B, BLOCK), jnp.uint8),
                         jnp.asarray(gb), jnp.asarray(nv))
    )


@_regroup_mixed_keys(3)
def gcm_encrypt_batch(keys: list[bytes], nonces: list[bytes], aads: list[bytes],
                      pts: list[bytes], tag_len: int = 16) -> list[bytes]:
    """AES-GCM over B independent messages; a fixed number of batched
    device dispatches regardless of B.  Returns [ct || tag] per message."""
    B = len(keys)
    rks = jnp.asarray(stack_round_keys(keys))
    aads = [to_u8(a) for a in aads]
    pts = [to_u8(p) for p in pts]
    nonces = [to_u8(n) for n in nonces]

    # H = E_K(0) for every key
    h = np.asarray(_enc_vmap(rks, jnp.zeros((B, 1, BLOCK), jnp.uint8)))[:, 0]
    j0 = _batch_j0(rks, nonces, h)

    # CTR body (counter = J0 + 1 + i) and E(J0) in one keystream batch:
    # prepend the J0 block itself so its encryption rides along.
    npt = max((len(p) for p in pts), default=0)
    nks = (npt + BLOCK - 1) // BLOCK
    ctrs = jax.vmap(lambda b: counter_blocks(b, nks + 1, 0, "be"))(jnp.asarray(j0))
    ks_all = cipher_blocks_multikey(keys, np.asarray(ctrs))
    ek_j0, ks = ks_all[:, 0], ks_all[:, 1:]

    cts = [bytes(p ^ ks[i].reshape(-1)[: len(p)]) for i, p in enumerate(pts)]

    g = _batch_tag_ghash(h, aads, [np.frombuffer(c, np.uint8) for c in cts], nks)
    tags = ek_j0 ^ g
    return [cts[i] + bytes(tags[i][:tag_len]) for i in range(B)]


@_regroup_mixed_keys(3)
def gcm_decrypt_batch(keys: list[bytes], nonces: list[bytes], aads: list[bytes],
                      ct_tags: list[bytes], tag_len: int = 16,
                      ) -> list[bytes | None]:
    """Batched GCM open with the reference's verify-BEFORE-decrypt
    ordering (micro_aes.c:1204-1209): the expected tag is computed from
    the ciphertext first; messages whose tag fails come back as None and
    are never decrypted (their keystream lane is discarded)."""
    from ..utils.bytesio import verify_tag

    B = len(keys)
    rks = jnp.asarray(stack_round_keys(keys))
    aads = [to_u8(a) for a in aads]
    nonces = [to_u8(n) for n in nonces]
    data = [to_u8(c) for c in ct_tags]
    cts = [d[: len(d) - tag_len] for d in data]
    tags = [bytes(d[len(d) - tag_len:]) for d in data]

    h = np.asarray(_enc_vmap(rks, jnp.zeros((B, 1, BLOCK), jnp.uint8)))[:, 0]
    j0 = _batch_j0(rks, nonces, h)

    nks = max(((len(c) + BLOCK - 1) // BLOCK for c in cts), default=0)
    ctrs = jax.vmap(lambda b: counter_blocks(b, nks + 1, 0, "be"))(jnp.asarray(j0))
    ks_all = cipher_blocks_multikey(keys, np.asarray(ctrs))
    ek_j0, ks = ks_all[:, 0], ks_all[:, 1:]

    g = _batch_tag_ghash(h, aads, cts, nks)
    expects = ek_j0 ^ g
    out: list[bytes | None] = []
    for i, c in enumerate(cts):
        if not verify_tag(expects[i][:tag_len], tags[i]):
            out.append(None)
            continue
        out.append(bytes(c ^ ks[i].reshape(-1)[: len(c)]))
    return out


@_regroup_mixed_keys(1)
def cmac_batch(keys: list[bytes], msgs: list[bytes]) -> list[bytes]:
    """AES-CMAC over B independent messages in one batched fold."""
    from ..ops.mac import double_be_np

    B = len(keys)
    rks = stack_round_keys(keys)  # folds take the HOST stack (no pull)
    msgs = [bytes(to_u8(m)) for m in msgs]
    L = np.asarray(_enc_vmap(jnp.asarray(rks),
                             jnp.zeros((B, 1, BLOCK), jnp.uint8)))[:, 0]
    k1 = double_be_np(L)
    k2 = double_be_np(k1)

    m = max(((len(x) - 1) // BLOCK + 1) if x else 1 for x in msgs)
    blocks = np.zeros((B, m, BLOCK), np.uint8)
    nv = np.zeros(B, np.int32)
    for i, x in enumerate(msgs):
        n = len(x)
        s = (n - 1) % BLOCK + 1 if n else 0
        nb = (n - s) // BLOCK
        blocks[i, :nb] = np.frombuffer(x[: n - s], np.uint8).reshape(nb, BLOCK)
        last = np.zeros(BLOCK, np.uint8)
        last[:s] = np.frombuffer(x[n - s:], np.uint8)
        if s < BLOCK:
            last[s] ^= 0x80
            last ^= k2[i]
        else:
            last ^= k1[i]
        blocks[i, nb] = last
        nv[i] = nb + 1
    out = cbcmac_fold_batch(rks, jnp.zeros((B, BLOCK), jnp.uint8),
                            jnp.asarray(blocks), jnp.asarray(nv))
    return [bytes(t) for t in np.asarray(out)]


@_regroup_mixed_keys(2)
def xts_batch(keys: list[bytes], tweaks: list[bytes], datas: list[bytes],
              encrypt: bool) -> list[bytes]:
    """Batched XEX over B messages of identical whole-block length."""
    from ..ops.mac import double_le_np

    B = len(keys)
    keys = [bytes(k) for k in keys]
    klen = len(keys[0]) // 2
    rks2 = jnp.asarray(stack_round_keys([k[klen:] for k in keys]))
    n = len(datas[0]) // BLOCK
    t0 = np.asarray(
        _enc_vmap(rks2, jnp.asarray(np.stack([to_u8(t)[:16] for t in tweaks])[:, None, :]))
    )[:, 0]
    tw = np.zeros((B, n, BLOCK), np.uint8)
    t = t0
    for i in range(n):
        tw[:, i] = t
        t = double_le_np(t)
    x = np.stack([to_u8(d).reshape(n, BLOCK) for d in datas])
    y = np.asarray(cipher_blocks_multikey_dev(
        [k[:klen] for k in keys], jnp.asarray(x ^ tw),
        decrypt=not encrypt)) ^ tw
    return [bytes(y[i].reshape(-1)) for i in range(B)]


# ---------------------------------------------------------------------------
# Batched CCM / EAX: fused CTR bodies + batched CBC-MAC folds (the
# conformance corpora and multi-stream serving run these as a handful of
# device dispatches regardless of B)
# ---------------------------------------------------------------------------


def _enc1_batch(rks, blocks: np.ndarray) -> np.ndarray:
    """E_K_i(block_i) for B (key, block) pairs in one dispatch."""
    return np.asarray(_enc_vmap(rks, jnp.asarray(blocks[:, None, :])))[:, 0]


def _eax_subkeys(rks, B: int):
    """L = E_K(0) per key (one small dispatch), K1/K2 host-side."""
    from ..ops.mac import double_be_np

    L = _enc1_batch(rks, np.zeros((B, BLOCK), np.uint8))
    k1 = double_be_np(L)
    return k1, double_be_np(k1)


def _omac_small_dev(rks, k1, k2, t: int, datas: list[np.ndarray]):
    """Batched EAX OMAC (micro_aes.c:1531-1549) over B SMALL host byte
    strings (nonces / headers): the tweak block [0..0,t] is prepended to
    the fold (fold(0, [T, ...]) == fold(E(T), ...)), so no extra cipher
    dispatch exists; empty data folds the single block T ^ K1.  Returns
    the macs ON DEVICE."""
    B = len(datas)
    m = max((max((len(d) - 1) // BLOCK + 1, 1) for d in datas if len(d)),
            default=0)
    blocks = np.zeros((B, 1 + m, BLOCK), np.uint8)
    nv = np.zeros(B, np.int32)
    for i, d in enumerate(datas):
        blocks[i, 0, BLOCK - 1] = t
        n = len(d)
        if not n:
            blocks[i, 0] ^= k1[i]
            nv[i] = 1
            continue
        s = (n - 1) % BLOCK + 1
        nb = (n - s) // BLOCK
        if nb:
            blocks[i, 1: 1 + nb] = d[: n - s].reshape(nb, BLOCK)
        last = np.zeros(BLOCK, np.uint8)
        last[:s] = d[n - s:]
        if s < BLOCK:
            last[s] ^= 0x80
            last ^= k2[i]
        else:
            last ^= k1[i]
        blocks[i, 1 + nb] = last
        nv[i] = nb + 2
    return cbcmac_fold_batch(rks, jnp.zeros((B, BLOCK), jnp.uint8),
                                  jnp.asarray(blocks), jnp.asarray(nv))


def _eax_last_np(k1, k2, t: int, lens):
    """Per-message data-INDEPENDENT OMAC constants (micro_aes.c:1531-1549
    last-block handling): the tweak prefix block [0..0,t] (with K1 folded
    in for EMPTY messages — their whole OMAC is E(T ^ K1)), the
    final-block xor (0x80 pad marker + K2 for partial blocks, K1 for
    whole blocks), and the payload block counts."""
    B = len(lens)
    tweak = np.zeros((B, 1, BLOCK), np.uint8)
    tweak[:, 0, BLOCK - 1] = t
    lastadd = np.zeros((B, BLOCK), np.uint8)
    nv = np.zeros(B, np.int32)
    for i, n in enumerate(lens):
        if not n:
            tweak[i, 0] ^= k1[i]
            continue
        s = (n - 1) % BLOCK + 1
        la = np.zeros(BLOCK, np.uint8)
        if s < BLOCK:
            la[s] ^= 0x80
            la ^= k2[i]
        else:
            la ^= k1[i]
        lastadd[i] = la
        nv[i] = (n - 1) // BLOCK + 1
    return tweak, lastadd, nv


def _omac_blocks_dev(rks, k1, k2, t: int, blocks_j, lens):
    """OMAC(t) over B DEVICE-resident zero-masked payloads [B, nb, 16]
    (the ciphertext side of EAX): the last-block 0x80 marker and K1/K2
    tweak are data-INDEPENDENT, so they apply as a one-hot xor on
    device; the tweak block rides a 1-block prefix fold.  The payload
    never visits the host."""
    B, nb = blocks_j.shape[0], blocks_j.shape[1]
    tweak, lastadd, nv = _eax_last_np(k1, k2, t, lens)
    acc = cbcmac_fold_batch(rks, jnp.zeros((B, BLOCK), jnp.uint8),
                                 jnp.asarray(tweak),
                                 jnp.ones(B, jnp.int32))
    nvj = jnp.asarray(nv)
    onehot = (jnp.arange(nb)[None, :] == (nvj - 1)[:, None]).astype(jnp.uint8)
    mac_in = blocks_j ^ (onehot[:, :, None] * jnp.asarray(lastadd)[:, None, :])
    return cbcmac_fold_batch(rks, acc, mac_in, nvj)


def _byte_mask(lens, nb: int):
    """bool[B, nb, 16]: True where the byte index < the message length."""
    return (jnp.arange(nb * BLOCK)[None, :]
            < jnp.asarray(lens)[:, None]).reshape(-1, nb, BLOCK)


@_regroup_mixed_keys(3)
def eax_encrypt_batch(keys, nonces, aads, pts, tag_len: int = 16) -> list[bytes]:
    """AES-EAX over B independent messages, device-resident: the padded
    plaintext uploads once, the ciphertext OMAC folds the device-side
    xor result directly, and only the ciphertext and tags come back."""
    B = len(keys)
    rks = stack_round_keys(keys)  # folds take the HOST stack (no pull)
    nonces = [to_u8(x) for x in nonces]
    aads = [to_u8(x) for x in aads]
    pts = [to_u8(x) for x in pts]
    lens = [len(p) for p in pts]
    k1, k2 = _eax_subkeys(jnp.asarray(rks), B)

    n_mac = _omac_small_dev(rks, k1, k2, 0, nonces)
    h_mac = _omac_small_dev(rks, k1, k2, 1, aads)
    nks = max(((n + BLOCK - 1) // BLOCK for n in lens), default=0)
    if nks:
        ctrs = jax.vmap(lambda b: counter_blocks(b, nks, 0, "be"))(n_mac)
        ks = cipher_blocks_multikey_dev(keys, ctrs)
        ptj = jnp.asarray(_pad_blocks_batch(pts, nks))
        ct_pad = ptj ^ ks
        ct_mac = jnp.where(_byte_mask(lens, nks), ct_pad, 0)
    else:
        ct_pad = None
        ct_mac = jnp.zeros((B, 1, BLOCK), jnp.uint8)
    c_mac = _omac_blocks_dev(rks, k1, k2, 2, ct_mac, lens)
    tags = np.asarray(n_mac ^ h_mac ^ c_mac)
    ct_np = np.asarray(ct_pad) if nks else None
    return [
        (bytes(ct_np[i].reshape(-1)[: n]) if n else b"")
        + bytes(tags[i][:tag_len])
        for i, n in enumerate(lens)
    ]


@_regroup_mixed_keys(3)
def eax_decrypt_batch(keys, nonces, aads, ct_tags,
                      tag_len: int = 16) -> list[bytes | None]:
    """Batched EAX open (authenticate-then-decrypt, constant-time
    compares), device-resident; failed messages come back as None."""
    from ..utils.bytesio import verify_tag

    B = len(keys)
    rks = stack_round_keys(keys)  # folds take the HOST stack (no pull)
    nonces = [to_u8(x) for x in nonces]
    aads = [to_u8(x) for x in aads]
    data = [to_u8(x) for x in ct_tags]
    cts = [d[: len(d) - tag_len] for d in data]
    tags = [bytes(d[len(d) - tag_len:]) for d in data]
    lens = [len(c) for c in cts]
    k1, k2 = _eax_subkeys(jnp.asarray(rks), B)

    n_mac = _omac_small_dev(rks, k1, k2, 0, nonces)
    h_mac = _omac_small_dev(rks, k1, k2, 1, aads)
    nks = max(((n + BLOCK - 1) // BLOCK for n in lens), default=0)
    ctj = jnp.asarray(_pad_blocks_batch(cts, max(nks, 1)))
    c_mac = _omac_blocks_dev(rks, k1, k2, 2, ctj, lens)
    expects = np.asarray(n_mac ^ h_mac ^ c_mac)

    if nks:
        ctrs = jax.vmap(lambda b: counter_blocks(b, nks, 0, "be"))(n_mac)
        ks = cipher_blocks_multikey_dev(keys, ctrs)
        pt_np = np.asarray(ctj[:, :nks] ^ ks)
    out: list[bytes | None] = []
    for i, c in enumerate(cts):
        if not verify_tag(expects[i][:tag_len], tags[i]):
            out.append(None)
            continue
        out.append(bytes(pt_np[i].reshape(-1)[: len(c)]) if len(c) else b"")
    return out


def _ccm_b0_prefix(iv0: np.ndarray, aad: np.ndarray, ptlen: int,
                   tag_len: int) -> np.ndarray:
    """Per-message CBC-MAC PREFIX — B0 then the A-segment — exactly
    mirroring CCMtag (micro_aes.c:1222-1256); the payload blocks follow
    at a fresh block boundary and are folded from the shared device
    buffer.  (No-AAD: the reference folds one zero A-block from the RAW
    B0 — i.e. exactly E(B0), which the prepended-B0 fold already is.)"""
    m = iv0.copy()
    m[0] |= (tag_len - 2) << 2
    v, i = ptlen, 15
    while True:
        m[i] ^= v & 0xFF
        v >>= 8
        i -= 1
        if not v:
            break
    segments = [m[None, :]]
    alen = len(aad)
    if alen:
        m[0] |= 0x40
        a = np.zeros(BLOCK, np.uint8)
        p = 1
        if alen > 0xFEFF:
            p += 4
            a[0], a[1] = 0xFF, 0xFE
        v, i = alen, p
        while True:
            a[i] ^= v & 0xFF
            v >>= 8
            i -= 1
            if not v:
                break
        p += 1
        s = BLOCK - p
        a[p: p + min(alen, s)] = aad[:s]
        segments.append(a[None, :])
        if alen > s:
            rest = aad[s:]
            nb = (len(rest) + BLOCK - 1) // BLOCK
            padded = np.zeros((nb, BLOCK), np.uint8)
            padded.reshape(-1)[: len(rest)] = rest
            segments.append(padded)
    return np.concatenate(segments, axis=0)


def _ccm_prefix_batch(iv0s: np.ndarray, aads: list[np.ndarray],
                      ptlens, tag_len: int):
    """Vectorized B0 + A-segment assembly (CCMtag, micro_aes.c:1222-1256)
    for the whole batch: flag/length fields as array ops, the ragged AAD
    bytes as ONE scatter (a per-message Python loop here was a serial
    host cost).  Returns (pb uint8[B,mp,16],
    nv1 int32[B]); semantics identical to stacking _ccm_b0_prefix rows."""
    B = len(aads)
    alens = np.array([len(a) for a in aads], np.int64)
    m = iv0s.astype(np.uint8).copy()
    m[:, 0] |= (tag_len - 2) << 2
    m[:, 0] |= np.where(alens > 0, 0x40, 0).astype(np.uint8)
    v = np.asarray(ptlens, np.uint64)
    for i in range(8):  # BE length xor; zero high bytes are no-ops
        m[:, 15 - i] ^= ((v >> np.uint64(8 * i)) & np.uint64(0xFF)
                         ).astype(np.uint8)

    # AAD region: length field is 2 bytes (6 with the 0xFFFE prefix for
    # alen >= 0xFF00), data starts right after, zero-padded to blocks.
    hdr = np.where(alens > 0xFEFF, 6, 2)
    na = np.where(alens > 0, -(-(hdr + alens) // BLOCK), 0)
    mp = int(1 + na.max()) if B else 1
    pb = np.zeros((B, mp, BLOCK), np.uint8)
    pb[:, 0] = m
    region = np.zeros((B, (mp - 1) * BLOCK), np.uint8)
    if mp > 1:
        big = alens > 0xFEFF
        region[big, 0], region[big, 1] = 0xFF, 0xFE
        av = alens.astype(np.uint64)
        # BE alen field ends at hdr-1 (xor, mirroring the reference's
        # backwards loop).  4 fixed iterations: for the 2-byte small
        # field, bytes 2-3 of av are zero (alen <= 0xFEFF), so their
        # xors — which land on wrapped columns — are no-ops.
        for i in range(4):
            region[np.arange(B), hdr - 1 - i] ^= (
                (av >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint8)
        flat = np.concatenate([np.asarray(a, np.uint8).reshape(-1)
                               for a in aads if len(a)])
        rows = np.repeat(np.arange(B), alens)
        starts = np.repeat(np.cumsum(alens) - alens, alens)
        offs = (np.arange(len(flat)) - starts
                + np.repeat(hdr, alens)).astype(np.int64)
        region[rows, offs] = flat
    pb[:, 1:] = region.reshape(B, mp - 1, BLOCK)
    return pb, (1 + na).astype(np.int32)


def _ccm_tags_dev(rks, iv0s, aads, ptlens, pt_blocks_j, nvp, ek0,
                  tag_len: int):
    """Device-resident CCM tag math: fold the (tiny, batch-assembled)
    B0+AAD prefixes with init 0 (fold(0, [B0, ...]) == fold(E(B0), ...)),
    continue the fold over the shared payload device buffer, and xor
    E(A0) — which is counter block 0 of the keystream pass, so no extra
    single-block cipher dispatches exist anywhere on this path."""
    B = len(ptlens)
    pb, nv1 = _ccm_prefix_batch(iv0s, aads, ptlens, tag_len)
    acc = cbcmac_fold_batch(rks, jnp.zeros((B, BLOCK), jnp.uint8),
                                 jnp.asarray(pb), jnp.asarray(nv1))
    macs = cbcmac_fold_batch(rks, acc, pt_blocks_j, nvp)
    return ek0 ^ macs


@_regroup_mixed_keys(3)
def ccm_encrypt_batch(keys, nonces, aads, pts, nonce_len: int | None = None,
                      tag_len: int = 16) -> list[bytes]:
    """AES-CCM over B independent messages, device-resident: the padded
    payload is uploaded ONCE and reused as both the CBC-MAC fold input
    and the CTR xor operand; only the ciphertext and tags come back.
    nonce_len=None uses each nonce's own length (the VNT corpora mix
    7..13-byte nonces in one file)."""
    from .ccm import _iv0

    B = len(keys)
    rks = stack_round_keys(keys)  # folds take the HOST stack (no pull)
    aads = [to_u8(x) for x in aads]
    pts = [to_u8(x) for x in pts]
    iv0s = np.stack([
        _iv0(to_u8(n)[:nonce_len] if nonce_len else to_u8(n))
        for n in nonces])

    nks = max(((len(p) + BLOCK - 1) // BLOCK for p in pts), default=0)
    ptj = jnp.asarray(_pad_blocks_batch(pts, max(nks, 1)))
    nvp_np = np.array([(len(p) + BLOCK - 1) // BLOCK for p in pts], np.int32)
    nvp = jnp.asarray(nvp_np)
    # keystream blocks 0..nks: block 0 IS E(A0) (the tag whitener)
    ctrs = jax.vmap(lambda b: counter_blocks(b, nks + 1, 0, "be"))(
        jnp.asarray(iv0s))
    ks_all = cipher_blocks_multikey_dev(keys, ctrs)
    tags = np.asarray(_ccm_tags_dev(rks, iv0s, aads, [len(p) for p in pts],
                                    ptj, nvp, ks_all[:, 0], tag_len))
    ct_pad = np.asarray(ptj[:, :nks] ^ ks_all[:, 1:]) if nks else None
    return [
        (bytes(ct_pad[i].reshape(-1)[: len(p)]) if len(p) else b"")
        + bytes(tags[i][:tag_len])
        for i, p in enumerate(pts)
    ]


@_regroup_mixed_keys(3)
def ccm_decrypt_batch(keys, nonces, aads, ct_tags,
                      nonce_len: int | None = None,
                      tag_len: int = 16) -> list[bytes | None]:
    """Batched CCM open (decrypt-then-verify per the reference ordering,
    micro_aes.c:1304-1312, constant-time compares), device-resident:
    the recovered plaintext feeds the verification fold without leaving
    the device (zero-masked past each message's length)."""
    from ..utils.bytesio import verify_tag
    from .ccm import _iv0

    B = len(keys)
    rks = stack_round_keys(keys)  # folds take the HOST stack (no pull)
    aads = [to_u8(x) for x in aads]
    data = [to_u8(x) for x in ct_tags]
    cts = [d[: len(d) - tag_len] for d in data]
    tags = [bytes(d[len(d) - tag_len:]) for d in data]
    iv0s = np.stack([
        _iv0(to_u8(n)[:nonce_len] if nonce_len else to_u8(n))
        for n in nonces])

    nks = max(((len(c) + BLOCK - 1) // BLOCK for c in cts), default=0)
    lens = np.array([len(c) for c in cts], np.int32)
    ctj = jnp.asarray(_pad_blocks_batch(cts, max(nks, 1)))
    nvp = jnp.asarray((lens + BLOCK - 1) // BLOCK)
    ctrs = jax.vmap(lambda b: counter_blocks(b, nks + 1, 0, "be"))(
        jnp.asarray(iv0s))
    ks_all = cipher_blocks_multikey_dev(keys, ctrs)
    if nks:
        pt_pad = ctj[:, :nks] ^ ks_all[:, 1:]
        # MAC input is the ZERO-PADDED plaintext: mask past each length
        bytemask = (jnp.arange(nks * BLOCK)[None, :]
                    < jnp.asarray(lens)[:, None])
        pt_mac = jnp.where(bytemask.reshape(-1, nks, BLOCK), pt_pad, 0)
    else:
        pt_pad = None
        pt_mac = jnp.zeros((B, 1, BLOCK), jnp.uint8)
    expects = np.asarray(_ccm_tags_dev(rks, iv0s, aads, [int(v) for v in lens],
                                       pt_mac, nvp, ks_all[:, 0], tag_len))
    pt_np = np.asarray(pt_pad) if nks else None
    out: list[bytes | None] = []
    for i, c in enumerate(cts):
        if not verify_tag(expects[i][:tag_len], tags[i]):
            out.append(None)
            continue
        out.append(bytes(pt_np[i].reshape(-1)[: len(c)]) if len(c) else b"")
    return out


# ---------------------------------------------------------------------------
# Batched SIV (RFC 5297) + KW (RFC 3394): the last per-message-only modes
# get device-batched folds (S2V as staged CMAC batches; KW wheels vmapped)
# ---------------------------------------------------------------------------


def _cmac_batch(rks, datas: list[np.ndarray]) -> np.ndarray:
    """Batched standard CMAC (init 0, K1/K2 last-block tweak — cMac,
    micro_aes.c:576-590) over B independent byte strings."""
    from ..ops.mac import double_be_np

    B = len(datas)
    L = _enc1_batch(rks, np.zeros((B, BLOCK), np.uint8))
    k1 = double_be_np(L)
    k2 = double_be_np(k1)
    m = max((max((len(d) - 1) // BLOCK + 1, 1) for d in datas), default=1)
    blocks = np.zeros((B, m, BLOCK), np.uint8)
    nv = np.zeros(B, np.int32)
    for i, d in enumerate(datas):
        n = len(d)
        s = (n - 1) % BLOCK + 1 if n else 0
        nb = (n - s) // BLOCK
        if nb:
            blocks[i, :nb] = d[: n - s].reshape(nb, BLOCK)
        last = np.zeros(BLOCK, np.uint8)
        last[:s] = d[n - s:]
        if s < BLOCK:
            last[s] ^= 0x80
            last ^= k2[i]
        else:
            last ^= k1[i]
        blocks[i, nb] = last
        nv[i] = nb + 1
    return np.asarray(cbcmac_fold_batch(
        rks, jnp.zeros((B, BLOCK), jnp.uint8),
        jnp.asarray(blocks), jnp.asarray(nv)))


def _s2v_y(rks1, aads: list[np.ndarray]) -> np.ndarray:
    """The AAD-side S2V accumulator y (micro_aes.c:1324-1340): y0 =
    CMAC(0^16), doubled and xored with the AAD CMAC when one is
    present.  Two small staged CMAC batches."""
    from ..ops.mac import double_be_np

    B = len(aads)
    y0 = _cmac_batch(rks1, [np.zeros(BLOCK, np.uint8)] * B)
    amac = _cmac_batch(rks1, aads)
    has_aad = np.array([len(a) > 0 for a in aads])[:, None]
    return np.where(has_aad, double_be_np(y0) ^ amac, y0)


def _s2v_batch(rks1, aads: list[np.ndarray],
               pts: list[np.ndarray]) -> np.ndarray:
    """Batched S2V (micro_aes.c:1324-1360): three staged CMAC batches
    (Y0, AAD macs, final xorend/pad fold) with host glue between."""
    from ..ops.mac import double_be_np

    y = _s2v_y(rks1, aads)
    finals = []
    for i, p in enumerate(pts):
        if len(p) < BLOCK:
            pad = np.zeros(BLOCK, np.uint8)
            pad[: len(p)] = p
            pad[len(p)] = 0x80
            finals.append(double_be_np(y[i]) ^ pad)
        else:
            d = p.copy()
            d[-BLOCK:] ^= y[i]
            finals.append(d)
    return _cmac_batch(rks1, finals)


def _siv_split(keys) -> tuple[list[bytes], list[bytes]]:
    keys = [bytes(k) for k in keys]
    return ([k[: len(k) // 2] for k in keys],
            [k[len(k) // 2:] for k in keys])


def _siv_keystreams(k2s: list[bytes], ivs: np.ndarray, lens: list[int]):
    """SIV-convention CTR keystreams (bits 63/31 cleared, BE count —
    micro_aes.c:931-934) for B messages in one batched cipher call."""
    bases = ivs.copy()
    bases[:, 8] &= 0x7F
    bases[:, 12] &= 0x7F
    nks = max(((n + BLOCK - 1) // BLOCK for n in lens), default=0)
    if not nks:
        return None
    ctrs = jax.vmap(lambda bb: counter_blocks(bb, nks, 0, "be"))(
        jnp.asarray(bases))
    return np.asarray(cipher_blocks_multikey_dev(k2s, ctrs))


def _siv_s2v_consts(d, q, y, lens):
    """Data-independent S2V final-fold constants of the dp-sharded SIV
    engine (parallel/batch.siv_sharded_fn; micro_aes.c:1336-1356): per message the final-block byte mask
    `tail`, the final-block xor `lastadd`, the second-to-last-block xor
    `prevadd` (the xorend straddle: when the final block is ragged with
    s payload bytes, y's last s bytes land on it and y's first 16-s
    bytes land on the tail of the PREVIOUS block), and the MAC block
    count.  d/q are the cMac doubling subkeys of the MAC key
    (getSubkeys, micro_aes.c:593-604); sub-block messages use the
    dbl(y) ^ pad form (micro_aes.c:1344-1349)."""
    from ..ops.mac import double_be_np

    B = len(lens)
    tail = np.zeros((B, BLOCK), np.uint8)
    lastadd = np.zeros((B, BLOCK), np.uint8)
    prevadd = np.zeros((B, BLOCK), np.uint8)
    nv = np.zeros(B, np.int32)
    dy = double_be_np(y)
    for i, n in enumerate(lens):
        if n >= BLOCK:
            s = (n - 1) % BLOCK + 1
            nv[i] = (n - 1) // BLOCK + 1
            if s == BLOCK:
                tail[i] = 0xFF
                lastadd[i] = y[i] ^ d[i]
            else:
                tail[i, :s] = 0xFF
                la = np.zeros(BLOCK, np.uint8)
                la[:s] = y[i, BLOCK - s:]
                la[s] ^= 0x80
                lastadd[i] = la ^ q[i]
                prevadd[i, s:] = y[i, : BLOCK - s]
        else:
            nv[i] = 1
            tail[i, :n] = 0xFF
            la = dy[i].copy()
            la[n] ^= 0x80
            lastadd[i] = la ^ d[i]
    return tail, lastadd, prevadd, nv


@_regroup_mixed_keys(2)
def siv_encrypt_batch(keys, aads, pts) -> list[tuple[bytes, bytes]]:
    """AES_SIV_encrypt (micro_aes.c:1372-1381) over B messages: returns
    (iv, ct) pairs; keys are K1||K2 concatenations as in the scalar API
    and (like the other batch engines) must share one key size per call."""
    k1s, k2s = _siv_split(keys)
    aads = [to_u8(a) for a in aads]
    pts = [to_u8(p) for p in pts]
    rks1 = jnp.asarray(stack_round_keys(k1s))
    ivs = _s2v_batch(rks1, aads, pts)
    ks = _siv_keystreams(k2s, ivs, [len(p) for p in pts])
    return [(bytes(ivs[i]),
             bytes(p ^ ks[i].reshape(-1)[: len(p)]) if len(p) else b"")
            for i, p in enumerate(pts)]


@_regroup_mixed_keys(3)
def siv_decrypt_batch(keys, ivs, aads, cts) -> list[bytes | None]:
    """Batched SIV open: decrypt, re-synthesize S2V, constant-time verify
    (micro_aes.c:1394-1410); failed messages come back as None."""
    from ..utils.bytesio import verify_tag

    k1s, k2s = _siv_split(keys)
    aads = [to_u8(a) for a in aads]
    cts = [to_u8(c) for c in cts]
    iv_arr = np.stack([to_u8(iv)[:BLOCK] for iv in ivs])
    rks1 = jnp.asarray(stack_round_keys(k1s))
    ks = _siv_keystreams(k2s, iv_arr, [len(c) for c in cts])
    pts = [(c ^ ks[i].reshape(-1)[: len(c)]) if len(c)
           else np.zeros(0, np.uint8) for i, c in enumerate(cts)]
    expects = _s2v_batch(rks1, aads, pts)
    return [bytes(pts[i]) if verify_tag(expects[i], iv_arr[i]) else None
            for i in range(len(cts))]


def key_wrap_batch(keks, secrets) -> list[bytes]:
    """AES_KEY_wrap (micro_aes.c:1829-1855) over B secrets: one device
    dispatch (the vmapped wheel scan) per (semiblock count, key size)
    group."""
    from ..errors import DataLengthError
    from .kw import HB, _wrap_scan

    secrets = [to_u8(s) for s in secrets]
    keks = [bytes(k) for k in keks]
    groups: dict[tuple[int, int], list[int]] = {}
    for i, s in enumerate(secrets):
        if len(s) < 2 * HB or len(s) % HB:
            raise DataLengthError("KW secret must be >= 2 whole semi-blocks")
        groups.setdefault((len(s) // HB, len(keks[i])), []).append(i)
    out: list[bytes | None] = [None] * len(secrets)
    for (n, _), idxs in groups.items():
        rks = jnp.asarray(stack_round_keys([keks[i] for i in idxs]))
        a0 = jnp.full((len(idxs), HB), 0xA6, jnp.uint8)
        r0 = jnp.asarray(np.stack([secrets[i].reshape(n, HB)
                                   for i in idxs]))
        a, r = jax.vmap(lambda rk, av, rv: _wrap_scan(rk, av, rv, n))(
            rks, a0, r0)
        a, r = np.asarray(a), np.asarray(r)
        for k, i in enumerate(idxs):
            out[i] = bytes(a[k]) + bytes(r[k].reshape(-1))
    return out  # type: ignore[return-value]


def key_unwrap_batch(keks, wrappeds) -> list[bytes | None]:
    """Batched KW unwrap with per-message 0xA6 ICV verification
    (micro_aes.c:1889-1893); failures come back as None."""
    from ..errors import DataLengthError
    from ..utils.bytesio import verify_tag
    from .kw import HB, _unwrap_scan

    wrappeds = [to_u8(w) for w in wrappeds]
    keks = [bytes(k) for k in keks]
    groups: dict[tuple[int, int], list[int]] = {}
    for i, w in enumerate(wrappeds):
        if len(w) < 3 * HB or len(w) % HB:
            raise DataLengthError("KW input must be >= 3 whole semi-blocks")
        groups.setdefault((len(w) // HB - 1, len(keks[i])), []).append(i)
    out: list[bytes | None] = [None] * len(wrappeds)
    icv = np.full(HB, 0xA6, np.uint8)
    for (n, _), idxs in groups.items():
        rks = jnp.asarray(stack_round_keys([keks[i] for i in idxs]))
        a0 = jnp.asarray(np.stack([wrappeds[i][:HB] for i in idxs]))
        r0 = jnp.asarray(np.stack([wrappeds[i][HB:].reshape(n, HB)
                                   for i in idxs]))
        a, r = jax.vmap(lambda rk, av, rv: _unwrap_scan(rk, av, rv, n))(
            rks, a0, r0)
        a, r = np.asarray(a), np.asarray(r)
        for k, i in enumerate(idxs):
            out[i] = (bytes(r[k].reshape(-1))
                      if verify_tag(icv, a[k]) else None)
    return out
