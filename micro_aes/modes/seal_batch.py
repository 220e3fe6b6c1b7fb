"""Multi-key fused GCM: B messages under B different keys, ONE dispatch.

The serving workload the single-key seal cannot cover: per-connection /
per-tenant keys.  The v1 batch engine (modes/bulk.py, kept as the
general/ragged fallback) pays the gather-cipher and a scan GHASH; this
engine keeps everything in one device program:

  * cipher: ops/stream.ctrw_fused_multikey_jnp — the bitsliced stream
    engine vmapped over messages, each with its own key planes;
  * per-message window layout (Wm words each, all in one stream):
    position 0 encrypts the all-zero block -> H = E_K(0) rides along;
    position 1 encrypts J0 -> E_K(J0) rides along; AAD then data sit
    RIGHT-ALIGNED at the window end, so the GHASH fold needs no
    adjust/compensation matrices at all (leading zeros are free);
    counters are an input stream, so the two regions simply use
    different affine maps of the position;
  * GHASH: per-key M_H probed ON DEVICE from the in-stream H (batched
    bit-serial oracle), per-key two-level power tables built by batched
    GF(2) matmul scans, folds as batched int8 contractions, tag
    finalize batched.  No per-key host probing, no lru pressure;
  * message lengths are runtime data (the `front` vector): one compiled
    program serves any length mix with the same (B, Wm).

Parity: AES_GCM_encrypt/decrypt semantics per message
(micro_aes.c:1164-1211), verify-before-release on open.  Fast-path
constraints (12-byte nonces, whole-block messages, uniform key size);
anything else falls back to modes/bulk.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.gf128 import _bits_np, bits_to_blocks, blocks_to_bits, mul_gf128
from ..ops.ghash_bulk import _combine_logdepth
from ..ops.stream import ctrw_fused_multikey_jnp, mk_window_words
from ..utils.bytesio import BLOCK, verify_tag

# unit bit-vectors as blocks (host constant, embedded at lowering)
_UNIT_BLOCKS = np.packbits(
    np.eye(128, dtype=np.uint8).reshape(128, 16, 8),
    axis=-1, bitorder="big").reshape(128, 16)


def _unit_blocks():
    return jnp.asarray(_UNIT_BLOCKS)


def _bswap32(x):
    return ((x << 24) | ((x & 0xFF00) << 8) | ((x >> 8) & 0xFF00)
            | (x >> 24))


def _mm_gf2_batch(a, c):
    """Batched GF(2) matmul: int8 [B,128,128] x [B,128,128]."""
    acc = jax.lax.dot_general(
        a, c, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32)
    return (acc & 1).astype(jnp.int8)


def _mh_batch(h_blocks):
    """Per-key M_H int8[B,128,128] probed from H on device: column j is
    mulGF128(H, e_j) through the vmapped bit-serial oracle."""
    unit = _unit_blocks()
    cols = jax.vmap(lambda hb: mul_gf128(hb, unit))(h_blocks)  # [B,128,16]
    return jnp.transpose(blocks_to_bits(cols), (0, 2, 1)).astype(jnp.int8)


def _tables_batch(m):
    """Per-key two-level GHASH tables on device:
    w1 [B, 4096, 128] (row block j = (M^(32-j))^T),
    w2 [B, 4096, 128] (row block j = (M^(32*(31-j)))^T),
    m_outer [B,128,128] = M^1024."""
    def step(cur, _):
        nxt = _mm_gf2_batch(m, cur)
        return nxt, cur

    _, pows = jax.lax.scan(step, m, None, length=32)  # pows[k] = M^(k+1)
    w1 = jnp.transpose(jnp.flip(pows, 0), (1, 0, 3, 2)).reshape(
        m.shape[0], 32 * 128, 128)
    m32 = pows[31]

    eye = jnp.broadcast_to(
        jnp.eye(128, dtype=jnp.int8), m.shape)

    def step2(cur, _):
        nxt = _mm_gf2_batch(m32, cur)
        return nxt, cur

    _, pows2 = jax.lax.scan(step2, eye, None, length=32)  # M32^k, k=0..31
    w2 = jnp.transpose(jnp.flip(pows2, 0), (1, 0, 3, 2)).reshape(
        m.shape[0], 32 * 128, 128)
    m_outer = _mm_gf2_batch(m32, pows2[31])
    return w1, w2, m_outer


def _stream_bits(words):
    """u32[N,128] stream -> int8[N*32, 128] per-block bit rows."""
    blocks = jax.lax.bitcast_convert_type(
        words.reshape(-1, 4), jnp.uint8).reshape(-1, BLOCK)
    return blocks_to_bits(blocks).astype(jnp.int8)


def _seal_body(kp_stack, j0w, front, mask, sel, len_bits, ptw,
               b: int, wm: int, tables=None):
    """Multi-key GCM core body — the MATRIX-GHASH engine: per-key
    GF(2) bit-matrix tables (~1 MB per key) contracted as batched int8
    products.  It backs gcm_seal_batch/gcm_open_batch and the dp-sharded
    engine of parallel/batch.py.

    j0w u32[B,4] (J0 LE words),
    front i32[B] (data start position in each window), mask/sel
    int8[B*32*Wm] (fold-validity / input-vs-output bit source per
    position), len_bits int8[B,128], ptw u32[B*Wm,128].
    tables=None derives the per-key GHASH tables in-dispatch (cold
    tenants); a (m, w1, w2, m_outer) tuple skips the 64-step batched
    GF(2) matmul scans entirely (warm tenants).
    Returns (out stream, tags u8[B,16])."""
    rows = b * wm
    lanes = jax.lax.broadcasted_iota(jnp.uint32, (rows, 128), 1)
    jj, k = lanes // 4, lanes % 4
    p = ((jax.lax.broadcasted_iota(jnp.uint32, (rows, 128), 0)
          % jnp.uint32(wm)) * 32 + jj)
    # per-message J0 words / fronts broadcast without gathers
    j0full = jnp.tile(
        jnp.broadcast_to(j0w[:, None, :], (b, wm, 4)).reshape(rows, 4),
        (1, 32))                                     # lane l -> word l%4
    frontv = jnp.broadcast_to(
        front.astype(jnp.uint32)[:, None], (b, wm)).reshape(rows, 1)
    ctr = p - frontv + 2                             # data-region counter
    w3 = _bswap32(jnp.where(p < 2, p, ctr))
    w012 = jnp.where(p < 1, jnp.uint32(0), j0full)
    ctrw = jnp.where(k == 3, w3, w012)

    outw = ctrw_fused_multikey_jnp(kp_stack, ctrw, ptw, b)

    win = outw.reshape(b, wm, 128)
    h_blocks = jax.lax.bitcast_convert_type(
        win[:, 0, 0:4].reshape(b, 4), jnp.uint8).reshape(b, BLOCK)
    ej0_bits = blocks_to_bits(jax.lax.bitcast_convert_type(
        win[:, 0, 4:8].reshape(b, 4), jnp.uint8).reshape(b, BLOCK))

    if tables is None:
        m = _mh_batch(h_blocks)
        w1, w2, m_outer = _tables_batch(m)
    else:
        m, w1, w2, m_outer = tables

    # word-level select/mask BEFORE the bit expansion: sel/mask are
    # per-block, so selecting u32 stream words (lane l = word l%4 of
    # block 32*row + l//4) needs only a x4 lane repeat — half the
    # GHASH-side memory traffic of expanding BOTH streams to bit rows and
    # blending the 8x-larger int8 matrices
    selr = jnp.repeat(sel.reshape(rows, 32), 4, axis=1)
    maskr = jnp.repeat(mask.reshape(rows, 32), 4, axis=1)
    wsel = jnp.where(selr != 0, ptw, outw)
    wsel = jnp.where(maskr != 0, wsel, jnp.uint32(0))
    bits = _stream_bits(wsel)

    s1 = jax.lax.dot_general(
        bits.reshape(b, wm, 32 * 128), w1,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32) & 1       # [B, Wm, 128]
    pad = (-wm) % 32
    s1 = jnp.pad(s1.astype(jnp.int8), ((0, 0), (pad, 0), (0, 0)))
    t2 = (wm + pad) // 32
    s2 = jax.lax.dot_general(
        s1.reshape(b, t2, 32 * 128), w2,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32) & 1       # [B, T2, 128]
    acc = jax.vmap(_combine_logdepth)(s2.astype(jnp.int8), m_outer)

    x = (acc.astype(jnp.int8) ^ len_bits)
    g = jax.lax.dot_general(
        x, m, dimension_numbers=(((1,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.int32) & 1
    tags = bits_to_blocks((ej0_bits ^ g.astype(jnp.uint8)))
    return outw, tags


@functools.partial(jax.jit, static_argnames=("b", "wm"))
def _seal_batch_core(kp_stack, j0w, front, mask, sel, len_bits, ptw,
                     b: int, wm: int):
    """Cold-tenant dispatch: tables derived in-line (single-use keys)."""
    return _seal_body(kp_stack, j0w, front, mask, sel, len_bits, ptw,
                      b, wm)


@functools.partial(jax.jit, static_argnames=("b", "wm"))
def _seal_batch_core_warm(kp_stack, j0w, front, mask, sel, len_bits, ptw,
                          tables, b: int, wm: int):
    """Warm-tenant dispatch: per-key GHASH tables passed in (memoized by
    _tables_cached across calls with the same key set)."""
    return _seal_body(kp_stack, j0w, front, mask, sel, len_bits, ptw,
                      b, wm, tables=tables)


@jax.jit
def _derive_tables(h_blocks):
    """Per-key GHASH machinery from H = E_K(0): probed M_H + two-level
    power tables, one batched device dispatch."""
    m = _mh_batch(h_blocks)
    w1, w2, m_outer = _tables_batch(m)
    return m, w1, w2, m_outer


from ..utils.keycache import key_cache  # noqa: E402


@key_cache(maxsize=2)
def _tables_cached(keys_blob: bytes, klen: int):
    """Memoized per-KEY-SET GHASH tables: serving tenants recur across
    batches, and the table build is 64 steps of batched GF(2) matrix
    products.  Keyed on the
    concatenated key bytes; device-resident (w1/w2 are ~0.5 MB per key,
    so maxsize stays tiny); purged by purge_key_caches()."""
    b = len(keys_blob) // klen
    keys = [keys_blob[i * klen:(i + 1) * klen] for i in range(b)]
    from .bulk import _enc_vmap, stack_round_keys

    rks = jnp.asarray(stack_round_keys(keys))
    h = _enc_vmap(rks, jnp.zeros((b, 1, BLOCK), jnp.uint8))[:, 0]
    return _derive_tables(h)


def _fast_path_ok(keys, nonces, pts) -> bool:
    klens = {len(k) for k in keys}
    return (len(klens) == 1
            and all(len(n) == 12 for n in nonces)
            and all(len(p) % BLOCK == 0 for p in pts))


def _prep(keys, nonces, aads, datas):
    """Common host prep: window size, streams, masks, fronts, lengths."""
    b = len(keys)
    ns = [len(d) // BLOCK for d in datas]
    nas = [-(-len(a) // BLOCK) for a in aads]
    need = max(n + na + 2 for n, na in zip(ns, nas))
    wm = mk_window_words(need)
    span = 32 * wm

    buf = np.zeros((b, span * 4), np.uint32)
    mask = np.zeros((b, span), np.int8)
    sel = np.zeros((b, span), np.int8)
    len_bits = np.zeros((b, 128), np.uint8)
    front = np.zeros(b, np.int32)
    j0w = np.zeros((b, 4), np.uint32)
    for i, (a, d) in enumerate(zip(aads, datas)):
        n, na = ns[i], nas[i]
        f = span - n
        front[i] = f
        ab = np.zeros(na * BLOCK, np.uint8)
        ab[: len(a)] = np.frombuffer(bytes(a), np.uint8)
        buf[i, 4 * (f - na): 4 * f] = ab.view(np.uint32)
        buf[i, 4 * f: 4 * (f + n)] = np.frombuffer(bytes(d), np.uint32)
        mask[i, f - na:] = 1
        sel[i, f - na: f] = 1  # AAD bits always come from the input side
        lb = np.zeros(BLOCK, np.uint8)
        lb[:8] = np.frombuffer((len(a) * 8).to_bytes(8, "big"), np.uint8)
        lb[8:] = np.frombuffer((n * BLOCK * 8).to_bytes(8, "big"), np.uint8)
        len_bits[i] = _bits_np(lb)
        j0 = np.zeros(BLOCK, np.uint8)
        j0[:12] = np.frombuffer(bytes(nonces[i]), np.uint8)
        j0[15] = 1
        j0w[i] = j0.view(np.uint32)
    from ..core.keyschedule import expand_keys_batch

    # one vectorized expansion for the whole key batch (per-key Python
    # here dominated the wall time at serving batch sizes), then the
    # 0/0xFFFFFFFF broadcast planes expand ON DEVICE from the round-key
    # stack — 32x less upload than shipping the planes.  Layout matches
    # per-key key_planes stacked in message order.
    rkj = jnp.asarray(expand_keys_batch(
        np.frombuffer(b"".join(keys), np.uint8).reshape(b, len(keys[0]))))
    kbits = (rkj[..., None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
    kp_stack = (kbits.transpose(0, 1, 3, 2).astype(jnp.uint32)
                * jnp.uint32(0xFFFFFFFF)).reshape(-1, 1)
    return (b, wm, span, ns, front, kp_stack, jnp.asarray(j0w),
            jnp.asarray(front), jnp.asarray(mask.reshape(-1)),
            jnp.asarray(sel.reshape(-1)),
            jnp.asarray(len_bits.astype(np.int8)),
            jnp.asarray(buf.reshape(b * wm, 128)))


def gcm_seal_batch(keys, nonces, aads, pts, tag_len: int = 16,
                   reuse_tables: bool = False) -> list[bytes]:
    """AES-GCM over B messages under B independent keys in ONE device
    dispatch (12-byte nonces, whole-block messages; other shapes fall
    back to the general engine).  Returns [ct || tag] per message.

    reuse_tables memoizes the ~1 MB/key GHASH tables across calls with
    the SAME key set (_tables_cached, purged by purge_key_caches());
    leave False for single-use key batches."""
    keys = [bytes(k) for k in keys]
    if not keys:
        return []
    nonces = [bytes(n) for n in nonces]
    aads = [bytes(a) for a in aads]
    pts = [bytes(p) for p in pts]
    if not _fast_path_ok(keys, nonces, pts):
        from .bulk import gcm_encrypt_batch

        return gcm_encrypt_batch(keys, nonces, aads, pts, tag_len)
    (b, wm, _, ns, front_np, kp_stack, j0w, front, mask, sel,
     len_bits, ptw) = _prep(keys, nonces, aads, pts)
    if reuse_tables:
        tables = _tables_cached(b"".join(keys), len(keys[0]))
        outw, tags = _seal_batch_core_warm(kp_stack, j0w, front, mask, sel,
                                           len_bits, ptw, tables, b, wm)
    else:
        outw, tags = _seal_batch_core(kp_stack, j0w, front, mask, sel,
                                      len_bits, ptw, b, wm)
    out = np.asarray(outw).reshape(b, -1)
    tags = np.asarray(tags)
    res = []
    for i, n in enumerate(ns):
        f = int(front_np[i])
        ct = out[i, 4 * f: 4 * (f + n)].tobytes()
        res.append(ct + bytes(tags[i][:tag_len]))
    return res


def gcm_open_batch(keys, nonces, aads, ct_tags, tag_len: int = 16,
                   reuse_tables: bool = False) -> list[bytes | None]:
    """Batched multi-key GCM open, verify-BEFORE-release per message
    (micro_aes.c:1204-1209): failed messages come back as None.
    reuse_tables as in gcm_seal_batch."""
    keys = [bytes(k) for k in keys]
    if not keys:
        return []
    nonces = [bytes(n) for n in nonces]
    aads = [bytes(a) for a in aads]
    data = [bytes(c) for c in ct_tags]
    cts = [d[: len(d) - tag_len] for d in data]
    tags = [d[len(d) - tag_len:] for d in data]
    if not _fast_path_ok(keys, nonces, cts):
        from .bulk import gcm_decrypt_batch

        return gcm_decrypt_batch(keys, nonces, aads, data, tag_len)
    (b, wm, _, ns, front_np, kp_stack, j0w, front, mask, sel,
     len_bits, ptw) = _prep(keys, nonces, aads, cts)
    # open: the expected-tag fold reads INPUT bits everywhere
    if reuse_tables:
        tables = _tables_cached(b"".join(keys), len(keys[0]))
        outw, expects = _seal_batch_core_warm(kp_stack, j0w, front, mask,
                                              mask, len_bits, ptw, tables,
                                              b, wm)
    else:
        outw, expects = _seal_batch_core(kp_stack, j0w, front, mask, mask,
                                         len_bits, ptw, b, wm)
    out = np.asarray(outw).reshape(b, -1)
    expects = np.asarray(expects)
    res: list[bytes | None] = []
    for i, n in enumerate(ns):
        if not verify_tag(expects[i][:tag_len], tags[i]):
            res.append(None)
            continue
        f = int(front_np[i])
        res.append(out[i, 4 * f: 4 * (f + n)].tobytes())
    return res
