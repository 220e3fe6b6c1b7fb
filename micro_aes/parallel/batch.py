"""Batch-axis data parallelism for the multi-tenant engines.

The single-message sharded GCM (parallel/sharded.py) splits the BLOCK
axis of one message over `sp` and pays one XOR-psum per tag.  The
engines here scale the other way (SURVEY §2.6 "block-index data
parallelism"): B independent (key, message) pairs split over `dp` with
ZERO collectives — each device runs the full fused engine on its slice
of the batch.  This is the multi-tenant serving shape: throughput
scales linearly with devices because nothing crosses the interconnect.

The CPU test mesh executes the same code path a GPU mesh runs
(tests/test_parallel.py).  Multi-host: combine with
parallel/multihost.host_local_batch so each host feeds its local slice.
"""
from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ._shmap import shard_map_nocheck


def seal_batch_sharded_fn(mesh: Mesh, b: int, wm: int):
    """Multi-key fused GCM (modes/seal_batch._seal_batch_core) over the
    mesh's `dp` axis: every per-message input/output is sharded on its
    batch(-derived) leading axis; no collectives exist in the program.
    b must divide by dp.  Returns fn(kp_stack, j0w, front, mask, sel,
    len_bits, ptw) -> (out stream, tags), argument contract identical
    to the unsharded core."""
    from ..modes.seal_batch import _seal_batch_core

    dp = mesh.shape["dp"]
    assert b % dp == 0, (b, dp)
    local_b = b // dp

    def local_fn(kp_stack, j0w, front, mask, sel, len_bits, ptw):
        return _seal_batch_core(kp_stack, j0w, front, mask, sel,
                                len_bits, ptw, local_b, wm)

    spec = P("dp")
    fn = shard_map_nocheck(
        local_fn, mesh=mesh,
        in_specs=(spec,) * 7,
        out_specs=(spec, spec),
    )
    return jax.jit(fn)


def xts_sectors_sharded_fn(mesh: Mesh, r_per_sector: int,
                           decrypt: bool = False):
    """Disk-sector XTS over the mesh's `dp` axis (SURVEY §2.6 block-
    index DP for XTS bodies, micro_aes.c:1030): sectors are mutually
    independent, so the tweak table shards with its sectors and the
    w-major data stream shards on whole-sector row groups — zero
    collectives.  Returns fn(kp1, kp2, tweaks[S,16], ptw[S*R,128]) ->
    output stream; S must divide by dp.  r_per_sector = sector blocks
    / 32 (whole-32-block sectors; same contract as
    modes/xts_bulk.xts_sectors_stream_kernel, which each shard runs
    locally on its slice)."""
    from ..modes.xts_bulk import _row_base_powers_t, xts_sectors_stream_kernel

    pows = _row_base_powers_t(r_per_sector)

    def local_fn(kp1, kp2, tweaks, ptw):
        return xts_sectors_stream_kernel(kp1, kp2, pows, tweaks, ptw,
                                         decrypt=decrypt)

    fn = shard_map_nocheck(
        local_fn, mesh=mesh,
        in_specs=(P(), P(), P("dp"), P("dp")),
        out_specs=P("dp"),
    )
    return jax.jit(fn)


def chain_sharded_fn(mesh: Mesh, kind: str):
    """Lane-packed serial-chain engine (CBC/CFB encrypt, OFB keystream)
    over the mesh's `dp` axis: per-lane keys shard with their lanes
    (kpw on its word axis, state on the batch axis), zero collectives.
    The local batch (B/dp) must be a multiple of 32 — one word of
    lanes per device at minimum."""
    from ..modes._scan import (
        cbc_encrypt_scan_packed,
        cfb_encrypt_scan_packed,
        ofb_keystream_scan_packed,
    )

    local = {"cbc": cbc_encrypt_scan_packed,
             "cfb": cfb_encrypt_scan_packed,
             "ofb": ofb_keystream_scan_packed}[kind]
    fn = shard_map_nocheck(
        local, mesh=mesh,
        in_specs=(P(None, None, None, "dp"), P("dp"),
                  P("dp") if kind != "ofb" else P(None)),
        out_specs=P("dp"),
    )
    return jax.jit(fn)


def aead_sharded_fn(mesh: Mesh, kind: str, decrypt: bool = False):
    """Fused CCM/EAX batch engine (round-5: one pass producing the CTR
    stream AND the CBC-MAC fold) over the mesh's `dp` axis: B
    independent (key, counter-base, message) tuples split across
    devices with zero collectives.  The local body is the jnp
    composition (counter + vmapped cipher + masked fold).

    Local args per shard: rks u8[Bl,R+1,16], c0/init/tail/lastadd
    u8[Bl,16], blocks u8[Bl,nb,16], nvalid i32[Bl].
    Returns (out u8[B,nb,16], tag u8[B,16])."""
    import jax.numpy as jnp

    from ..core.cipher import encrypt_blocks
    from ..ops.counter import counter_blocks
    from ..ops.mac import cbcmac_fold_batch

    whiten = kind == "ccm"
    mac_from_input = (kind == "ccm") != bool(decrypt)

    def local(rks, c0, init, blocks, nvalid, tail, lastadd):
        nb = blocks.shape[1]
        nctr = nb + (1 if whiten else 0)
        ctrs = jax.vmap(lambda b: counter_blocks(b, nctr, 0, "be"))(c0)
        ks_all = jax.vmap(encrypt_blocks)(rks, ctrs)
        ks = ks_all[:, 1:] if whiten else ks_all
        out = blocks ^ ks
        macsrc = blocks if mac_from_input else out
        last = (jnp.arange(nb)[None, :]
                == (nvalid - 1)[:, None])[:, :, None]
        fin = (macsrc & tail[:, None, :]) ^ lastadd[:, None, :]
        macin = jnp.where(last, fin, macsrc)
        mac = cbcmac_fold_batch(rks, init, macin, nvalid)
        tag = (ks_all[:, 0] ^ mac) if whiten else mac
        return out, tag

    fn = shard_map_nocheck(
        local, mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp"), P("dp"), P("dp"), P("dp"),
                  P("dp")),
        out_specs=(P("dp"), P("dp")),
    )
    return jax.jit(fn)


def gcm_chain_sharded_fn(mesh: Mesh):
    """Value-chain multi-key GCM (table-free: G <- (G ^ C) * H per block)
    over the mesh's `dp` axis: B independent (key, nonce, message)
    tenants split across devices with zero collectives.  The local body
    is the jnp composition (counter + vmapped cipher + value-domain
    GHASH fold + length finalize).

    Local args per shard: rks u8[Bl,R+1,16], h/ej0/c0/init/lenb
    u8[Bl,16], blocks u8[Bl,nb,16] (whole blocks), nvalid i32[Bl].
    Returns (ct u8[B,nb,16], tags u8[B,16])."""
    from ..core.cipher import encrypt_blocks
    from ..ops.counter import counter_blocks
    from ..ops.gf128 import mul_gf128
    from ..ops.mac import ghash_fold_batch

    def local(rks, h, ej0, c0, init, blocks, nvalid, lenb):
        nb = blocks.shape[1]
        ctrs = jax.vmap(lambda b: counter_blocks(b, nb, 0, "be"))(c0)
        ks = jax.vmap(encrypt_blocks)(rks, ctrs)
        out = blocks ^ ks
        g = ghash_fold_batch(h, init, out, nvalid)
        g = mul_gf128(h, g ^ lenb)
        return out, ej0 ^ g

    spec = P("dp")
    fn = shard_map_nocheck(
        local, mesh=mesh,
        in_specs=(spec,) * 8,
        out_specs=(spec, spec),
    )
    return jax.jit(fn)


def siv_sharded_fn(mesh: Mesh):
    """Fused-SIV batch engine (S2V + SIV-CTR) over the mesh's `dp` axis:
    B independent (K1, K2, message) tuples split across devices, zero
    collectives.  The local body is the jnp composition (masked CMAC
    fold with the S2V last-block constants of modes/bulk.
    _siv_s2v_consts, bit-cleared counter base, CTR keystream).

    Local args per shard: rks1/rks2 u8[Bl,R+1,16], init/tail/lastadd/
    prevadd u8[Bl,16], blocks u8[Bl,nb,16], nvalid i32[Bl].
    Returns (ct u8[B,nb,16], iv u8[B,16])."""
    import jax.numpy as jnp

    from ..core.cipher import encrypt_blocks
    from ..ops.counter import counter_blocks
    from ..ops.mac import cbcmac_fold_batch

    def local(rks1, rks2, init, blocks, nvalid, tail, lastadd, prevadd):
        nb = blocks.shape[1]
        idx = jnp.arange(nb)[None, :, None]
        last = idx == (nvalid - 1)[:, None, None]
        prev = idx == (nvalid - 2)[:, None, None]
        fin = (blocks & tail[:, None, :]) ^ lastadd[:, None, :]
        macin = jnp.where(last, fin, blocks) ^ jnp.where(
            prev, prevadd[:, None, :], jnp.uint8(0))
        iv = cbcmac_fold_batch(rks1, init, macin, nvalid)
        bases = iv.at[:, 8].set(iv[:, 8] & 0x7F)
        bases = bases.at[:, 12].set(bases[:, 12] & 0x7F)
        ctrs = jax.vmap(lambda b: counter_blocks(b, nb, 0, "be"))(bases)
        ks = jax.vmap(encrypt_blocks)(rks2, ctrs)
        return blocks ^ ks, iv

    spec = P("dp")
    fn = shard_map_nocheck(
        local, mesh=mesh,
        in_specs=(spec,) * 8,
        out_specs=(spec, spec),
    )
    return jax.jit(fn)
