"""Mesh-sharded bulk AES-GCM: the multi-chip scaling path (SURVEY §2.6).

Layout over a 2D mesh (dp, sp):
  * dp — independent messages (embarrassingly parallel);
  * sp — the block axis *within* each message: every shard generates its
    own counter window from the global block index (no communication),
    ciphers it bitsliced, folds a local GHASH partial, applies its
    per-shard adjustment power M^(L*(S-1-s)), and the tag emerges from
    ONE xor-psum over sp (GF(2) sum == parity of an integer psum).

Collectives ride the mesh (NVLink between the cards of one host); there
is no other cross-device traffic — by construction the design scales linearly until
the single psum dominates.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import Mesh, PartitionSpec as P

from ._shmap import shard_map_nocheck

from ..core.bitslice import (
    blocks_to_words,
    encrypt_planes,
    planes_to_words,
    words_to_blocks,
    words_to_planes,
)
from ..ops.counter import counter_planes_be
from ..ops.gf128 import mat_power_gf2_np
from ..ops.ghash_bulk import (
    _gf2_matmul_i8,
    ghash_finalize,
    ghash_from_bits,
    planes_to_bits_i8,
)
from ..utils.bytesio import BLOCK


def shard_adjust_matrices(m_h: jax.Array, blocks_per_shard: int,
                          num_shards: int) -> jax.Array:
    """adj[s] = (M^(L*(S-1-s)))^T as int8, for the cross-shard combine."""
    m_l = mat_power_gf2_np(np.asarray(m_h), blocks_per_shard).astype(np.int64)
    mats = [np.eye(128, dtype=np.int64)]
    for _ in range(num_shards - 1):
        mats.append((mats[-1] @ m_l) % 2)
    stack = np.stack(
        [mats[num_shards - 1 - s].T for s in range(num_shards)])
    return jnp.asarray(stack.astype(np.int8))


def _local_seal(kp, tables, j0, pt, start, tile):
    """Per-(message, shard) pipeline in the bit-plane domain."""
    l = pt.shape[0]
    nwords = -(-(l + 2) // 32)
    nwords += (-nwords) % 4
    ctr_planes = counter_planes_be(j0, nwords, start)
    ks_planes = encrypt_planes(kp, ctr_planes)
    pt_words = blocks_to_words(pt)
    pt_words = jnp.pad(pt_words, ((0, 0), (2, 32 * nwords - l - 2)))
    ct_planes = words_to_planes(pt_words) ^ ks_planes
    ct = words_to_blocks(planes_to_words(ct_planes)[:, 2: l + 2])
    bits = planes_to_bits_i8(ct_planes)[2: l + 2]
    gpad = (-l) % tile
    if gpad:
        bits = jnp.concatenate(
            [jnp.zeros((gpad, 128), jnp.int8), bits], axis=0)
    acc = ghash_from_bits(tables, bits)
    return ct, acc


def shard_adjust_matrices_fused(m_h: jax.Array, blocks_per_shard: int,
                                num_shards: int, chunk2: int = 32) -> jax.Array:
    """Per-shard combine matrices for the *fused-kernel* local pipeline:
    A_s = M^(L*(S-1-s)) . M^(-z) where z is the local trailing stream pad
    (modes/seal.fused_trailing_pad) — one matrix absorbs both the shard
    offset and the local pad compensation.  Returned transposed, int8.
    chunk2 must match the GHASH tables the sharded fn will run with."""
    from ..modes.seal import fused_trailing_pad
    from ..ops.gf128 import gf2_matinv_np

    z = fused_trailing_pad(blocks_per_shard, chunk2)
    minv_z = (gf2_matinv_np(mat_power_gf2_np(np.asarray(m_h), z))
              if z else np.eye(128, dtype=np.uint8))
    m_l = mat_power_gf2_np(np.asarray(m_h), blocks_per_shard)
    mats = [np.eye(128, dtype=np.uint8)]
    for _ in range(num_shards - 1):
        mats.append((mats[-1].astype(np.int32) @ m_l.astype(np.int32) % 2
                     ).astype(np.uint8))
    stack = np.stack([
        ((mats[num_shards - 1 - s].astype(np.int32) @ minv_z.astype(np.int32))
         % 2).astype(np.int8).T
        for s in range(num_shards)
    ])
    return jnp.asarray(stack)


def sharded_aad_args(key: bytes, aad: bytes, total_blocks: int,
                     batch: int):
    """Host-side prep of the per-batch AAD arguments for the sharded
    fused fn: (aad_acc int8[B,128] plane-order GHASH partial of the AAD,
    aad_shift_t int8[128,128] = (M^n_ct)^T, aad_bytes).  With no AAD the
    partial is zeros and the shift is identity — the fold is a no-op."""
    from ..modes.seal import _STD2PLANE, gcm_key_setup
    from ..ops.gf128 import blocks_to_bits

    aad = bytes(aad or b"")
    if not aad:
        return (jnp.zeros((batch, 128), jnp.int8),
                jnp.asarray(np.eye(128, dtype=np.int8)), 0)
    _, tables = gcm_key_setup(key)
    na = -(-len(aad) // BLOCK)
    blocks = np.zeros((na, BLOCK), np.uint8)
    blocks.reshape(-1)[: len(aad)] = np.frombuffer(aad, np.uint8)
    chunk2 = tables[1].shape[0] // 128
    tile = 32 * chunk2
    abits = blocks_to_bits(jnp.asarray(blocks)).astype(jnp.int8)[:, _STD2PLANE]
    apad = (-na) % tile
    if apad:
        abits = jnp.concatenate(
            [jnp.zeros((apad, 128), jnp.int8), abits], axis=0)
    g_aad = ghash_from_bits(tables, abits).astype(jnp.int8)
    shift_t = jnp.asarray(
        mat_power_gf2_np(np.asarray(tables[3]), total_blocks).T.astype(np.int8))
    return (jnp.broadcast_to(g_aad, (batch, 128)), shift_t, len(aad))


def gcm_sharded_fused_fn(mesh: Mesh, total_blocks: int, aad_bytes: int = 0,
                         open_direction: bool = False):
    """The fused sharded GCM engine: every shard runs modes/seal.
    fused_seal_body, so each takes its platform's keystream engine (the
    GPU kernel of ops/ctr_kernel on a GPU, the XLA engine elsewhere).

    Returns fn(kp, tables, adj, j0[B,16], ek_j0[B,16], pt[B,N,16],
    aad_acc[B,128] int8, aad_shift_t[128,128] int8) -> (out[B,N,16],
    tag[B,16]).  adj from shard_adjust_matrices_fused; aad_acc/shift from
    sharded_aad_args.  open_direction=True runs GHASH over the *input*
    (GCM open); the caller verifies the returned tag before releasing
    the plaintext (modes/seal.gcm_open ordering)."""
    from ..modes.seal import _len_block, fused_seal_body

    sp = mesh.shape["sp"]
    assert total_blocks % sp == 0
    l_shard = total_blocks // sp
    assert l_shard % 32 == 0

    def local_fn(kp, tables, adj, j0, ek_j0, pt, aad_acc, aad_shift_t):
        sp_idx = jax.lax.axis_index("sp")
        start = (sp_idx * l_shard - 1).astype(jnp.int32)
        out, _ek, acc = jax.vmap(
            lambda j, x: fused_seal_body(kp, tables, j, x, open_direction,
                                         start)
        )(j0, pt)
        g_adj = _gf2_matmul_i8(acc.astype(jnp.int8), adj[0])
        g = jax.lax.psum(g_adj, "sp") & 1
        g = g ^ _gf2_matmul_i8(aad_acc, aad_shift_t)  # AAD folds in front
        tag = ek_j0 ^ jax.vmap(
            lambda gb: ghash_finalize(tables, (gb & 1).astype(jnp.uint8),
                                      _len_block(total_blocks, aad_bytes))
        )(g)
        return out, tag

    fn = shard_map_nocheck(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(), P("sp"), P("dp"), P("dp"), P("dp", "sp"),
                  P("dp"), P()),
        out_specs=(P("dp", "sp"), P("dp")),
    )
    return jax.jit(fn)


def gcm_seal_sharded_fused_fn(mesh: Mesh, total_blocks: int):
    """Back-compat builder: seal direction, no AAD.  Same signature as
    gcm_seal_sharded_fn; adj from shard_adjust_matrices_fused."""
    inner = gcm_sharded_fused_fn(mesh, total_blocks)

    def fn(kp, tables, adj, j0, ek_j0, pt):
        b = j0.shape[0]
        return inner(kp, tables, adj, j0, ek_j0, pt,
                     jnp.zeros((b, 128), jnp.int8),
                     jnp.asarray(np.eye(128, dtype=np.int8)))

    return fn


def gcm_seal_sharded_fn(mesh: Mesh, total_blocks: int):
    """Build the jitted sharded seal for a given mesh and message length.

    Returns fn(kp, tables, adj, j0[B,16], ek_j0[B,16], pt[B,N,16])
    -> (ct[B,N,16], tag[B,16]).  J0 low word must be 1 (12-byte nonce)."""
    sp = mesh.shape["sp"]
    assert total_blocks % sp == 0
    l_shard = total_blocks // sp
    assert l_shard % 32 == 0, "per-shard length must be 32-block aligned"

    def local_fn(kp, tables, adj, j0, ek_j0, pt):
        tile = 32 * (tables[1].shape[0] // 128)
        sp_idx = jax.lax.axis_index("sp")
        start = (sp_idx * l_shard - 1).astype(jnp.int32)
        ct, acc = jax.vmap(
            lambda j, x: _local_seal(kp, tables, j, x, start, tile)
        )(j0, pt)
        g_adj = _gf2_matmul_i8(acc.astype(jnp.int8), adj[0])  # [Bl,128]
        g = jax.lax.psum(g_adj, "sp") & 1  # XOR across shards == parity
        len_block = jnp.zeros(BLOCK, jnp.uint8)
        nbits = total_blocks * BLOCK * 8
        for i in range(8):
            len_block = len_block.at[15 - i].set((nbits >> (8 * i)) & 0xFF)
        tag = ek_j0 ^ jax.vmap(
            lambda gb: ghash_finalize(tables, gb.astype(jnp.uint8), len_block)
        )(g)
        return ct, tag

    fn = shard_map_nocheck(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(), P("sp"), P("dp"), P("dp"), P("dp", "sp")),
        out_specs=(P("dp", "sp"), P("dp")),
    )
    return jax.jit(fn)
