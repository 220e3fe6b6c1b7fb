"""Serial-chain device kernels (lax.scan): CBC/CFB encrypt, OFB keystream.

These chains have strict loop-carried dependence (SURVEY §3.2), so within
one message they run as a `lax.scan`; batching across messages is how they
parallelize (see parallel/).  Scans are causal, so shape-bucketed padded
tails never affect the valid prefix.
"""
from __future__ import annotations

import jax

from ..core.cipher import encrypt_blocks


@jax.jit
def cbc_encrypt_scan(round_keys, iv, blocks):
    """y_i = E(iv ^ x_i); iv = y_i  (micro_aes.c:712-717)."""

    def step(carry, x):
        y = encrypt_blocks(round_keys, (carry ^ x)[None, :])[0]
        return y, y

    _, ys = jax.lax.scan(step, iv, blocks)
    return ys


@jax.jit
def cfb_encrypt_scan(round_keys, iv, blocks):
    """y_i = E(iv) ^ x_i; iv = y_i  (micro_aes.c:808-814, mode=1)."""

    def step(carry, x):
        y = encrypt_blocks(round_keys, carry[None, :])[0] ^ x
        return y, y

    _, ys = jax.lax.scan(step, iv, blocks)
    return ys


@jax.jit
def ofb_keystream_scan(round_keys, iv, nblocks_arr):
    """iv_{i+1} = E(iv_i); emits the keystream blocks (micro_aes.c:872-876).
    nblocks_arr is a dummy [N] array fixing the scan length."""

    def step(carry, _):
        y = encrypt_blocks(round_keys, carry[None, :])[0]
        return y, y

    _, ks = jax.lax.scan(step, iv, nblocks_arr)
    return ks


# ---------------------------------------------------------------------------
# Lane-packed chain scans, the form the dp-sharded chain engine runs
# (parallel/batch.chain_sharded_fn).  The vmapped scans above run the
# table-form cipher per message.  Here the scan runs over the BLOCK index with
# the whole message batch bit-packed into planes — 32 messages per uint32
# word, per-lane keys via core.bitslice.key_planes_packed — so each serial
# step is one bitsliced cipher over the full batch.
# ---------------------------------------------------------------------------


@jax.jit
def cbc_encrypt_scan_packed(kpw, ivs, blocks):
    """Batch-bitsliced CBC chains: ivs uint8[B,16], blocks uint8[B,nb,16],
    kpw uint32[R+1,8,16,B/32]; B % 32 == 0.  Returns uint8[B,nb,16]."""
    from ..core.bitslice import (
        encrypt_planes_multikey,
        pack_planes,
        unpack_planes,
    )

    b = ivs.shape[0]
    x = jax.vmap(pack_planes, in_axes=1)(blocks)  # [nb, 8, 16, W]

    def step(carry, xp):
        y = encrypt_planes_multikey(kpw, carry ^ xp)
        return y, y

    _, ys = jax.lax.scan(step, pack_planes(ivs), x)
    return jax.vmap(lambda p: unpack_planes(p, b), out_axes=1)(ys)


@jax.jit
def cfb_encrypt_scan_packed(kpw, ivs, blocks):
    """Batch-bitsliced CFB encrypt chains (y = E(carry) ^ x; iv = y)."""
    from ..core.bitslice import (
        encrypt_planes_multikey,
        pack_planes,
        unpack_planes,
    )

    b = ivs.shape[0]
    x = jax.vmap(pack_planes, in_axes=1)(blocks)

    def step(carry, xp):
        y = encrypt_planes_multikey(kpw, carry) ^ xp
        return y, y

    _, ys = jax.lax.scan(step, pack_planes(ivs), x)
    return jax.vmap(lambda p: unpack_planes(p, b), out_axes=1)(ys)


@jax.jit
def ofb_keystream_scan_packed(kpw, ivs, nblocks_arr):
    """Batch-bitsliced OFB keystreams (iv_{i+1} = E(iv_i))."""
    from ..core.bitslice import (
        encrypt_planes_multikey,
        pack_planes,
        unpack_planes,
    )

    b = ivs.shape[0]

    def step(carry, _):
        y = encrypt_planes_multikey(kpw, carry)
        return y, y

    _, ks = jax.lax.scan(step, pack_planes(ivs), nblocks_arr)
    return jax.vmap(lambda p: unpack_planes(p, b), out_axes=1)(ks)
