"""MAC fold engines: CBC-MAC (xMac/cMac) and GHASH/POLYVAL.

The reference folds serially through function pointers (xMac,
micro_aes.c:551-571; cMac c:576-590; gHash c:1127-1137).  Here:

  * `cbcmac_fold` — the loop-carried cipher fold as one `lax.scan` (one
    device call per message, still serial by nature);
  * `ghash_fold` — serial Horner fold where each step is a GF(2) bit
    matvec with the precomputed M_H (ops/gf128.ghash_matrix);
  * `ghash_fold_batch` / `cbcmac_fold_batch` — vectorized over many
    independent messages (the conformance-suite workhorses).

The powers-of-H parallel reformulation of the Horner chain lives in
ops/ghash_bulk.py (int8 matrix products + log-depth combine).

All folds are masked (`nvalid` may be traced) so callers can bucket
shapes under jit without changing results.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.cipher import encrypt_blocks
from .gf128 import bits_to_blocks, blocks_to_bits, mat_apply_bits


@functools.partial(jax.jit, static_argnames=())
def cbcmac_fold(round_keys, init, blocks, nvalid):
    """M_{i+1} = Enc(M_i ^ x_i) over blocks[:nvalid]; init/result uint8[16]."""
    idx = jnp.arange(blocks.shape[0])

    def step(m, xi):
        x, i = xi
        m2 = encrypt_blocks(round_keys, (m ^ x)[None, :])[0]
        return jnp.where(i < nvalid, m2, m), None

    out, _ = jax.lax.scan(step, init, (blocks, idx))
    return out


@jax.jit
def ghash_fold(m_h, init, blocks, nvalid):
    """G_{i+1} = M_H @ (G_i ^ b_i) over blocks[:nvalid] (GHASH or POLYVAL,
    depending on which matrix is passed).  All in bit-vector space."""
    g0 = blocks_to_bits(init)
    bbits = blocks_to_bits(blocks)
    idx = jnp.arange(blocks.shape[0])

    def step(g, xi):
        b, i = xi
        g2 = mat_apply_bits(m_h, g ^ b)
        return jnp.where(i < nvalid, g2, g), None

    g, _ = jax.lax.scan(step, g0, (bbits, idx))
    return bits_to_blocks(g)


@functools.partial(jax.jit, static_argnames=("polyval",))
def ghash_fold_batch(h, init, blocks, nvalid, polyval: bool = False):
    """Batched serial GHASH/POLYVAL over many independent messages:
    h/init uint8[B,16], blocks uint8[B,M,16], nvalid int32[B].

    One scan over the block axis; the 128-step bit-serial multiply is
    vectorized across the whole batch — this is the conformance-suite
    workhorse (each CAVP vector has its own key, so per-key matrices
    don't amortize)."""
    from .gf128 import dot_gf128, mul_gf128

    mul = dot_gf128 if polyval else mul_gf128
    idx = jnp.arange(blocks.shape[1])

    def step(acc, xi):
        b, i = xi  # b: [B, 16]
        acc2 = mul(h, acc ^ b)
        return jnp.where((i < nvalid)[:, None], acc2, acc), None

    acc, _ = jax.lax.scan(step, init, (jnp.swapaxes(blocks, 0, 1), idx))
    return acc


@jax.jit
def cbcmac_fold_batch(rks, init, blocks, nvalid):
    """Batched CBC-MAC fold: rks uint8[B,R+1,16], init uint8[B,16],
    blocks uint8[B,M,16], nvalid int32[B]."""
    idx = jnp.arange(blocks.shape[1])
    enc1 = jax.vmap(lambda rk, x: encrypt_blocks(rk, x[None, :])[0])

    def step(acc, xi):
        b, i = xi
        acc2 = enc1(rks, acc ^ b)
        return jnp.where((i < nvalid)[:, None], acc2, acc), None

    acc, _ = jax.lax.scan(step, init, (jnp.swapaxes(blocks, 0, 1), idx))
    return acc


# ---------------------------------------------------------------------------
# Host-side numpy GF doubling (for CMAC/OCB/XTS subkey derivation)
# ---------------------------------------------------------------------------

def double_be_np(x: np.ndarray) -> np.ndarray:
    """numpy doubleBblock (micro_aes.c:434-443)."""
    x = np.asarray(x, dtype=np.uint8)
    y = ((x << 1) & 0xFF).astype(np.uint8)
    y[..., :-1] |= x[..., 1:] >> 7
    y[..., 15] ^= (x[..., 0] >> 7) * 0x87
    return y


def double_le_np(x: np.ndarray) -> np.ndarray:
    """numpy doubleLblock (micro_aes.c:449-458)."""
    x = np.asarray(x, dtype=np.uint8)
    y = ((x << 1) & 0xFF).astype(np.uint8)
    y[..., 1:] |= x[..., :-1] >> 7
    y[..., 0] ^= (x[..., 15] >> 7) * 0x87
    return y
