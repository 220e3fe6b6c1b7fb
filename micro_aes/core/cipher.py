"""Batched Rijndael block permutation in pure jnp (the correctness oracle).

This is the reference compute path: `uint8[N, 16] -> uint8[N, 16]`,
vectorized over the block axis.  It mirrors the behavior of
micro_aes.c:242-259 (rijndaelEncrypt) / 315-332 (rijndaelDecrypt) but is a
fresh vectorized formulation:

  * state layout is a flat 16-byte vector per block; index j = 4*col + row
    (the reference's `state_t` is also column-major, micro_aes.c:74-77);
  * SubBytes is a 256-entry vectorized gather (the bitsliced circuit of
    core/bitslice.py replaces it on the bulk paths);
  * ShiftRows is a static permutation;
  * MixColumns is the circulant [2 3 1 1] GF(2^8) matrix applied via rolls.

All functions take the round-key schedule explicitly (pure/functional; no
global RoundKey as in the reference).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .sbox import INV_SBOX, SBOX

# out[j] = in[SHIFT_PERM[j]]: row r of the state rotates left by r
# (micro_aes.c:198-218); with j = 4c + r the source is 4*((c+r)%4) + r.
SHIFT_PERM = np.array(
    [4 * ((j // 4 + j % 4) % 4) + j % 4 for j in range(16)], dtype=np.int32
)
INV_SHIFT_PERM = np.argsort(SHIFT_PERM).astype(np.int32)

# NOTE: keep lookup tables as *numpy* constants.  A module-level device
# array would be fetched from the accelerator during every jit lowering;
# numpy constants are
# embedded into the HLO directly at trace time.
_SBOX_J = SBOX
_INV_SBOX_J = INV_SBOX


def _xtime(x: jax.Array) -> jax.Array:
    """Doubling in GF(2^8) (micro_aes.c:115-118), elementwise on uint8."""
    return ((x << 1) & 0xFF).astype(jnp.uint8) ^ ((x >> 7) * 0x1B).astype(jnp.uint8)


def _mix_columns(s: jax.Array) -> jax.Array:
    """Circulant [2 3 1 1] per column; s has shape [..., 4cols, 4rows]."""
    a1 = jnp.roll(s, -1, axis=-1)
    a2 = jnp.roll(s, -2, axis=-1)
    a3 = jnp.roll(s, -3, axis=-1)
    return _xtime(s) ^ _xtime(a1) ^ a1 ^ a2 ^ a3


def _inv_mix_columns(s: jax.Array) -> jax.Array:
    """Circulant [14 11 13 9] per column (micro_aes.c:301-312)."""
    x2 = _xtime(s)
    x4 = _xtime(x2)
    x8 = _xtime(x4)
    m9 = x8 ^ s
    mb = x8 ^ x2 ^ s
    md = x8 ^ x4 ^ s
    me = x8 ^ x4 ^ x2
    return me ^ jnp.roll(mb, -1, axis=-1) ^ jnp.roll(md, -2, axis=-1) ^ jnp.roll(m9, -3, axis=-1)


def encrypt_blocks(round_keys: jax.Array, blocks: jax.Array) -> jax.Array:
    """AES-encrypt a batch: round_keys uint8[R+1, 16], blocks uint8[N..., 16]."""
    rounds = round_keys.shape[0] - 1
    s = blocks ^ round_keys[0]
    for r in range(1, rounds + 1):
        s = jnp.take(_SBOX_J, s)
        s = s[..., SHIFT_PERM]
        if r != rounds:
            shape = s.shape
            s = _mix_columns(s.reshape(shape[:-1] + (4, 4))).reshape(shape)
        s = s ^ round_keys[r]
    return s


def decrypt_blocks(round_keys: jax.Array, blocks: jax.Array) -> jax.Array:
    """Inverse cipher (equivalent of micro_aes.c:315-332), batched."""
    rounds = round_keys.shape[0] - 1
    s = blocks ^ round_keys[rounds]
    for r in range(rounds - 1, -1, -1):
        s = s[..., INV_SHIFT_PERM]
        s = jnp.take(_INV_SBOX_J, s)
        s = s ^ round_keys[r]
        if r != 0:
            shape = s.shape
            s = _inv_mix_columns(s.reshape(shape[:-1] + (4, 4))).reshape(shape)
    return s


@jax.jit
def _encrypt_jit(rk, x):
    return encrypt_blocks(rk, x)


@jax.jit
def _decrypt_jit(rk, x):
    return decrypt_blocks(rk, x)


def aes_cipher(key, mode: str, block: bytes) -> bytes:
    """Single-block raw-cipher API, parity with AES_Cipher (micro_aes.h:162-167,
    micro_aes.c:343-347). mode 'E' encrypts, 'D' decrypts."""
    from ..utils.bytesio import from_blocks, to_blocks
    from .keyschedule import expand_key

    rk = jnp.asarray(expand_key(key))
    x = jnp.asarray(to_blocks(block))
    fn = _encrypt_jit if (isinstance(mode, str) and mode.upper() == "E") or mode == 1 else _decrypt_jit
    return from_blocks(fn(rk, x), 16)
