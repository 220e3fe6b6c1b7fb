"""Counter-mode AES keystream as one Pallas kernel for NVIDIA GPUs.

The GCM seal/open and bulk CTR spend their time in the bitsliced AES
circuit: about 75 32-bit logic operations per byte at AES-256 against one
byte read and one written, so the work is bound by the integer ALUs once
the round state stays on chip.  This kernel (Pallas, Triton route) runs
all rounds of a tile in one program:

  * one program owns TILE stream columns (32*TILE blocks); the state is
    128 rows of TILE u32 — plane (bit b, byte pos) of 32 blocks per lane
    word, exactly core/bitslice's layout — and every row is held by the
    same threads throughout, so no thread ever reads another's data;
  * the counter planes come from the per-column counter (lo, hi) and
    the J0 bits inside the kernel, so only the data crosses HBM;
  * each round is a loop over the four state columns: load the column's
    ShiftRows sources (32 rows), MixColumns, AddRoundKey and the next
    round's SubBytes on those rows in registers, store them; the rows
    round-trip through a per-program scratch block that stays in L1/L2.
    Keeping the whole 14-round state in registers instead (rows as a
    Python list, ShiftRows as re-indexing) compiled for 7-9 minutes per
    shape; these loops compile in seconds;
  * the key planes are scalars (0 or ~0 per round, bit and byte) read
    from one small constant vector;
  * the stream enters transposed ([128, W]: row l = lane l of every
    column), so each row load and store is contiguous.

`ctr_fused_kernel` takes the same arguments as stream.ctr_fused_jnp, its
reference, and returns the same words; `use_kernel` is the one place
that chooses between them.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..core.bitslice import _transpose32, _xtime_planes, sbox_planes
from .counter import _LOW_BIT_PATTERNS

# Stream columns per program (32*TILE blocks) and warps per program.
TILE = 128
NUM_WARPS = 4

# Constant vector: [0, 128) J0 bit planes (row b*16 + pos), [128, 133)
# the low-counter-bit lane patterns, then the key planes of rounds 0..R
# at _KEY0 + 128*r + 16*b + pos; padded to a power of two.
_CONSTS = 4096
_PAT0 = 128
_KEY0 = 256


def use_kernel() -> bool:
    """The platform choice: the kernel on a GPU, the XLA reference
    (stream.ctr_fused_jnp / seal_fused_jnp) everywhere else."""
    return jax.default_backend() == "gpu"


def seal_word_align() -> int:
    """Stream-width alignment of the counter-mode engines: the kernel's
    tile where the kernel runs (so its wrapper never pads), else 8."""
    return TILE if use_kernel() else 8


def _ctr_kernel(rounds: int, c_ref, lohi_ref, x_ref, o_ref, s_ref):
    """s_ref [256, TILE] holds two state copies (rows 128*i + 16*b + pos)
    that the rounds ping-pong between."""
    lo = lohi_ref[0, :]
    hi = lohi_ref[1, :]
    zero = jnp.zeros_like(lo)

    def key(r, pos, b):
        return c_ref[_KEY0 + 128 * r + 16 * b + pos]

    def ctr_row(p, b):
        """Counter plane (bit b, byte position p) of the tile: J0 bits
        in bytes 0..8, the 24-bit extension hi in bytes 9..11, the low
        word in bytes 12..15 (its low 5 bits fixed lane patterns)."""
        k_lo = 8 * (15 - p) + b
        k_hi = 8 * (11 - p) + b
        from_lo = jnp.where(
            k_lo < 5, c_ref[_PAT0 + jnp.clip(k_lo, 0, 4)] | zero,
            zero - ((lo >> jnp.clip(k_lo, 0, 31).astype(jnp.uint32)) & 1))
        from_hi = zero - ((hi >> jnp.clip(k_hi, 0, 31).astype(jnp.uint32))
                          & 1)
        return jnp.where(p <= 8, c_ref[16 * b + p] | zero,
                         jnp.where(p >= 12, from_lo, from_hi))

    def init(p, carry):
        # round 0 AddRoundKey, then round 1 SubBytes, on position p
        x = [ctr_row(p, b) ^ key(0, p, b) for b in range(8)]
        s = sbox_planes(x, True)
        for b in range(8):
            s_ref[16 * b + p, :] = s[b]
        return carry

    jax.lax.fori_loop(0, 16, init, 0)

    def shifted_column(base, c):
        """The four ShiftRows sources of state column c (row rr comes
        from column (c + rr) % 4), as a[rr][b]."""
        return [[s_ref[base + 16 * b + 4 * ((c + rr) & 3) + rr, :]
                 for b in range(8)] for rr in range(4)]

    def column(c, r):
        # ShiftRows + MixColumns + AddRoundKey of round r, SubBytes of
        # round r + 1, on state column c
        a = shifted_column(128 * ((r - 1) & 1), c)
        wr = 128 * (r & 1)
        for rr in range(4):
            a1, a2, a3 = a[(rr + 1) % 4], a[(rr + 2) % 4], a[(rr + 3) % 4]
            t = _xtime_planes([a[rr][b] ^ a1[b] for b in range(8)])
            mixed = [t[b] ^ a1[b] ^ a2[b] ^ a3[b] ^ key(r, 4 * c + rr, b)
                     for b in range(8)]
            s = sbox_planes(mixed, True)
            for b in range(8):
                s_ref[wr + 16 * b + 4 * c + rr, :] = s[b]
        return r

    def round_body(r, carry):
        jax.lax.fori_loop(0, 4, column, r)
        return carry

    jax.lax.fori_loop(1, rounds, round_body, 0)

    def emit(k, carry):
        # last round's ShiftRows + AddRoundKey on column k = stream word
        # k (bit r of word k = byte 4k + r//8, bit r%8), transposed back
        # to words and xored onto the data rows 4j + k
        a = shifted_column(128 * ((rounds - 1) % 2), k)
        rows = [a[r // 8][r % 8] ^ key(rounds, 4 * k + r // 8, r % 8)
                for r in range(32)]
        words = _transpose32(rows)
        for j in range(32):
            o_ref[4 * j + k, :] = x_ref[4 * j + k, :] ^ words[j]
        return carry

    jax.lax.fori_loop(0, 4, emit, 0)


@functools.partial(jax.jit, static_argnames=("interpret",))
def ctr_fused_kernel(kp_flat, j0_const, lohi, pt_words,
                     interpret: bool = False):
    """Counter + cipher + xor through the kernel: kp_flat
    uint32[(R+1)*128, 1], j0_const uint32[128, 1], lohi uint32[2, W],
    pt_words uint32[W, 128] -> uint32[W, 128] (as stream.ctr_fused_jnp).
    W need not be a multiple of TILE: the wrapper pads and slices.
    interpret=True runs the same kernel through the Pallas interpreter
    (CPU tests)."""
    rounds = kp_flat.shape[0] // 128 - 1
    w = lohi.shape[-1]
    pad = (-w) % TILE
    consts = jnp.concatenate([
        j0_const.reshape(-1),
        jnp.asarray(np.resize(_LOW_BIT_PATTERNS, _KEY0 - _PAT0)),
        kp_flat.reshape(-1)])
    consts = jnp.pad(consts, (0, _CONSTS - consts.shape[0]))
    x = jnp.pad(jnp.transpose(pt_words), ((0, 0), (0, pad)))
    lohi = jnp.pad(lohi, ((0, 0), (0, pad)))
    out, _ = pl.pallas_call(
        functools.partial(_ctr_kernel, rounds),
        out_shape=(jax.ShapeDtypeStruct(x.shape, jnp.uint32),
                   jax.ShapeDtypeStruct((256, x.shape[1]), jnp.uint32)),
        grid=(x.shape[1] // TILE,),
        in_specs=[
            pl.BlockSpec((_CONSTS,), lambda i: (0,)),
            pl.BlockSpec((2, TILE), lambda i: (0, i)),
            pl.BlockSpec((128, TILE), lambda i: (0, i)),
        ],
        out_specs=(pl.BlockSpec((128, TILE), lambda i: (0, i)),
                   pl.BlockSpec((256, TILE), lambda i: (0, i))),
        input_output_aliases={2: 0},
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="aes_ctr_keystream",
    )(consts, lohi, x)
    return jnp.transpose(out[:, :w])
