"""Counter-block generation for all CTR-based modes.

The reference drives six modes through one serial `CTR_cipher` loop with
per-mode counter conventions (micro_aes.c:901-950 + incBlock c:421-428).
Here the counter stream is *computed from the block index alone*, so the
whole keystream is embarrassingly parallel: `counter_blocks` maps
`(base_block, arange(n))` to the n counter blocks in one vectorized shot.

incBlock's dual-endian contract (micro_aes.c:421-428) is reproduced
exactly:
  * index = LAST: big-endian counting over bytes 15 down to 9 (56-bit
    counter; the carry chain stops after byte 9) — CTR/GCM/CCM/SIV/EAX.
  * index = 0: little-endian counting over bytes 0..3 (32-bit counter) —
    GCM-SIV only.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Per-mode setup (ctr_based_modes, micro_aes.c:903-909):
#   CTR_DEFAULT: use base as-is, count BE from offset 0
#   CCM_GCM:     pre-increment (count BE from offset 1)
#   SIV_CTR:     clear bit7 of bytes 8 and 12, count BE
#   SIVGCM_CTR:  set bit7 of byte 15, count LE32


def prepare_counter_base(base: jax.Array, mode: str) -> tuple[jax.Array, int, str]:
    """Apply the mode's bit-fiddling; return (base, start_offset, endianness)."""
    if mode == "ctr":
        return base, 0, "be"
    if mode == "ccm_gcm":
        return base, 1, "be"
    if mode == "siv":
        base = base.at[8].set(base[8] & 0x7F).at[12].set(base[12] & 0x7F)
        return base, 0, "be"
    if mode == "gcm_siv":
        base = base.at[15].set(base[15] | 0x80)
        return base, 0, "le32"
    raise ValueError(f"unknown counter mode {mode!r}")


# Lane patterns of bit k (k < 5) of 32 consecutive aligned integers.
_LOW_BIT_PATTERNS = np.array(
    [0xAAAAAAAA, 0xCCCCCCCC, 0xF0F0F0F0, 0xFF00FF00, 0xFFFF0000],
    dtype=np.uint32,
)


def counter_planes_be(j0: jax.Array, nwords: int, start) -> jax.Array:
    """Generate BE-counter blocks *directly in bitsliced plane form*:
    uint32[8, 16, W] where word w covers counter values
    (ctr56(j0) + start + 32w + j) for lane j = 0..31.

    Requires (ctr56(j0) + start) % 32 == 0 (the seal path arranges this
    statically), which makes bits 0..4 fixed lane patterns and bits >= 5
    per-word broadcasts — no cross-lane packing at all.  Reproduces the
    reference's 56-bit counter window over bytes 9..15 (incBlock,
    micro_aes.c:421-428)."""
    b = j0.astype(jnp.uint32)
    lo0 = (b[12] << 24) | (b[13] << 16) | (b[14] << 8) | b[15]
    hi0 = (b[9] << 16) | (b[10] << 8) | b[11]
    # start is a signed 32-bit offset, sign-extended into the 56-bit window
    s32 = jnp.asarray(start, jnp.int32)
    sext = (s32 >> 31).astype(jnp.uint32)  # 0 or 0xFFFFFFFF
    base_lo = lo0 + s32.astype(jnp.uint32)
    carry0 = (base_lo < lo0).astype(jnp.uint32)
    w_idx = jnp.arange(nwords, dtype=jnp.uint32) * 32
    lo = base_lo + w_idx                                  # [W]
    carry = carry0 + (lo < base_lo).astype(jnp.uint32)
    hi = (hi0 + sext + carry) & 0xFFFFFF

    ones = jnp.uint32(0xFFFFFFFF)
    planes = []
    for bit in range(8):
        rows = []
        for pos in range(16):
            if pos <= 8:  # constant bytes from j0
                rows.append(jnp.where((j0[pos] >> bit) & 1, ones, 0)
                            * jnp.ones((nwords,), jnp.uint32))
            elif pos >= 12:  # lo32: byte 15-(k//8) <- bit k = 8*(15-pos)+bit
                k = 8 * (15 - pos) + bit
                if k < 5:
                    rows.append(jnp.full((nwords,), _LOW_BIT_PATTERNS[k],
                                         jnp.uint32))
                else:
                    rows.append(((lo >> k) & 1) * ones)
            else:  # bytes 9..11 from hi24: bit k = 8*(11-pos)+bit
                k = 8 * (11 - pos) + bit
                rows.append(((hi >> k) & 1) * ones)
        planes.append(jnp.stack(rows))
    return jnp.stack(planes)  # [8,16,W]


def counter_blocks(base: jax.Array, n: int, offset=0, endian: str = "be") -> jax.Array:
    """uint8[16] base -> uint8[n, 16] counter blocks base+offset .. base+offset+n-1."""
    i = jnp.arange(n, dtype=jnp.uint32) + jnp.uint32(offset)
    out = jnp.broadcast_to(base, (n, 16))

    if endian == "be":
        # 56-bit BE counter in bytes 9..15, split as hi24 (9..11) | lo32 (12..15)
        b = base.astype(jnp.uint32)
        lo0 = (b[12] << 24) | (b[13] << 16) | (b[14] << 8) | b[15]
        hi0 = (b[9] << 16) | (b[10] << 8) | b[11]
        lo = lo0 + i
        carry = (lo < lo0).astype(jnp.uint32)
        hi = (hi0 + carry) & 0xFFFFFF
        cols = [
            (hi >> 16) & 0xFF, (hi >> 8) & 0xFF, hi & 0xFF,
            (lo >> 24) & 0xFF, (lo >> 16) & 0xFF, (lo >> 8) & 0xFF, lo & 0xFF,
        ]
        tail = jnp.stack(cols, axis=-1).astype(jnp.uint8)
        return jnp.concatenate([out[:, :9], tail], axis=1)

    if endian == "le32":
        b = base.astype(jnp.uint32)
        v0 = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
        v = v0 + i  # 32-bit wrap
        head = jnp.stack(
            [v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF, (v >> 24) & 0xFF],
            axis=-1,
        ).astype(jnp.uint8)
        return jnp.concatenate([head, out[:, 4:]], axis=1)

    raise ValueError(f"unknown endian {endian!r}")
