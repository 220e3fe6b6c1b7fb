"""Bitsliced AES: the S-box as a GF((2^2)^2)^2 tower-field boolean circuit.

Rationale (SURVEY §7 "hard parts"): a per-byte table gather is slow or
absent on vector hardware, so the table-lookup SubBytes of core/cipher.py
is the correctness oracle only.  Here each of the 128 state bits becomes a
*plane* — a uint32 word holding that bit for 32 blocks — and every AES
round is pure XOR/AND plane algebra on the integer ALUs:

  * SubBytes  -> the Boyar–Peralta logic-minimized circuit (forward:
                 115 netlist gates = 119 vector ops, XNOR lowering to
                 XOR+NOT; inverse: 130 vector ops, DERIVED at import from
                 the forward circuit's shared nonlinear middle by
                 composing its probed linear layers with the inverse
                 affine map — see the S-box section below); both
                 directions are verified against all 256 entries of the
                 algebraically-derived tables at import, and the op
                 counts are pinned by tests/test_core.py;
  * ShiftRows -> a static permutation of the 16 byte-position columns;
  * MixColumns-> xtime is a plane-index shuffle + conditional XOR;
  * AddRoundKey-> XOR with broadcast key planes.

State layout: planes[8, 16, W] uint32 — bit index, byte position, packed
batch (W = N/32 blocks).  The same circuit functions run in plain jnp
and, on row vectors, inside the GPU kernel of ops/ctr_kernel.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .cipher import INV_SHIFT_PERM, SHIFT_PERM
from .sbox import INV_SBOX, SBOX

def _gf2_matinv(m):
    n = m.shape[0]
    a = np.concatenate([m.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r, col])
        a[[col, piv]] = a[[piv, col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= a[col]
    return a[:, n:]


def _affine_matrix():
    """L of the AES affine transform y = L x ^ 0x63."""
    L = np.zeros((8, 8), dtype=np.uint8)
    for k in range(8):
        for j in range(5):  # x, rotl1..rotl4
            L[k, (k - j) % 8] ^= 1
    return L


_L = _affine_matrix()
_LI = _gf2_matinv(_L)
_C_BITS = np.array([(0x63 >> k) & 1 for k in range(8)], np.uint8)


# ---------------------------------------------------------------------------
# S-box circuit (works on any array type supporting ^, & and ~)
# ---------------------------------------------------------------------------
# Forward: the logic-minimized combinational circuit of Boyar & Peralta
# ("A new combinational logic minimization technique with applications
# to cryptology", SEA 2010) — 115 netlist gates, 119 VPU ops (the four
# output XNORs lower to XOR+NOT) vs the 178 of the tower-field circuit
# this replaces; SubBytes dominates every fused kernel, so this is a
# direct VPU-op reduction on the hot path.  (The reference instead
# stores both boxes as 256-byte ROM literals, micro_aes.c:41-64.)
#
# Inverse: NOT transcribed — DERIVED at import.  The netlist factors as
# S(x) = bottom(middle(top(x))) with top/bottom linear over GF(2) and a
# shared nonlinear middle computing the field inversion, so with
# S(x) = L·inv(x) ^ 0x63 the inverse box S⁻¹(x) = inv(L⁻¹(x ^ 0x63))
# needs only new linear layers: probe the forward top matrix R (y = R·x)
# and bottom affine (s = M·z ^ k) with unit vectors, compose both with
# L⁻¹, and re-factor the composed matrices into straight-line XOR
# programs (randomized-restart Paar CSE, fixed seed).  The 0x63 input
# constant becomes NOTs on the planes of its set bits.  130 gates vs
# the tower inverse's 182.  Both directions are verified against the
# algebraically-derived tables at import (_selfcheck).


def _bp_top(u):
    """Top linear layer: u = [U0..U7] MSB-first input bits -> the 22
    shared signals [y1..y21, U7] the nonlinear middle consumes."""
    u0, u1, u2, u3, u4, u5, u6, u7 = u
    y14 = u3 ^ u5
    y13 = u0 ^ u6
    y9 = u0 ^ u3
    y8 = u0 ^ u5
    t0 = u1 ^ u2
    y1 = t0 ^ u7
    y4 = y1 ^ u3
    y12 = y13 ^ y14
    y2 = y1 ^ u0
    y5 = y1 ^ u6
    y3 = y5 ^ y8
    t1 = u4 ^ y12
    y15 = t1 ^ u5
    y20 = t1 ^ u1
    y6 = y15 ^ u7
    y10 = y15 ^ t0
    y11 = y20 ^ y9
    y7 = u7 ^ y11
    y17 = y10 ^ y11
    y19 = y10 ^ y8
    y16 = t0 ^ y11
    y21 = y13 ^ y16
    y18 = u0 ^ y16
    return [y1, y2, y3, y4, y5, y6, y7, y8, y9, y10, y11, y12, y13, y14,
            y15, y16, y17, y18, y19, y20, y21, u7]


def _bp_middle(ys):
    """Shared nonlinear middle (32 AND + 30 XOR): GF(2^8) inversion in
    the circuit's internal basis; 22 signals in, 18 products out."""
    (y1, y2, y3, y4, y5, y6, y7, y8, y9, y10, y11, y12, y13, y14, y15,
     y16, y17, y18, y19, y20, y21, u7) = ys
    t2 = y12 & y15
    t3 = y3 & y6
    t4 = t3 ^ t2
    t5 = y4 & u7
    t6 = t5 ^ t2
    t7 = y13 & y16
    t8 = y5 & y1
    t9 = t8 ^ t7
    t10 = y2 & y7
    t11 = t10 ^ t7
    t12 = y9 & y11
    t13 = y14 & y17
    t14 = t13 ^ t12
    t15 = y8 & y10
    t16 = t15 ^ t12
    t17 = t4 ^ t14
    t18 = t6 ^ t16
    t19 = t9 ^ t14
    t20 = t11 ^ t16
    t21 = t17 ^ y20
    t22 = t18 ^ y19
    t23 = t19 ^ y21
    t24 = t20 ^ y18
    t25 = t21 ^ t22
    t26 = t21 & t23
    t27 = t24 ^ t26
    t28 = t25 & t27
    t29 = t28 ^ t22
    t30 = t23 ^ t24
    t31 = t22 ^ t26
    t32 = t31 & t30
    t33 = t32 ^ t24
    t34 = t23 ^ t33
    t35 = t27 ^ t33
    t36 = t24 & t35
    t37 = t36 ^ t34
    t38 = t27 ^ t36
    t39 = t29 & t38
    t40 = t25 ^ t39
    t41 = t40 ^ t37
    t42 = t29 ^ t33
    t43 = t29 ^ t40
    t44 = t33 ^ t37
    t45 = t42 ^ t41
    return [t44 & y15, t37 & y6, t33 & u7, t43 & y16, t40 & y1,
            t29 & y7, t42 & y11, t45 & y17, t41 & y10, t44 & y12,
            t37 & y3, t33 & y4, t43 & y13, t40 & y5, t29 & y2,
            t42 & y9, t45 & y14, t41 & y8]


def _bp_bottom(z):
    """Bottom affine layer: 18 products -> [S0..S7] MSB-first output
    bits (the four XNORs realize the 0x63 affine constant)."""
    (z0, z1, z2, z3, z4, z5, z6, z7, z8, z9, z10, z11, z12, z13, z14,
     z15, z16, z17) = z
    t46 = z15 ^ z16
    t47 = z10 ^ z11
    t48 = z5 ^ z13
    t49 = z9 ^ z10
    t50 = z2 ^ z12
    t51 = z2 ^ z5
    t52 = z7 ^ z8
    t53 = z0 ^ z3
    t54 = z6 ^ z7
    t55 = z16 ^ z17
    t56 = z12 ^ t48
    t57 = t50 ^ t53
    t58 = z4 ^ t46
    t59 = z3 ^ t54
    t60 = t46 ^ t57
    t61 = z14 ^ t57
    t62 = t52 ^ t58
    t63 = t49 ^ t58
    t64 = z4 ^ t59
    t65 = t61 ^ t62
    t66 = z1 ^ t63
    s0 = t59 ^ t63
    s6 = ~(t56 ^ t62)
    s7 = ~(t48 ^ t60)
    t67 = t64 ^ t65
    s3 = t53 ^ t66
    s4 = t51 ^ t66
    s5 = t47 ^ t65
    s1 = ~(t64 ^ s3)
    s2 = ~(t55 ^ t67)
    return [s0, s1, s2, s3, s4, s5, s6, s7]


def _xor_program(mat, restarts: int = 200, seed: int = 0):
    """Factor a GF(2) matrix [m, n] into a straight-line XOR program
    over n inputs via randomized-restart Paar pair-factoring.  Returns
    (ops, outputs): ops are (a, b) signal-index pairs appended after the
    n inputs; outputs[k] is the signal index of row k (-1 = zero row)."""
    import random
    from collections import Counter

    m, n = mat.shape
    best = None
    rng = random.Random(seed)
    for _ in range(restarts):
        rows = [set(np.nonzero(mat[r])[0].tolist()) for r in range(m)]
        nsignals = n
        ops: list[tuple[int, int]] = []
        while True:
            pairs = Counter()
            for r in rows:
                rs = sorted(r)
                for x in range(len(rs)):
                    for y in range(x + 1, len(rs)):
                        pairs[(rs[x], rs[y])] += 1
            if not pairs:
                break
            mx = max(pairs.values())
            cand = sorted(p for p, c in pairs.items() if c == mx)
            a, b = cand[rng.randrange(len(cand))]
            ops.append((a, b))
            new = nsignals
            nsignals += 1
            for r in rows:
                if a in r and b in r:
                    r.discard(a)
                    r.discard(b)
                    r.add(new)
            if all(len(r) <= 1 for r in rows):
                break
        if best is None or len(ops) < len(best[0]):
            best = (ops, [next(iter(r)) if r else -1 for r in rows])
    return best


def _derive_inverse_programs():
    """Probe the forward netlist's linear layers and compose them with
    the inverse affine transform (see the section comment above)."""
    # top: R[i] = bits of middle-input signal i as a function of x
    # (x LSB-first; the netlist's U vector is MSB-first)
    r_mat = np.zeros((22, 8), np.uint8)
    for b in range(8):
        x = [0] * 8
        x[b] = 1
        r_mat[:, b] = np.array(_bp_top(x[::-1]), np.uint8) & 1
    # bottom: s = M.z ^ k (probe with ints; ~v flips bit 0 in two's
    # complement, so masking &1 is exact)
    k_bits = np.array([_bp_bottom([0] * 18)[7 - b] & 1 for b in range(8)],
                      np.uint8)
    m_mat = np.zeros((8, 18), np.uint8)
    for j in range(18):
        z = [0] * 18
        z[j] = 1
        s = _bp_bottom(z)
        m_mat[:, j] = np.array([s[7 - b] & 1 for b in range(8)],
                               np.uint8) ^ k_bits
    # S⁻¹(x) = inv(w), w = L⁻¹(x ^ c):  y = (R L⁻¹)(x ^ c) feeds the
    # middle; inv(w) = (L⁻¹ M).z ^ L⁻¹(k ^ c)
    top = (r_mat @ _LI) % 2
    bot = (_LI @ m_mat) % 2
    bot_const = (_LI @ (k_bits ^ _C_BITS)) % 2
    return (_xor_program(top), _xor_program(bot),
            [int(v) for v in bot_const])


(_INV_TOP_OPS, _INV_TOP_OUT), (_INV_BOT_OPS, _INV_BOT_OUT), _INV_BOT_CONST = \
    _derive_inverse_programs()


def _run_program(inputs, ops, outs, consts=None):
    signals = list(inputs)
    for a, b in ops:
        signals.append(signals[a] ^ signals[b])
    out = []
    for k, idx in enumerate(outs):
        acc = signals[idx] if idx >= 0 else inputs[0] ^ inputs[0]
        if consts is not None and consts[k]:
            acc = ~acc
        out.append(acc)
    return out


def sbox_planes(planes, forward: bool = True):
    """Apply (inverse) SubBytes to a list of 8 bit-planes (LSB-first)."""
    if forward:
        return _bp_bottom(_bp_middle(_bp_top(planes[::-1])))[::-1]
    x = [~planes[b] if _C_BITS[b] else planes[b] for b in range(8)]
    ys = _run_program(x, _INV_TOP_OPS, _INV_TOP_OUT)
    z = _bp_middle(ys)
    return _run_program(z, _INV_BOT_OPS, _INV_BOT_OUT, _INV_BOT_CONST)


def _xtime_planes(p):
    """Bitsliced GF(2^8) doubling: y = x<<1 ^ 0x1b*(x>>7)."""
    return [p[7], p[0] ^ p[7], p[1], p[2] ^ p[7], p[3] ^ p[7],
            p[4], p[5], p[6]]


# ---------------------------------------------------------------------------
# Self-check of the derived circuit against the table S-box (once, import)
# ---------------------------------------------------------------------------

def _selfcheck():
    x = np.arange(256, dtype=np.uint8)
    planes = [((x >> b) & 1).astype(np.uint8) for b in range(8)]
    # emulate ~ on 0/1 numpy planes: operate in uint8, mask to bit 0 at end
    out = sbox_planes([p.astype(np.int32) for p in planes], True)
    got = np.zeros(256, dtype=np.int32)
    for b in range(8):
        got |= (out[b] & 1) << b
    assert np.array_equal(got.astype(np.uint8), SBOX), "tower S-box mismatch"
    out = sbox_planes([p.astype(np.int32) for p in planes], False)
    got = np.zeros(256, dtype=np.int32)
    for b in range(8):
        got |= (out[b] & 1) << b
    assert np.array_equal(got.astype(np.uint8), INV_SBOX), "tower inv-S mismatch"


_selfcheck()


# ---------------------------------------------------------------------------
# Pack / unpack and the full bitsliced cipher (jnp)
# ---------------------------------------------------------------------------

_SHIFTS8 = np.arange(8, dtype=np.uint8)


def pack_planes(blocks: jax.Array) -> jax.Array:
    """uint8[N,16] -> uint32[8,16,W] planes; N must be a multiple of 32.
    Plane [b,p,w] bit j = bit b of byte p of block 32w+j.

    Two-level pack (8 bits in uint8, then 4 bytes into uint32) keeps the
    intermediates at ~1x the data size instead of the naive 32x int32
    blowup — this path is HBM-bound, so traffic is everything."""
    n = blocks.shape[0]
    w = n // 32
    planes = []
    for b in range(8):
        bit = ((blocks >> b) & 1).reshape(w, 4, 8, 16)  # uint8
        by = jnp.sum(bit << _SHIFTS8[None, None, :, None], axis=2,
                     dtype=jnp.uint8)  # [w,4,16]: 8 blocks per byte
        word = (by[:, 0].astype(jnp.uint32)
                | (by[:, 1].astype(jnp.uint32) << 8)
                | (by[:, 2].astype(jnp.uint32) << 16)
                | (by[:, 3].astype(jnp.uint32) << 24))  # [w,16]
        planes.append(word.T)
    return jnp.stack(planes)  # [8,16,W]


def unpack_planes(planes: jax.Array, n: int) -> jax.Array:
    """uint32[8,16,W] -> uint8[N,16] (inverse two-level unpack)."""
    w = planes.shape[-1]
    p = planes.transpose(2, 0, 1)  # [W,8,16] u32
    by = jnp.stack([(p >> (8 * k)).astype(jnp.uint8) for k in range(4)],
                   axis=1)  # [W,4,8,16] u8: byte k holds blocks 8k..8k+7
    bits = (by[:, :, None, :, :] >> _SHIFTS8[None, None, :, None, None]) & 1
    # bits: [W, 4, 8(block-in-byte), 8(bitplane), 16]
    out = jnp.sum(bits << jax.lax.broadcasted_iota(jnp.uint8, (1, 1, 1, 8, 1), 3),
                  axis=3, dtype=jnp.uint8)  # [W,4,8,16]
    return out.reshape(w * 32, 16)[:n]


def _transpose32(rows: list) -> list:
    """32x32 bit-matrix transpose on 32 uint32 vectors (Hacker's-Delight
    butterfly, 5 stages of masked swaps) — vectorized over the trailing
    word axis.  out[i] bit j == in[j] bit i."""
    a = list(rows)
    j = 16
    m = np.uint32(0x0000FFFF)
    while j:
        k = 0
        while k < 32:
            # LSB-first variant: row k's HIGH bits pair with row k+j's LOW
            t = ((a[k] >> j) ^ a[k + j]) & m
            a[k] = a[k] ^ (t << j)
            a[k + j] = a[k + j] ^ t
            k = (k + j + 1) & ~j
        j >>= 1
        m = m ^ (m << np.uint32(j)) if j else m
    return a


def planes_to_words(planes: jax.Array) -> jax.Array:
    """uint32[8,16,W] planes -> uint32[4,N] little-endian block words
    (word k of block n = bytes 4k..4k+3), N minor — via 4 butterfly
    transposes instead of the 32x int expansion."""
    w = planes.shape[-1]
    out_rows = []
    for k in range(4):
        # bit r of word k of a block = byte (4k + r//8), bit (r%8)
        rows = [planes[r % 8, 4 * k + r // 8] for r in range(32)]
        tr = _transpose32(rows)  # tr[j] = word k of blocks (32w+j)
        out_rows.append(jnp.stack(tr, axis=1).reshape(32 * w))
    return jnp.stack(out_rows)  # [4, N]


def words_to_planes(words: jax.Array) -> jax.Array:
    """uint32[4,N] block words -> uint32[8,16,W] planes (inverse)."""
    n = words.shape[-1]
    w = n // 32
    planes = [[None] * 16 for _ in range(8)]
    for k in range(4):
        rows = [words[k].reshape(w, 32)[:, j] for j in range(32)]
        tr = _transpose32(rows)  # tr[r] = plane of bit r of word k
        for r in range(32):
            planes[r % 8][4 * k + r // 8] = tr[r]
    return jnp.stack([jnp.stack(p) for p in planes])


def blocks_to_words(blocks: jax.Array) -> jax.Array:
    """uint8[N,16] -> uint32[4,N] little-endian words (one transpose)."""
    x = blocks.T.astype(jnp.uint32)  # [16, N]
    return jnp.stack([
        x[4 * k] | (x[4 * k + 1] << 8) | (x[4 * k + 2] << 16)
        | (x[4 * k + 3] << 24)
        for k in range(4)
    ])


def words_to_blocks(words: jax.Array) -> jax.Array:
    """uint32[4,N] -> uint8[N,16]."""
    rows = []
    for k in range(4):
        for j in range(4):
            rows.append((words[k] >> (8 * j)).astype(jnp.uint8))
    return jnp.stack(rows).T  # [N, 16]


def key_planes(round_keys: np.ndarray) -> np.ndarray:
    """uint8[R+1,16] -> uint32[R+1,8,16] of 0/0xFFFFFFFF broadcast planes."""
    rk = np.asarray(round_keys, np.uint8)
    bits = (rk[:, :, None] >> np.arange(8)) & 1  # [R+1,16,8]
    return (bits.transpose(0, 2, 1).astype(np.uint32) * 0xFFFFFFFF)


def key_planes_batch(rks_stack: np.ndarray) -> np.ndarray:
    """uint8[B, R+1, 16] -> uint32[B, (R+1)*8*16, 1]: the per-key
    broadcast planes of `key_planes` for a whole key batch in one
    vectorized op (each row == key_planes(rks).reshape(-1, 1))."""
    rk = np.asarray(rks_stack, np.uint8)
    bits = (rk[:, :, :, None] >> np.arange(8)) & 1  # [B,R+1,16,8]
    planes = bits.transpose(0, 1, 3, 2).astype(np.uint32) * 0xFFFFFFFF
    return planes.reshape(rk.shape[0], -1, 1)


def key_planes_packed(rks_stack: np.ndarray) -> np.ndarray:
    """uint8[B, R+1, 16] per-message round keys -> uint32[R+1, 8, 16, W]
    lane-PACKED key plane words: bit j of [r, b, pos, w] = bit b of byte
    pos of round key r of message 32w+j.  The multikey form of
    key_planes, for engines whose 32 word lanes hold DIFFERENT messages'
    state (the batched chain scans); B must be a multiple of 32."""
    rks_stack = np.asarray(rks_stack, np.uint8)
    b = rks_stack.shape[0]
    assert b % 32 == 0
    bits = np.unpackbits(rks_stack[:, :, :, None], axis=-1,
                         bitorder="little")  # [B, R+1, 16, 8]
    lanes = bits.transpose(1, 3, 2, 0)  # [R+1, 8, 16, B]
    packed = np.packbits(lanes, axis=-1, bitorder="little")
    return np.ascontiguousarray(packed).view(np.uint32)


def encrypt_planes_multikey(kpw: jax.Array, planes: jax.Array) -> jax.Array:
    """Bitsliced encryption with PER-LANE keys: kpw uint32[R+1,8,16,W]
    from key_planes_packed, planes uint32[8,16,W]."""
    rounds = kpw.shape[0] - 1
    p = [planes[b] ^ kpw[0, b] for b in range(8)]
    for r in range(1, rounds + 1):
        p = sbox_planes(p, True)
        p = [x[SHIFT_PERM, :] for x in p]
        if r != rounds:
            p = _mix_columns_planes(p)
        p = [p[b] ^ kpw[r, b] for b in range(8)]
    return jnp.stack(p)


def _roll_rows(planes, k):
    """Rotate byte positions within each column: p=4c+r -> 4c+(r+k)%4.
    planes: [..., 16, W] indexed by byte position on axis -2."""
    perm = np.array([4 * (j // 4) + (j % 4 + k) % 4 for j in range(16)])
    return planes[..., perm, :]


def _mix_columns_planes(p):
    a1 = [_roll_rows(x, 1) for x in p]
    a2 = [_roll_rows(x, 2) for x in p]
    a3 = [_roll_rows(x, 3) for x in p]
    xt = _xtime_planes(p)
    xt1 = _xtime_planes(a1)
    return [xt[b] ^ xt1[b] ^ a1[b] ^ a2[b] ^ a3[b] for b in range(8)]


def _inv_mix_columns_planes(p):
    """InvMixColumns = MixColumns ∘ (column multiply by d(z) = {04}z² +
    {05}), since c(z)·d(z) = c⁻¹(z) mod z⁴+1 — 60 XOR vs 89 direct."""
    x4 = _xtime_planes(_xtime_planes(p))
    pre = [p[b] ^ x4[b] ^ _roll_rows(x4[b], 2) for b in range(8)]
    return _mix_columns_planes(pre)


def encrypt_planes(kp: jax.Array, planes: jax.Array) -> jax.Array:
    """Bitsliced encryption: kp uint32[R+1,8,16], planes uint32[8,16,W]."""
    rounds = kp.shape[0] - 1
    p = [planes[b] ^ kp[0, b][:, None] for b in range(8)]
    for r in range(1, rounds + 1):
        p = sbox_planes(p, True)
        p = [x[SHIFT_PERM, :] for x in p]
        if r != rounds:
            p = _mix_columns_planes(p)
        p = [p[b] ^ kp[r, b][:, None] for b in range(8)]
    return jnp.stack(p)


def decrypt_planes(kp: jax.Array, planes: jax.Array) -> jax.Array:
    rounds = kp.shape[0] - 1
    p = [planes[b] ^ kp[rounds, b][:, None] for b in range(8)]
    for r in range(rounds - 1, -1, -1):
        p = [x[INV_SHIFT_PERM, :] for x in p]
        p = sbox_planes(p, False)
        p = [x ^ kp[r, b][:, None] for b, x in enumerate(p)]
        if r != 0:
            p = _inv_mix_columns_planes(p)
    return jnp.stack(p)


def encrypt_blocks_bitsliced(kp: jax.Array, blocks: jax.Array) -> jax.Array:
    """Drop-in fast path for core.cipher.encrypt_blocks (N % 32 == 0)."""
    n = blocks.shape[0]
    return unpack_planes(encrypt_planes(kp, pack_planes(blocks)), n)


def decrypt_blocks_bitsliced(kp: jax.Array, blocks: jax.Array) -> jax.Array:
    n = blocks.shape[0]
    return unpack_planes(decrypt_planes(kp, pack_planes(blocks)), n)
