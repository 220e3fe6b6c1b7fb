"""The GPU keystream kernel (ops/ctr_kernel) through the Pallas
interpreter on the CPU, against the XLA engine (stream.ctr_fused_jnp) and
the independent C++ oracle; its wrapper's padding and the platform
choice; and, under the `gpu` marker, the kernel as compiled for the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from micro_aes import native
from micro_aes.core.bitslice import key_planes
from micro_aes.core.keyschedule import expand_key
from micro_aes.modes.seal import ctr_lohi, ctr_stream_xor, j0_bit_planes
from micro_aes.ops import ctr_kernel
from micro_aes.ops.stream import ctr_fused_jnp


def _ctr0(carry: bool, rng) -> np.ndarray:
    """A counter block whose low word is 1 mod 32 (the engines' 32-aligned
    generation).  carry=True puts the 56-bit window (bytes 9..15) 31
    blocks below its wrap, so the stream crosses the 32-bit boundary and
    the window's own wrap to zero (the carry stops at byte 9,
    micro_aes.c:421-428)."""
    c = rng.integers(0, 256, 16, dtype=np.uint8)
    c[12:] = (0xFF, 0xFF, 0xFF, 0xE1) if carry else (0, 0, 0, 1)
    if carry:
        c[9:12] = 0xFF
    return c


def _oracle_keystream_xor(key: bytes, ctr0: np.ndarray, stream: np.ndarray):
    """Stream position q holds counter ctr0 + q - 1 on the 56-bit BE
    window: ECB of every counter block through the C++ oracle, xored onto
    the stream on the host."""
    nblk = stream.shape[0] * 32
    base = int.from_bytes(ctr0[9:].tobytes(), "big")
    vals = (base + np.arange(nblk, dtype=object) - 1) % (1 << 56)
    ctrs = np.tile(ctr0, (nblk, 1))
    ctrs[:, 9:] = np.array([list(int(v).to_bytes(7, "big")) for v in vals],
                           np.uint8)
    ks = native.oracle_encrypt(key, ctrs).reshape(-1).view(np.uint32)
    return stream ^ ks.reshape(stream.shape)


def _inputs(klen: int, w: int, carry: bool, seed: int):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
    kp = jnp.asarray(key_planes(expand_key(key))).reshape(-1, 1)
    ctr0 = _ctr0(carry, rng)
    x = rng.integers(0, 2**32, (w, 128), dtype=np.uint32)
    return key, kp, ctr0, x


@pytest.mark.parametrize("carry", [False, True], ids=["plain", "carry"])
@pytest.mark.parametrize("w", [ctr_kernel.TILE, 40],
                         ids=["aligned", "ragged"])
@pytest.mark.parametrize("klen", [16, 24, 32])
def test_kernel_interpret_matches_xla_and_oracle(klen, w, carry):
    key, kp, ctr0, x = _inputs(klen, w, carry, seed=klen + w)
    j0c = j0_bit_planes(jnp.asarray(ctr0))
    lohi = ctr_lohi(jnp.asarray(ctr0), w)
    got = np.asarray(ctr_kernel.ctr_fused_kernel(
        kp, j0c, lohi, jnp.asarray(x), interpret=True))
    assert got.shape == (w, 128)
    want = np.asarray(ctr_fused_jnp(kp, j0c, lohi, jnp.asarray(x)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, _oracle_keystream_xor(key, ctr0, x))


def test_ctr_lohi_carry_contract():
    """Row counters of the 56-bit window: the low word wraps into the
    24-bit extension, the extension wraps to zero, and a traced negative
    start borrows from it."""
    ctr0 = np.zeros(16, np.uint8)
    ctr0[9:] = (0x12, 0x34, 0x56, 0xFF, 0xFF, 0xFF, 0xE1)
    lo, hi = np.asarray(ctr_lohi(jnp.asarray(ctr0), 3))
    assert list(lo) == [0xFFFFFFE0, 0, 32]
    assert list(hi) == [0x123456, 0x123457, 0x123457]
    ctr0[9:] = (0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xE1)
    lo, hi = np.asarray(ctr_lohi(jnp.asarray(ctr0), 2))
    assert list(hi) == [0xFFFFFF, 0]
    ctr0[9:] = (0, 0, 1, 0, 0, 0, 0)
    lo, hi = np.asarray(jax.jit(ctr_lohi, static_argnums=1)(
        jnp.asarray(ctr0), 1, jnp.int32(-32)))
    assert (lo[0], hi[0]) == (0xFFFFFFE0, 0)


def test_platform_choice_and_alignment(monkeypatch):
    """Off the GPU the keystream runs on the XLA engine and the stream
    aligns to 8 rows; kernel=True names the kernel explicitly."""
    assert jax.default_backend() != "gpu"
    assert not ctr_kernel.use_kernel()
    assert ctr_kernel.seal_word_align() == 8
    called = []

    def spy(*args, **kw):
        called.append(True)
        return ctr_fused_jnp(*args)

    monkeypatch.setattr(ctr_kernel, "ctr_fused_kernel", spy)
    key, kp, ctr0, x = _inputs(16, 8, False, seed=5)
    plain = np.asarray(ctr_stream_xor(kp, jnp.asarray(ctr0),
                                      jnp.asarray(x)))
    assert not called
    assert np.array_equal(plain, _oracle_keystream_xor(key, ctr0, x))
    forced = np.asarray(ctr_stream_xor(kp, jnp.asarray(ctr0),
                                       jnp.asarray(x), kernel=True))
    assert called and np.array_equal(forced, plain)


def test_kernel_refuses_to_compile_off_gpu():
    """Outside the interpreter the kernel exists only for the GPU: on the
    CPU the Pallas call refuses rather than silently interpreting."""
    _, kp, ctr0, x = _inputs(16, 8, False, seed=6)
    with pytest.raises(Exception, match="interpret"):
        ctr_kernel.ctr_fused_kernel(
            kp, j0_bit_planes(jnp.asarray(ctr0)),
            ctr_lohi(jnp.asarray(ctr0), 8), jnp.asarray(x))


@pytest.mark.gpu
@pytest.mark.parametrize("klen", [16, 32])
def test_kernel_on_gpu_matches_xla_and_oracle(gpu_device, klen):
    key, kp, ctr0, x = _inputs(klen, 4 * ctr_kernel.TILE + 8, True, seed=9)
    j0c = j0_bit_planes(jnp.asarray(ctr0))
    lohi = ctr_lohi(jnp.asarray(ctr0), x.shape[0])
    got = np.asarray(ctr_kernel.ctr_fused_kernel(kp, j0c, lohi,
                                                 jnp.asarray(x)))
    assert np.array_equal(
        got, np.asarray(ctr_fused_jnp(kp, j0c, lohi, jnp.asarray(x))))
    assert np.array_equal(got, _oracle_keystream_xor(key, ctr0, x))


@pytest.mark.gpu
def test_gcm_seal_on_gpu_matches_host_gcm(gpu_device):
    from micro_aes.modes.gcm import gcm_encrypt
    from micro_aes.modes.seal import gcm_open, gcm_seal

    assert ctr_kernel.use_kernel()
    rng = np.random.default_rng(10)
    key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    nonce = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
    pt = rng.integers(0, 256, 16 * 5000, dtype=np.uint8).tobytes()
    blob = gcm_seal(key, nonce, pt, aad=b"hdr")
    assert blob == gcm_encrypt(key, nonce, b"hdr", pt)
    assert gcm_open(key, nonce, blob, aad=b"hdr") == pt

