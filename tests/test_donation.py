"""Buffer donation — the device analogue of the reference's in-place
contract (micro_aes.h:520-526).

Two layers: the GPU keystream kernel aliases its stream operand onto the
output (input_output_aliases), and the bytes-API seal jit donates the
uploaded stream (donate_argnums).  The compiled-memory stats must show
the stream-sized alias, the donated input must be invalidated, and —
most importantly — results must be bit-identical to the per-message
oracle (XLA inserts copies wherever an aliased operand still has uses,
so correctness must never depend on call patterns)."""
import warnings

import numpy as np
import pytest


def test_seal_stream_jit_donates_and_aliases():
    import jax.numpy as jnp

    from micro_aes.modes.gcm import gcm_encrypt
    from micro_aes.modes.seal import (
        _gcm_seal_stream_jit,
        _trail_adjust_t,
        fused_trailing_pad,
        gcm_key_setup,
        gcm_seal,
        host_stream,
        seal_stream_words,
    )

    key, nonce = bytes(range(32)), bytes(range(12))
    pt = bytes(range(256)) * 16  # 4 KiB, whole blocks
    # oracle equality through the public bytes API (donating path)
    assert gcm_seal(key, nonce, pt) == gcm_encrypt(key, nonce, b"", pt)

    # compiled stats: the stream argument is aliased onto the output
    kp, tables = gcm_key_setup(key)
    n = len(pt) // 16
    w = seal_stream_words(n)
    adj = _trail_adjust_t(key, fused_trailing_pad(n))
    j0 = np.zeros(16, np.uint8)
    j0[:12], j0[15] = np.frombuffer(nonce, np.uint8), 1
    stream = jnp.asarray(host_stream(pt, 2, w))
    nbytes_stream = int(stream.size) * 4
    compiled = _gcm_seal_stream_jit.lower(
        kp, tables, adj, jnp.asarray(j0), stream, n).compile()
    stats = compiled.memory_analysis()
    assert stats.alias_size_in_bytes >= nbytes_stream, (
        f"stream not aliased: alias={stats.alias_size_in_bytes} "
        f"< stream={nbytes_stream}")

    # donated input is invalidated after the call (in-place semantics)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _ = _gcm_seal_stream_jit(kp, tables, adj, jnp.asarray(j0),
                                 stream, n)
    assert stream.is_deleted()


def test_kernel_aliasing_results_stable_across_reuse():
    """Calling the aliasing kernel wrapper twice with the SAME retained
    input must give identical results — XLA must copy-on-alias when the
    caller still holds the buffer (kernel through the interpreter)."""
    import jax.numpy as jnp

    from micro_aes.core.bitslice import key_planes
    from micro_aes.core.keyschedule import expand_key
    from micro_aes.ops.ctr_kernel import TILE, ctr_fused_kernel

    rng = np.random.default_rng(101)
    w = TILE
    kp = jnp.asarray(key_planes(expand_key(bytes(range(16))))).reshape(-1, 1)
    j0c = jnp.asarray(rng.integers(0, 2, (128, 1), dtype=np.uint32)
                      * np.uint32(0xFFFFFFFF))
    lohi = jnp.stack([jnp.arange(w, dtype=jnp.uint32) * 32,
                      jnp.zeros(w, jnp.uint32)])
    pt = jnp.asarray(rng.integers(0, 2**32, (w, 128), dtype=np.uint32))
    a = np.asarray(ctr_fused_kernel(kp, j0c, lohi, pt, interpret=True))
    b = np.asarray(ctr_fused_kernel(kp, j0c, lohi, pt, interpret=True))
    assert np.array_equal(a, b)
    assert not np.array_equal(a, np.asarray(pt))  # it actually ciphered
