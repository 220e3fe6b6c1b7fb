"""Benchmark: AES-256-GCM seal (encrypt + auth) bytes/sec on one GPU.

    python bench.py

Prints the card's name and power limit (nvidia-smi) on one line, then ONE
JSON line on stdout:
  {"metric": ..., "value": N, "unit": "bytes/s", "vs_baseline": N,
   "device": {...}, "card": "...", "xla_flags": "..."}

The value is the device-resident rate of the stream seal step (16 MiB per
call, median of the timed calls, each ended by block_until_ready);
compilation is warm-up, outside the timing.  vs_baseline compares against
the reference µAES C library compiled with gcc -O2 (AES-256-GCM on a host
CPU: 4.76 MB/s, BENCHREF.json).  Without a GPU the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REFERENCE_C_BYTES_PER_SEC = 4.76e6  # gcc -O2 micro_aes.c, AES-256-GCM, host CPU
N_BLOCKS = 1 << 20                  # 16 MiB per seal call
TIMED_CALLS = 9


def main() -> int:
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from micro_aes.utils.compile_cache import use_checkout_compile_cache

    use_checkout_compile_cache()
    import jax
    import jax.numpy as jnp

    from micro_aes.modes.seal import (
        _gcm_seal_stream_jit,
        _trail_adjust_t,
        fused_trailing_pad,
        gcm_key_setup,
        gcm_seal,
        seal_stream_words,
    )
    from micro_aes.modes.gcm import gcm_encrypt
    from micro_aes.utils.bytesio import BLOCK

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX reports {dev.platform}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()
    print(f"card: {card}", flush=True)

    key = bytes(range(32))
    nonce = bytes(range(12))
    small = np.random.default_rng(0).bytes(1024 * BLOCK)
    assert gcm_seal(key, nonce, small) == \
        gcm_encrypt(key, nonce, b"", small), \
        "bulk seal diverged from the per-message GCM path"

    kp, tables = gcm_key_setup(key)
    j0 = np.zeros(BLOCK, np.uint8)
    j0[:12] = np.frombuffer(nonce, np.uint8)
    j0[15] = 1
    w = seal_stream_words(N_BLOCKS)
    adj = _trail_adjust_t(key, fused_trailing_pad(N_BLOCKS))
    host = np.random.default_rng(1).integers(0, 2**32, (w, 128),
                                             dtype=np.uint32)

    def call():
        # the step donates its stream argument, so each call uploads anew
        stream = jnp.asarray(host)
        stream.block_until_ready()
        t = time.perf_counter()
        jax.block_until_ready(_gcm_seal_stream_jit(
            kp, tables, adj, jnp.asarray(j0), stream, N_BLOCKS))
        return time.perf_counter() - t

    call()  # compile + warm-up
    secs = statistics.median(call() for _ in range(TIMED_CALLS))
    value = N_BLOCKS * BLOCK / secs
    print(json.dumps({
        "metric": "AES-256-GCM seal (enc+auth) bytes/sec/GPU, device-resident",
        "value": round(value),
        "unit": "bytes/s",
        "vs_baseline": round(value / REFERENCE_C_BYTES_PER_SEC, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
