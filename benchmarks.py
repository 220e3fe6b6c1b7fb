"""Per-mode benchmark matrix + mesh scaling harness.

    python benchmarks.py                # one JSON line per mode
    python benchmarks.py --mesh         # sharded GCM scaling over sp
    python benchmarks.py --modes gcm-seal ctr

bench.py is the single-line headline bench; this is the full matrix.
Rates are marginal: the slope between two on-device repetition counts.
Every row names the device it ran on; without a GPU the script exits
non-zero.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


# A slope above this is a degenerate measurement (t_hi ~ t_lo timing
# noise), not a rate: it exceeds the card's memory bandwidth.
_SANE_BYTES_PER_S = 2e12


def _marginal_rate(make_loop, x0, nbytes_per_iter, r1=8, r2=40):
    """Slope between two on-device repetition counts (cancels the fixed
    per-dispatch cost), with a physical-sanity retry: noisy sessions
    can yield t_hi <= t_lo, whose "slope" is
    absurd — retry the measurement, then fall back to the whole-call
    rate at r2 (conservative: includes the dispatch latency) rather
    than ever emitting a nonsense row."""
    import jax

    def measure():
        res = {}
        for r in (r1, r2):
            loop = make_loop(r)
            jax.tree_util.tree_map(lambda v: v.block_until_ready(),
                                   loop(x0))
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                jax.tree_util.tree_map(lambda v: v.block_until_ready(),
                                       loop(x0))
                ts.append(time.perf_counter() - t0)
            res[r] = sorted(ts)[1]
        slope = (res[r2] - res[r1]) / (r2 - r1)
        return nbytes_per_iter / max(slope, 1e-9), res

    for _ in range(3):
        rate, res = measure()
        if rate <= _SANE_BYTES_PER_S:
            return rate
    return nbytes_per_iter * r2 / res[r2]  # whole-call fallback


_ROWS: list[dict] = []


def _emit(mode, value, unit="bytes/s", **extra):
    row = {"mode": mode, "value": round(value), "unit": unit, **extra}
    _ROWS.append(row)
    print(json.dumps(row))


def bench_modes(selected):
    import jax
    import jax.numpy as jnp

    from micro_aes.modes.ocb import _offset0, _subkeys
    from micro_aes.modes.ocb_bulk import _lane_words, _ocb_key_setup
    from micro_aes.modes.seal import (
        _trail_adjust_t,
        ctr_bulk_stream,
        fused_trailing_pad,
        gcm_key_setup,
        gcm_seal_stream_fused,
        seal_stream_words,
    )
    from micro_aes.ops.ctr_kernel import seal_word_align
    from micro_aes.ops.stream import ocb_fused_jnp
    from micro_aes.ops.poly_bulk import poly_fold_jnp, poly_power_tables

    key = bytes(range(32))
    key16 = bytes(range(16))
    kp, tables = gcm_key_setup(key)
    n_blocks = 1 << 20  # 16 MiB
    nbytes = n_blocks * 16
    j0 = np.zeros(16, np.uint8)
    j0[:12] = np.arange(12, dtype=np.uint8)
    j0[15] = 1

    w = seal_stream_words(n_blocks)
    adj = _trail_adjust_t(key, fused_trailing_pad(n_blocks))
    ptw0 = jnp.zeros((w, 128), jnp.uint32)

    def loop_of(step):
        # optimization_barrier between iterations: consecutive steps
        # otherwise cancel algebraically across the loop (e.g. the seal
        # wrapper's boundary transposes compose to identity between
        # iterations), which would measure kernel-only rates instead of
        # the per-call cost a real caller pays
        def make(reps):
            @jax.jit
            def loop(x):
                return jax.lax.fori_loop(
                    0, reps,
                    lambda _, c: jax.lax.optimization_barrier(step(c)), x)
            return loop
        return make

    if "gcm-seal" in selected:
        def step(c):
            # xor the tag into row 0 so the whole GHASH side stays live
            ctw, tag = gcm_seal_stream_fused(kp, tables, adj,
                                             jnp.asarray(j0), c, n_blocks)
            tagw = jax.lax.bitcast_convert_type(tag.reshape(4, 4),
                                                jnp.uint32)
            return ctw.at[0].set(ctw[0] ^ jnp.tile(tagw.reshape(-1),
                                                   ctw.shape[1] // 4))
        _emit("AES-256-GCM seal (tag-live)",
              _marginal_rate(loop_of(step), ptw0, nbytes))

    if "gcm-open" in selected:
        def step(c):
            ptw, tag = gcm_seal_stream_fused(kp, tables, adj,
                                             jnp.asarray(j0), c, n_blocks,
                                             open_direction=True)
            tagw = jax.lax.bitcast_convert_type(tag.reshape(4, 4),
                                                jnp.uint32)
            return ptw.at[0].set(ptw[0] ^ jnp.tile(tagw.reshape(-1),
                                                   ptw.shape[1] // 4))
        _emit("AES-256-GCM open (tag-live)",
              _marginal_rate(loop_of(step), ptw0, nbytes))

    if "ctr" in selected:
        ctr0 = np.zeros(16, np.uint8)
        ctr0[:12] = np.arange(12, dtype=np.uint8)
        ctr0[15] = 1
        wc = -(-(n_blocks + 1) // 32)
        wc += (-wc) % seal_word_align()
        ptc = jnp.zeros((wc, 128), jnp.uint32)

        def step(c):
            return ctr_bulk_stream(kp, jnp.asarray(ctr0), c)
        _emit("AES-256-CTR", _marginal_rate(loop_of(step), ptc, nbytes))

    if "ocb-seal" in selected or "ocb-open" in selected:
        l_star, l_dollar, ls = _subkeys(key16)
        d0 = _offset0(key16, np.arange(12, dtype=np.uint8), 16)
        wo = -(-n_blocks // 32)
        wo += (-wo) % 8
        nbits = (32 * wo).bit_length()
        d0l = jnp.asarray(_lane_words(d0)[None, :])
        lbl = jnp.asarray(np.stack([_lane_words(ls[b]) for b in range(nbits)]))
        kpo = _ocb_key_setup(key16)
        pto = jnp.zeros((wo, 128), jnp.uint32)
        if "ocb-seal" in selected:
            def step(c):
                return ocb_fused_jnp(kpo, d0l, lbl, c, nbits)
            _emit("AES-128-OCB seal body",
                  _marginal_rate(loop_of(step), pto, nbytes))
        if "ocb-open" in selected:
            def step(c):
                return ocb_fused_jnp(kpo, d0l, lbl, c, nbits, decrypt=True)
            _emit("AES-128-OCB open body",
                  _marginal_rate(loop_of(step), pto, nbytes))

    if "xts" in selected:
        from micro_aes.core.bitslice import key_planes
        from micro_aes.core.keyschedule import expand_key
        from micro_aes.modes.xts_bulk import (
            _row_base_powers_t,
            xts_sectors_stream_kernel,
        )

        kp1 = jnp.asarray(key_planes(expand_key(key16)))
        kp2 = jnp.asarray(key_planes(expand_key(bytes(range(16, 32)))))
        jsec = 256  # 4 KiB sectors
        s = n_blocks // jsec
        pows = _row_base_powers_t(jsec // 32)
        tweaks = jnp.asarray(np.arange(s, dtype=np.uint32)[:, None]
                             .view(np.uint8).reshape(s, 4).repeat(4, 1))
        data0 = jnp.zeros((n_blocks // 32, 128), jnp.uint32)

        def step(c):
            return xts_sectors_stream_kernel(kp1, kp2, pows, tweaks, c)
        _emit("AES-128-XTS sectors (4 KiB)",
              _marginal_rate(loop_of(step), data0, nbytes))

    if "poly1305" in selected:
        r = 0x0ffffffc0ffffffc0ffffffc0fffffff & int.from_bytes(
            bytes(range(16)), "little")
        ptables = poly_power_tables(r, n_blocks)
        words0 = jnp.zeros((4, n_blocks), jnp.uint32)
        pm = jnp.ones(n_blocks, jnp.int32)

        def step(c):
            out = poly_fold_jnp(ptables, c, pm)
            return c + out[0].astype(jnp.uint32)
        _emit("Poly1305 fold", _marginal_rate(loop_of(step), words0, nbytes))

    if "fpe" in selected:
        from micro_aes.fpe.device import fpe_encrypt_batch

        rng = np.random.default_rng(3)
        ntok = 10_000
        toks = ["".join("0123456789"[d] for d in rng.integers(0, 10, 16))
                for _ in range(ntok)]
        run = lambda ts_: fpe_encrypt_batch(key16, b"\x01\x02", ts_,
                                            "digits", "ff1")
        run(toks)  # compile + warm (same batch shape)
        ts = []
        for k in range(3):
            t0 = time.time()
            run(toks)
            ts.append(time.time() - t0)
        _emit("FF1 encrypt (10k tokens, digits len16)",
              ntok / sorted(ts)[1], unit="tokens/s")

        # the zero-string bulk path (packed digit matrices end-to-end;
        # radix 10 ships 2 digits/byte both directions)
        from micro_aes.fpe.device import fpe_encrypt_digits

        for method, tweak in (("ff1", b"\x01\x02"), ("ff3-1", bytes(7))):
            for nd in (10_000, 100_000, 500_000):
                dmat = rng.integers(0, 10, (nd, 16), dtype=np.uint8)
                fpe_encrypt_digits(key16, tweak, dmat, 10, method)
                ts = []
                for _ in range(9):  # end to end: 9-run median
                    t0 = time.perf_counter()
                    fpe_encrypt_digits(key16, tweak, dmat, 10, method)
                    ts.append(time.perf_counter() - t0)
                _emit(f"{method.upper()} encrypt digits-array "
                      f"({nd // 1000}k x len16)",
                      nd / sorted(ts)[4], unit="tokens/s")

        # DEVICE-RESIDENT Feistel rate (marginal, input pre-staged,
        # output left on device), beside the end-to-end rows above
        import micro_aes.fpe.device as _fdev

        nch, CH = 4, _fdev.FPE_CHUNK
        ndd = nch * CH
        rks1, kp1f = _fdev._rks(key16), _fdev._kp(key16)
        rkey = bytes(reversed(key16))
        rks3, kp3f = _fdev._rks(rkey), _fdev._kp(rkey)
        tw1 = jnp.asarray(np.frombuffer(b"\x01\x02", np.uint8))
        from micro_aes.fpe.ff3 import _split_tweak as _spt
        tl, tr = _spt(bytes(7))
        tl1 = jnp.asarray(np.frombuffer(tl, np.uint8))
        tr1 = jnp.asarray(np.frombuffer(tr, np.uint8))
        wire0 = jnp.zeros((ndd, 8), jnp.uint8)

        def ff1_step(x2):
            return _fdev._ff1_device_chunked(
                rks1, kp1f, tw1, x2, 10, 16, 2, True, True)

        def ff3_step(x2):
            return _fdev._ff3_device_chunked(
                rks3, kp3f, tl1, tr1, x2, 10, 16, True, True)

        for name, stepf in (("FF1", ff1_step), ("FF3-1", ff3_step)):
            _emit(f"{name} digits device-resident ({ndd // 1000}k x len16)",
                  _marginal_rate(loop_of(stepf), wire0, ndd, r1=2, r2=10),
                  unit="tokens/s")

    if "ccm-batch" in selected or "eax-batch" in selected:
        # END-TO-END wall time of the device-resident batch engines
        # (host glue + one upload + folds + keystream + one download);
        # not a marginal rate.
        from micro_aes.modes import bulk as _bulk

        rng = np.random.default_rng(17)
        bq = 2048
        bkeys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
                 for _ in range(bq)]
        bpts = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
                for _ in range(bq)]
        if "ccm-batch" in selected:
            bnon = [rng.integers(0, 256, 11, dtype=np.uint8).tobytes()
                    for _ in range(bq)]
            _bulk.ccm_encrypt_batch(bkeys, bnon, [b"hdr"] * bq, bpts)
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                _bulk.ccm_encrypt_batch(bkeys, bnon, [b"hdr"] * bq, bpts)
                ts.append(time.perf_counter() - t0)
            _emit("AES-128-CCM batch seal, 2048 x 4 KiB (end-to-end)",
                  bq * 4096 / sorted(ts)[1])
        if "eax-batch" in selected:
            bnon = [rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
                    for _ in range(bq)]
            _bulk.eax_encrypt_batch(bkeys, bnon, [b"hdr"] * bq, bpts)
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                _bulk.eax_encrypt_batch(bkeys, bnon, [b"hdr"] * bq, bpts)
                ts.append(time.perf_counter() - t0)
            _emit("AES-128-EAX batch seal, 2048 x 4 KiB (end-to-end)",
                  bq * 4096 / sorted(ts)[1])

    if "cmac-batch" in selected:
        from micro_aes.modes.bulk import _eax_subkeys, stack_round_keys
        from micro_aes.ops.mac import cbcmac_fold_batch

        rngw = np.random.default_rng(29)
        bw, nbc = 4096, 256  # 4096 messages x 4 KiB
        wkeys = [rngw.integers(0, 256, 16, dtype=np.uint8).tobytes()
                 for _ in range(bw)]
        rkswj = jnp.asarray(stack_round_keys(wkeys))
        zeros16w = jnp.zeros((bw, 16), jnp.uint8)
        k1c, _k2c = _eax_subkeys(rkswj, bw)
        onehot_c = (jnp.arange(nbc)[None, :, None]
                    == nbc - 1).astype(jnp.uint8)
        lastxor = onehot_c * jnp.asarray(k1c)[:, None, :]
        nvc = jnp.full(bw, nbc, jnp.int32)

        def step(m):
            tag = cbcmac_fold_batch(rkswj, zeros16w, m ^ lastxor, nvc)
            return m ^ tag[:, None, :]
        _emit("AES-128-CMAC batch, 4096 x 4 KiB (device-resident)",
              _marginal_rate(loop_of(step),
                             jnp.zeros((bw, nbc, 16), jnp.uint8),
                             bw * nbc * 16))

    if "cipher" in selected:
        from micro_aes.core.bitslice import encrypt_planes

        wp = n_blocks // 32
        planes0 = jnp.zeros((8, 16, wp), jnp.uint32)

        def step(c):
            return encrypt_planes(kp, c)
        _emit("AES-256 cipher (bitsliced planes)",
              _marginal_rate(loop_of(step), planes0, 32 * wp * 16))


def bench_mesh():
    """Weak-scaling of the fused sharded GCM seal over sp, and of the
    dp-sharded XTS sectors over dp, on the GPUs JAX reports."""
    import jax
    import jax.numpy as jnp

    from micro_aes.modes.common import enc_blocks_np
    from micro_aes.modes.seal import gcm_key_setup
    from micro_aes.parallel.mesh import make_mesh
    from micro_aes.parallel.sharded import (
        gcm_sharded_fused_fn,
        shard_adjust_matrices_fused,
        sharded_aad_args,
    )

    ndev = len(jax.devices())
    key = bytes(range(16))
    kp, tables = gcm_key_setup(key, chunk=32, chunk2=2)
    blocks_per_shard = 2048
    base_rate = None
    for sp in (1, 2, 4, 8):
        if sp > ndev:
            break
        mesh = make_mesh(1, sp)
        n_blocks = sp * blocks_per_shard
        j0 = np.zeros((1, 16), np.uint8)
        j0[0, :12] = np.arange(12, dtype=np.uint8)
        j0[0, 15] = 1
        ek_j0 = enc_blocks_np(key, j0)
        adj = shard_adjust_matrices_fused(tables[3], blocks_per_shard, sp,
                                          chunk2=2)
        aad_acc, aad_shift_t, _ = sharded_aad_args(key, b"", n_blocks, 1)
        seal = gcm_sharded_fused_fn(mesh, n_blocks)
        pt0 = jnp.zeros((1, n_blocks, 16), jnp.uint8)

        def run(pt):
            ct, tag = seal(kp, tables, adj, jnp.asarray(j0),
                           jnp.asarray(ek_j0), pt, aad_acc, aad_shift_t)
            return tag
        run(pt0).block_until_ready()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(pt0).block_until_ready()
            ts.append(time.perf_counter() - t0)
        dt = sorted(ts)[1]
        rate = n_blocks / dt
        per_chip = rate / sp
        if base_rate is None:
            base_rate = per_chip
        _emit("sharded GCM seal (weak scaling)", rate,
              unit="blocks/s", sp=sp,
              blocks_per_s_per_chip=round(per_chip),
              efficiency_vs_sp1=round(per_chip / base_rate, 3),
              backend=jax.default_backend())

    # second mesh engine: dp-sharded disk-sector XTS
    from micro_aes.core.bitslice import key_planes
    from micro_aes.core.keyschedule import expand_key
    from micro_aes.parallel.batch import xts_sectors_sharded_fn

    kp1 = jnp.asarray(key_planes(expand_key(bytes(range(16)))))
    kp2 = jnp.asarray(key_planes(expand_key(bytes(range(16, 32)))))
    sectors_per_shard, r = 256, 8           # 256 x 4 KiB per device
    base_rate = None
    for dp in (1, 2, 4, 8):
        if dp > ndev:
            break
        mesh = make_mesh(dp, 1)
        s = dp * sectors_per_shard
        tweaks = np.zeros((s, 16), np.uint8)
        tweaks[:, :4] = np.arange(s, dtype=np.uint32)[:, None].view(
            np.uint8).reshape(s, 4)
        seal = xts_sectors_sharded_fn(mesh, r_per_sector=r)
        pt0 = jnp.zeros((s * r, 128), jnp.uint32)
        twj = jnp.asarray(tweaks)
        seal(kp1, kp2, twj, pt0).block_until_ready()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            seal(kp1, kp2, twj, pt0).block_until_ready()
            ts.append(time.perf_counter() - t0)
        dt = sorted(ts)[1]
        nbytes = s * r * 128 * 4
        rate = nbytes / dt
        per_chip = rate / dp
        if base_rate is None:
            base_rate = per_chip
        _emit("dp-sharded XTS sectors (weak scaling)", rate,
              unit="bytes/s", dp=dp,
              gb_per_s_per_chip=round(per_chip / 1e9, 3),
              efficiency_vs_dp1=round(per_chip / base_rate, 3),
              backend=jax.default_backend())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mesh", action="store_true",
                        help="run the sharded scaling harness instead")
    parser.add_argument("--trace", metavar="DIR", default=None,
                        help="capture a jax.profiler device trace of the "
                             "benched engines into DIR")
    parser.add_argument("--out", metavar="FILE", default=None,
                        help="also write the rows as a JSON artifact with "
                             "the device and a timestamp")
    parser.add_argument("--modes", nargs="*",
                        default=["gcm-seal", "gcm-open", "ctr", "ocb-seal",
                                 "ocb-open", "xts", "poly1305", "fpe",
                                 "ccm-batch", "eax-batch", "cmac-batch",
                                 "cipher"])
    args = parser.parse_args(argv)

    import os
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from micro_aes.utils.compile_cache import use_checkout_compile_cache

    use_checkout_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX reports {dev.platform}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()
    print(json.dumps({"card": card, "device_kind": dev.device_kind,
                      "devices": len(jax.devices()),
                      "xla_flags": os.environ.get("XLA_FLAGS", "")}))
    run = bench_mesh if args.mesh else (lambda: bench_modes(set(args.modes)))
    if args.trace:
        with jax.profiler.trace(args.trace):
            run()
        print(json.dumps({"trace": args.trace}))
    else:
        run()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"ts": round(time.time()), "card": card,
                       "device": {"platform": dev.platform,
                                  "kind": dev.device_kind,
                                  "count": len(jax.devices())},
                       "rows": _ROWS}, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
