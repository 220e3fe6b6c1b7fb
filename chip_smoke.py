#!/usr/bin/env python3
"""Smoke run of micro_aes's main path on NVIDIA GPUs.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded paths only

One card, in one process, each phase fatal on failure:

  1. device check: JAX must report a GPU; the card's name and power
     limit come from nvidia-smi; the C++ host oracle must be built;
  2. known answers: examples/demo.py's sweep over every mode;
  3. one small call of each batch engine against the per-message path;
  4. single-key bulk object: AES-256 gcm_seal/gcm_open of a 64 MiB
     object with 37 B of AAD and ctr_bulk of the same 64 MiB, the
     ciphertext checked at full width against the C++ oracle (ECB of the
     counter blocks, xored on the host) and a 64 KiB prefix against the
     per-message modes.gcm path;
  5. multi-key TLS-record batch: gcm_seal_batch/gcm_open_batch over
     1,024 AES-256 keys x 16 KiB records, every record against the C++
     oracle, a sample against modes.gcm, one tampered record -> None;
  6. the GPU keystream kernel against XLA's compilation of the plain
     engine, end to end through gcm_seal at 64 MiB and per call on the
     device, in turns, with compile times and memory analysis.

--four runs only what exists across cards: the sp-sharded GCM seal/open
of the 64 MiB object over a (dp=1, sp=4) mesh and the dp-sharded
multi-key batch over (4, 1), each compared with the one-card result.

The last line of standard output is one JSON object, {"ok": true,
"device": {"platform", "kind", "count"}}; without a GPU, or without the
package beside it, the script prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BULK_BYTES = 64 << 20          # one large object
AAD_BYTES = 37
BATCH_KEYS = 1024              # TLS sessions, one record each
RECORD_BYTES = 16 << 10        # a full TLS 1.3 record (RFC 8446 §5.1)
TIMING_TURNS = 4               # per variant, alternating
SEED = 2024


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints a phase's start and wall time; an exception fails the run."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: ok ({time.perf_counter() - self.t0:.1f} s)")
        return False


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"   ok: {what}")


def card_line() -> str:
    """The cards' name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def require_gpus(count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX reports {devs[0].platform}")
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, JAX reports {len(devs)}")
    return devs


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------


def oracle_ctr_xor(key: bytes, ctr0: np.ndarray, data: bytes) -> bytes:
    """data xor ECB(counter blocks ctr0, ctr0+1, ...) on the reference's
    56-bit big-endian counter window (bytes 9..15), through the
    independent C++ oracle."""
    from micro_aes import native

    n = len(data) // 16
    base = int.from_bytes(bytes(ctr0[9:]), "big")
    vals = ((np.uint64(base) + np.arange(n, dtype=np.uint64))
            & np.uint64((1 << 56) - 1))
    ctrs = np.empty((n, 16), np.uint8)
    ctrs[:, :9] = ctr0[:9]
    ctrs[:, 9:] = vals.astype(">u8").view(np.uint8).reshape(n, 8)[:, 1:]
    ks = native.oracle_encrypt(key, ctrs)
    return (np.frombuffer(data, np.uint8) ^ ks.reshape(-1)).tobytes()


def gcm_ctr1(nonce: bytes) -> np.ndarray:
    """First GCM keystream counter for a 12-byte nonce: nonce || 2."""
    c = np.zeros(16, np.uint8)
    c[:12] = np.frombuffer(nonce, np.uint8)
    c[15] = 2
    return c


def bulk_object(rng):
    return (rng.bytes(32), rng.bytes(12), rng.bytes(AAD_BYTES),
            rng.bytes(BULK_BYTES))


def record_batch(rng):
    keys = [rng.bytes(32) for _ in range(BATCH_KEYS)]
    nonces = [rng.bytes(12) for _ in range(BATCH_KEYS)]
    # TLS 1.3 record AAD: opaque_type || legacy_version || length
    aads = [bytes([23, 3, 3]) + (RECORD_BYTES + 17).to_bytes(2, "big")
            for _ in range(BATCH_KEYS)]
    pts = [rng.bytes(RECORD_BYTES) for _ in range(BATCH_KEYS)]
    return keys, nonces, aads, pts


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def phase_kat():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "demo", os.path.join(ROOT, "examples", "demo.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    check(demo.main() == 0, "every mode matches its known answer")


def phase_batch_engines(rng):
    from micro_aes.fpe import fpe_encrypt
    from micro_aes.fpe.device import (
        fpe_decrypt_batch,
        fpe_decrypt_digits,
        fpe_encrypt_batch,
        fpe_encrypt_digits,
    )
    from micro_aes.modes import bulk, chain_bulk
    from micro_aes.modes.cbc import cbc_encrypt
    from micro_aes.modes.ccm import ccm_encrypt
    from micro_aes.modes.ctr import ctr_encrypt
    from micro_aes.modes.eax import eax_encrypt
    from micro_aes.modes.gcm import gcm_encrypt
    from micro_aes.modes.gcm_siv import gcm_siv_encrypt
    from micro_aes.modes.ocb import ocb_encrypt
    from micro_aes.modes.ocb_bulk import ocb_open, ocb_seal
    from micro_aes.modes.ofb import ofb_encrypt
    from micro_aes.modes.seal import ctr_bulk, gcm_open, gcm_seal
    from micro_aes.modes.seal_batch import gcm_open_batch, gcm_seal_batch
    from micro_aes.modes.siv import siv_encrypt
    from micro_aes.modes.siv_seal import gcm_siv_open, gcm_siv_seal
    from micro_aes.modes.xts import xts_encrypt
    from micro_aes.modes.xts_bulk import xts_open_sectors, xts_seal_sectors

    key, key16 = rng.bytes(32), rng.bytes(16)
    nonce, aad = rng.bytes(12), rng.bytes(AAD_BYTES)
    pt = rng.bytes(4096 * 16)

    sealed = gcm_seal(key, nonce, pt, aad=aad)
    check(sealed == gcm_encrypt(key, nonce, aad, pt),
          "modes.seal.gcm_seal == per-message GCM (64 KiB)")
    check(gcm_open(key, nonce, sealed, aad=aad) == pt, "gcm_open round trip")
    check(ctr_bulk(key, nonce, pt) == ctr_encrypt(key, nonce + bytes(4), pt),
          "modes.seal.ctr_bulk == per-message CTR")

    oc = ocb_seal(key16, nonce, aad, pt)
    check(oc == ocb_encrypt(key16, nonce, aad, pt),
          "ocb_bulk.ocb_seal == per-message OCB")
    check(ocb_open(key16, nonce, aad, oc) == pt, "ocb_open round trip")

    sector, nsec = 4096, 16
    data = rng.bytes(sector * nsec)
    ids = list(range(100, 100 + nsec))
    xs = xts_seal_sectors(key, ids, data, sector_size=sector)
    check(xs == b"".join(
        xts_encrypt(key, sid.to_bytes(16, "little"),
                    data[i * sector:(i + 1) * sector])
        for i, sid in enumerate(ids)),
        "xts_bulk.xts_seal_sectors == per-sector XTS")
    check(xts_open_sectors(key, ids, xs, sector_size=sector) == data,
          "xts_open_sectors round trip")

    gs = gcm_siv_seal(key, nonce, pt)
    check(gs == gcm_siv_encrypt(key, nonce, b"", pt),
          "siv_seal.gcm_siv_seal == per-message GCM-SIV")
    check(gcm_siv_open(key, nonce, gs) == pt, "gcm_siv_open round trip")

    bkeys = [rng.bytes(16) for _ in range(8)]
    bnonces = [rng.bytes(12) for _ in range(8)]
    baads = [rng.bytes(i) for i in range(8)]
    bpts = [rng.bytes(16 * (1 + 37 * i)) for i in range(8)]
    bres = gcm_seal_batch(bkeys, bnonces, baads, bpts)
    check(all(bres[i] == gcm_encrypt(bkeys[i], bnonces[i], baads[i], bpts[i])
              for i in range(8)), "seal_batch.gcm_seal_batch == per-message")
    check(gcm_open_batch(bkeys, bnonces, baads, bres) == bpts,
          "gcm_open_batch round trip")
    gres = bulk.gcm_encrypt_batch(bkeys, bnonces, baads, bpts)
    check(gres == bres, "bulk.gcm_encrypt_batch == per-message")

    vkeys = [rng.bytes(32) for _ in range(8)]
    vres = bulk.siv_encrypt_batch(vkeys, baads, bpts)
    check(all(vres[i] == siv_encrypt(vkeys[i], baads[i], bpts[i])
              for i in range(8)), "bulk.siv_encrypt_batch == per-message")
    check(bulk.siv_decrypt_batch(vkeys, [iv for iv, _ in vres], baads,
                                 [ct for _, ct in vres]) == bpts,
          "bulk.siv_decrypt_batch round trip")
    cnonces = [n[:11] for n in bnonces]
    cres = bulk.ccm_encrypt_batch(bkeys, cnonces, baads, bpts)
    check(all(cres[i] == ccm_encrypt(bkeys[i], cnonces[i], baads[i], bpts[i])
              for i in range(8)), "bulk.ccm_encrypt_batch == per-message")
    eres = bulk.eax_encrypt_batch(bkeys, bnonces, baads, bpts)
    check(all(eres[i] == eax_encrypt(bkeys[i], bnonces[i], baads[i], bpts[i])
              for i in range(8)), "bulk.eax_encrypt_batch == per-message")

    ckeys = [rng.bytes(32) for _ in range(48)]
    civs = [rng.bytes(16) for _ in range(48)]
    cpts = [rng.bytes(16 * (2 + i)) for i in range(48)]
    got = chain_bulk.cbc_encrypt_batch(ckeys, civs, cpts)
    check(all(got[i] == cbc_encrypt(ckeys[i], civs[i], cpts[i])
              for i in range(48)),
          "chain_bulk.cbc_encrypt_batch == per-message")
    got = chain_bulk.ofb_xcrypt_batch(ckeys, civs, cpts)
    check(all(got[i] == ofb_encrypt(ckeys[i], civs[i], cpts[i])
              for i in range(48)),
          "chain_bulk.ofb_xcrypt_batch == per-message")

    toks = ["".join("0123456789"[d] for d in rng.integers(0, 10, 16))
            for _ in range(64)]
    enc = fpe_encrypt_batch(key16, b"\x01\x02", toks, "digits", "ff1")
    check(enc[:4] == [fpe_encrypt(key16, b"\x01\x02", t, "digits", "ff1")
                      for t in toks[:4]], "fpe device FF1 == host FF1")
    check(fpe_decrypt_batch(key16, b"\x01\x02", enc, "digits", "ff1")
          == toks, "fpe device FF1 round trip")
    dmat = rng.integers(0, 10, (64, 16), dtype=np.uint8)
    dct = fpe_encrypt_digits(key16, b"\x01\x02", dmat, 10, "ff1")
    check(["".join("0123456789"[v] for v in row) for row in dct]
          == fpe_encrypt_batch(key16, b"\x01\x02",
                               ["".join("0123456789"[v] for v in row)
                                for row in dmat], "digits", "ff1"),
          "fpe.device.fpe_encrypt_digits == string batch")
    check(np.array_equal(
        fpe_decrypt_digits(key16, b"\x01\x02", dct, 10, "ff1"), dmat),
        "fpe_decrypt_digits round trip")


def phase_bulk_object(rng):
    from micro_aes.errors import AuthenticationError
    from micro_aes.modes.gcm import gcm_encrypt
    from micro_aes.modes.seal import ctr_bulk, gcm_open, gcm_seal

    mib = BULK_BYTES >> 20
    key, nonce, aad, pt = bulk_object(rng)
    t = time.perf_counter()
    sealed = gcm_seal(key, nonce, pt, aad=aad)
    log(f"   gcm_seal {mib} MiB first call (compile included): "
        f"{time.perf_counter() - t:.3f} s")
    check(len(sealed) == BULK_BYTES + 16, "sealed length")
    check(sealed[:-16] == oracle_ctr_xor(key, gcm_ctr1(nonce), pt),
          f"{mib} MiB ciphertext == C++ oracle at full width")
    prefix = pt[: 64 << 10]
    check(gcm_seal(key, nonce, prefix, aad=aad)
          == gcm_encrypt(key, nonce, aad, prefix),
          "64 KiB prefix (ciphertext and tag) == modes.gcm.gcm_encrypt")
    t = time.perf_counter()
    check(gcm_open(key, nonce, sealed, aad=aad) == pt,
          f"gcm_open {mib} MiB round trip")
    log(f"   gcm_open {mib} MiB first call: {time.perf_counter() - t:.3f} s")
    bad = bytearray(sealed)
    bad[BULK_BYTES // 2] ^= 1
    try:
        gcm_open(key, nonce, bytes(bad), aad=aad)
        check(False, f"tampered {mib} MiB object rejected")
    except AuthenticationError:
        check(True, f"tampered {mib} MiB object rejected")
    ctr0 = np.zeros(16, np.uint8)
    ctr0[:12] = np.frombuffer(nonce, np.uint8)
    ctr0[15] = 1
    out = ctr_bulk(key, nonce, pt)
    check(out == oracle_ctr_xor(key, ctr0, pt),
          f"ctr_bulk {mib} MiB == C++ oracle at full width")
    check(ctr_bulk(key, nonce, out) == pt, f"ctr_bulk {mib} MiB round trip")


def seal_records(keys, nonces, aads, pts):
    from micro_aes.modes.seal_batch import gcm_seal_batch

    t = time.perf_counter()
    sealed = gcm_seal_batch(keys, nonces, aads, pts)
    log(f"   gcm_seal_batch {len(keys)} x {RECORD_BYTES} B first call: "
        f"{time.perf_counter() - t:.3f} s")
    return sealed


def phase_record_batch(rng):
    from micro_aes.modes.gcm import gcm_encrypt
    from micro_aes.modes.seal_batch import gcm_open_batch

    keys, nonces, aads, pts = record_batch(rng)
    sealed = seal_records(keys, nonces, aads, pts)
    check(all(len(s) == RECORD_BYTES + 16 for s in sealed), "record lengths")
    check(all(sealed[i][:-16] == oracle_ctr_xor(keys[i], gcm_ctr1(nonces[i]),
                                                pts[i])
              for i in range(BATCH_KEYS)),
          f"all {BATCH_KEYS} record ciphertexts == C++ oracle")
    sample = range(0, BATCH_KEYS, BATCH_KEYS // 16)
    check(all(sealed[i] == gcm_encrypt(keys[i], nonces[i], aads[i], pts[i])
              for i in sample),
          "16 sampled records (ciphertext and tag) == modes.gcm.gcm_encrypt")
    bad = list(sealed)
    victim = BATCH_KEYS * 3 // 4
    bad[victim] = bad[victim][:100] + bytes([bad[victim][100] ^ 1]) \
        + bad[victim][101:]
    t = time.perf_counter()
    opened = gcm_open_batch(keys, nonces, aads, bad)
    log(f"   gcm_open_batch first call: {time.perf_counter() - t:.3f} s")
    check(opened[victim] is None, "tampered record comes back None")
    check(all(opened[i] == pts[i] for i in range(BATCH_KEYS) if i != victim),
          "every other record opens to its plaintext")


def _median_s(samples):
    return statistics.median(samples)


def phase_kernel_vs_xla(rng, card: str):
    """gcm_seal of one object through each keystream engine: the public
    function's own steps (host stream, upload, the compiled step,
    download), timed in turns, beside the device step alone and the
    keystream pass alone."""
    import jax
    import jax.numpy as jnp

    from micro_aes.modes import seal
    from micro_aes.ops import ctr_kernel
    from micro_aes.ops.stream import ctr_fused_jnp

    mib = BULK_BYTES >> 20
    key, nonce, aad, pt = bulk_object(rng)
    n = BULK_BYTES // 16
    kp, tables = seal.gcm_key_setup(key)
    adj = seal._trail_adjust_t(key, seal.fused_trailing_pad(n))
    ab, alen, ashift = seal._aad_prep(key, aad, n)
    kw = dict(aad_blocks=ab, aad_shift_t=ashift)  # the traced keywords
    j0 = np.zeros(16, np.uint8)
    j0[:12] = np.frombuffer(nonce, np.uint8)
    j0[15] = 1
    w = seal.seal_stream_words(n)
    host = seal.host_stream(pt, 2, w)
    variants = {"kernel": True, "xla": False}
    log(f"[2a] kernel: {ctr_kernel.TILE} stream columns "
        f"({32 * ctr_kernel.TILE} blocks) per program, "
        f"{ctr_kernel.NUM_WARPS} warps")

    compiled = {}
    for name, k in variants.items():
        t = time.perf_counter()
        c = seal._gcm_seal_stream_jit.lower(
            kp, tables, adj, jnp.asarray(j0), jnp.asarray(host), n,
            aad_bytes=alen, kernel=k, **kw).compile()
        tc = time.perf_counter() - t
        ma = c.memory_analysis()
        log(f"[2a] compile (or cache load) of the {mib} MiB seal step, "
            f"{name}: {tc:.2f} s; temp {ma.temp_size_in_bytes} B, "
            f"arguments {ma.argument_size_in_bytes} B, outputs "
            f"{ma.output_size_in_bytes} B, aliased {ma.alias_size_in_bytes}"
            f" B; card {card}")
        compiled[name] = c

    def seal_bytes(name):
        ctw, tag = compiled[name](kp, tables, adj, jnp.asarray(j0),
                                  jnp.asarray(seal.host_stream(pt, 2, w)),
                                  **kw)
        return seal.host_unstream(np.asarray(ctw), 2, len(pt)) + \
            bytes(np.asarray(tag))

    public = seal.gcm_seal(key, nonce, pt, aad=aad)
    check(seal_bytes("kernel") == public and seal_bytes("xla") == public,
          "both engines give gcm_seal's bytes")

    order = ["kernel", "xla", "xla", "kernel"] * (TIMING_TURNS // 2)
    dev, e2e = {k: [] for k in variants}, {k: [] for k in variants}
    for name in order:
        stream = jnp.asarray(host)
        stream.block_until_ready()
        t = time.perf_counter()
        jax.block_until_ready(compiled[name](kp, tables, adj,
                                             jnp.asarray(j0), stream, **kw))
        dev[name].append(time.perf_counter() - t)
        t = time.perf_counter()
        seal_bytes(name)
        e2e[name].append(time.perf_counter() - t)
    for name in variants:
        log(f"[2a] gcm_seal {mib} MiB AES-256 {name}: end to end median "
            f"{_median_s(e2e[name]):.6f} s {e2e[name]}; device step "
            f"median {_median_s(dev[name]):.6f} s {dev[name]} "
            f"(n={len(dev[name])}, in turns); card {card}")

    # the keystream pass alone: kernel vs XLA's compilation of the plain
    # engine on the same device-resident stream
    lohi = seal.ctr_lohi(jnp.asarray(j0), w)
    j0c = seal.j0_bit_planes(jnp.asarray(j0))
    kpf = kp.reshape(-1, 1)
    x = jnp.asarray(host)
    fns = {"kernel": ctr_kernel.ctr_fused_kernel, "xla": ctr_fused_jnp}
    ks = {}
    for name, fn in fns.items():
        t = time.perf_counter()
        c = fn.lower(kpf, j0c, lohi, x).compile()
        tc = time.perf_counter() - t
        ma = c.memory_analysis()
        jax.block_until_ready(c(kpf, j0c, lohi, x))
        times = []
        for _ in range(2 * TIMING_TURNS):
            t = time.perf_counter()
            jax.block_until_ready(c(kpf, j0c, lohi, x))
            times.append(time.perf_counter() - t)
        ks[name] = np.asarray(c(kpf, j0c, lohi, x))
        log(f"[2a] keystream pass {mib} MiB AES-256 {name}: median "
            f"{_median_s(times):.6f} s, min {min(times):.6f} s "
            f"(n={len(times)}); compile (or cache load) {tc:.2f} s; temp "
            f"{ma.temp_size_in_bytes} B; card {card}")
    check(np.array_equal(ks["kernel"], ks["xla"]),
          "keystream passes agree bit for bit")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def _on_distinct_devices(arr, count: int) -> bool:
    devs = {s.device for s in arr.addressable_shards}
    return len(devs) == count


def _memory_per_device(devs) -> str:
    return ", ".join(
        f"{d.id}: {(d.memory_stats() or {}).get('peak_bytes_in_use')} B peak"
        for d in devs)


def phase_four_bulk(devs, rng):
    import jax.numpy as jnp

    from micro_aes.modes.common import enc_blocks_np
    from micro_aes.modes.seal import gcm_key_setup, gcm_seal
    from micro_aes.parallel.mesh import make_mesh
    from micro_aes.parallel.sharded import (
        gcm_sharded_fused_fn,
        shard_adjust_matrices_fused,
        sharded_aad_args,
    )

    key, nonce, aad, pt = bulk_object(rng)
    n = BULK_BYTES // 16
    one_card = gcm_seal(key, nonce, pt, aad=aad)
    mesh = make_mesh(1, 4, devs)
    kp, tables = gcm_key_setup(key)
    j0 = np.zeros((1, 16), np.uint8)
    j0[0, :12] = np.frombuffer(nonce, np.uint8)
    j0[0, 15] = 1
    ek_j0 = enc_blocks_np(key, j0)
    adj = shard_adjust_matrices_fused(tables[3], n // 4, 4)
    aad_acc, aad_shift_t, alen = sharded_aad_args(key, aad, n, 1)
    blocks = jnp.asarray(np.frombuffer(pt, np.uint8).reshape(1, n, 16))

    t = time.perf_counter()
    seal4 = gcm_sharded_fused_fn(mesh, n, aad_bytes=alen)
    ct, tag = seal4(kp, tables, adj, jnp.asarray(j0), jnp.asarray(ek_j0),
                    blocks, aad_acc, aad_shift_t)
    ct.block_until_ready()
    log(f"   sharded seal first call (compile included): "
        f"{time.perf_counter() - t:.3f} s")
    check(_on_distinct_devices(ct, 4),
          f"ciphertext shards on 4 cards ({ct.sharding})")
    log(f"   device memory: {_memory_per_device(devs)}")
    got = bytes(np.asarray(ct).reshape(-1)) + bytes(np.asarray(tag)[0])
    check(got == one_card,
          f"sp=4 sharded seal == one-card gcm_seal ({BULK_BYTES >> 20} MiB)")
    open4 = gcm_sharded_fused_fn(mesh, n, aad_bytes=alen, open_direction=True)
    pt2, tag2 = open4(kp, tables, adj, jnp.asarray(j0), jnp.asarray(ek_j0),
                      ct, aad_acc, aad_shift_t)
    check(bytes(np.asarray(tag2)[0]) == one_card[-16:],
          "sp=4 sharded open recomputes the tag")
    check(bytes(np.asarray(pt2).reshape(-1)) == pt,
          "sp=4 sharded open recovers the plaintext")


def phase_four_batch(devs, rng):
    from micro_aes.modes.seal_batch import _prep, gcm_seal_batch
    from micro_aes.parallel.batch import seal_batch_sharded_fn
    from micro_aes.parallel.mesh import make_mesh

    keys, nonces, aads, pts = record_batch(rng)
    one_card = gcm_seal_batch(keys, nonces, aads, pts)
    (b, wm, _, ns, front_np, kp_stack, j0w, front, mask, sel, len_bits,
     ptw) = _prep(keys, nonces, aads, pts)
    t = time.perf_counter()
    fn = seal_batch_sharded_fn(make_mesh(4, 1, devs), b, wm)
    out, tags = fn(kp_stack, j0w, front, mask, sel, len_bits, ptw)
    out.block_until_ready()
    log(f"   dp-sharded batch first call (compile included): "
        f"{time.perf_counter() - t:.3f} s")
    check(_on_distinct_devices(out, 4),
          f"batch output shards on 4 cards ({out.sharding})")
    log(f"   device memory: {_memory_per_device(devs)}")
    out_np = np.asarray(out).reshape(b, -1)
    tags_np = np.asarray(tags)
    got = [out_np[i, 4 * int(front_np[i]): 4 * (int(front_np[i]) + ns[i])]
           .tobytes() + bytes(tags_np[i]) for i in range(b)]
    check(got == one_card,
          f"dp=4 sharded batch == one-card gcm_seal_batch ({b} records)")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1

    sys.path.insert(0, ROOT)
    try:
        import micro_aes  # noqa: F401
    except ImportError as e:
        print(f"micro_aes is not beside {__file__}: {e}", file=sys.stderr)
        return 2
    from micro_aes import native
    from micro_aes.utils.compile_cache import use_checkout_compile_cache

    log(f"compile cache: {use_checkout_compile_cache()}")
    import jax

    with Phase("device check"):
        devs = require_gpus(count)
        card = card_line()
        log(f"card: {card}")
        log(f"jax {jax.__version__}: {len(jax.devices())} x "
            f"{devs[0].device_kind}")
        check(native.available(), "C++ host oracle built")
    rng = np.random.default_rng(SEED)
    if args.four:
        with Phase(f"four cards: sp-sharded GCM over one "
                   f"{BULK_BYTES >> 20} MiB object"):
            phase_four_bulk(devs[:4], rng)
        with Phase("four cards: dp-sharded multi-key record batch"):
            phase_four_batch(devs[:4], rng)
    else:
        with Phase("known answers, every mode"):
            phase_kat()
        with Phase("batch engines vs the per-message path"):
            phase_batch_engines(rng)
        with Phase(f"single-key bulk object: AES-256-GCM and CTR, "
                   f"{BULK_BYTES >> 20} MiB"):
            phase_bulk_object(rng)
        with Phase(f"multi-key TLS records: {BATCH_KEYS} keys x "
                   f"{RECORD_BYTES} B"):
            phase_record_batch(rng)
        with Phase("GPU kernel vs XLA engine (2a)"):
            phase_kernel_vs_xla(rng, card)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
