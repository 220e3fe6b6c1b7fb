"""Roofline model of the bitsliced AES engines on the card JAX reports.

Counts the exact per-byte work of each engine by tracing it to a jaxpr
and tallying every primitive's output elements (recursing into scans and
into the Pallas kernel's body, times its grid), then divides the card's
peak rates by those per-byte figures to get a speed of light for each
engine.  Run on the machine with the card:

    python roofline.py [--measured 2=5.6e10 ...]   # row index or name prefix
    python roofline.py --device-kind "NVIDIA H100 80GB HBM3"   # anywhere

The counting is mechanical, so it follows the code as it changes.  An
integer op here is one 2-input elementwise operation; Hopper's LOP3
instruction can fold up to three of the bitsliced circuit's logic ops
into one, so a kernel may beat this ALU bound by up to that factor —
the model is a yardstick, not a ceiling.  It ignores loads, stores and
loop overhead.
"""
from __future__ import annotations

import argparse
import functools
import json

import numpy as np

# Peaks by jax.Device.device_kind.  A device not in this table is an error.
PEAKS = {
    # H100 SXM5, 700 W.  HBM and int8 tensor rates: NVIDIA H100 data sheet
    # (3.35 TB/s; 1,979 dense int8 TOPS = 989.5e12 MAC/s).  Integer ALU:
    # CUDA C++ Programming Guide, arithmetic-instruction throughput table,
    # compute capability 9.0: 64 results/clock/SM for 32-bit bitwise
    # AND/OR/XOR and for 32-bit add/shift, x 132 SMs x 1.98 GHz boost.
    "NVIDIA H100 80GB HBM3": {
        "int32_ops_per_s": 64 * 132 * 1.98e9,
        "int8_macs_per_s": 989.5e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet (SXM5); CUDA C++ Programming "
                  "Guide, throughput table, cc 9.0, x 132 SMs x 1.98 GHz",
    },
}

# elementwise primitives that take an integer ALU slot per output element
_ALU = {
    "xor", "and", "or", "not", "add", "sub", "mul", "shift_left",
    "shift_right_logical", "shift_right_arithmetic", "select_n", "eq",
    "ne", "lt", "le", "gt", "ge", "max", "min", "rem", "div",
    "convert_element_type", "integer_pow", "floor", "sign",
}
# data movement (copies, permutes, loads/stores inside a kernel)
_MOVE = {
    "roll", "concatenate", "slice", "dynamic_slice", "pad", "gather",
    "reshape", "transpose", "broadcast_in_dim", "rev", "dynamic_update_slice",
    "squeeze", "iota", "copy", "get", "swap", "load", "masked_load",
    "masked_swap",
}
_MATMUL = {"dot_general"}
_FREE = {"constant", "stop_gradient", "bitcast_convert_type",
         "program_id"}


def _elems(aval) -> int:
    return int(np.prod([int(d) for d in aval.shape])) if aval.shape else 1


def count_jaxpr(jaxpr, mult: int = 1, counts=None):
    """Tally output elements per primitive category, recursing into
    control flow (scan x length, while x 1) and Pallas kernels (body x
    grid size)."""
    if counts is None:
        counts = {"alu": 0, "move": 0, "macs": 0, "other": {}}
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "scan":
            count_jaxpr(eqn.params["jaxpr"].jaxpr,
                        mult * eqn.params.get("length", 1), counts)
            continue
        if prim == "while":
            count_jaxpr(eqn.params["body_jaxpr"].jaxpr, mult, counts)
            continue
        if prim == "cond":
            count_jaxpr(eqn.params["branches"][0].jaxpr, mult, counts)
            continue
        if prim == "pallas_call":
            grid = eqn.params["grid_mapping"].grid
            count_jaxpr(eqn.params["jaxpr"], mult * int(np.prod(grid)),
                        counts)
            continue
        if prim in ("pjit", "jit", "closed_call", "custom_jvp_call",
                    "custom_vjp_call", "remat"):
            inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
            if inner is not None:
                count_jaxpr(getattr(inner, "jaxpr", inner), mult, counts)
            continue
        out = sum(_elems(v.aval) for v in eqn.outvars)
        if prim in _ALU:
            counts["alu"] += mult * out
        elif prim in _MOVE:
            counts["move"] += mult * out
        elif prim in _MATMUL:
            (lhs, _), _ = eqn.params["dimension_numbers"]
            lshape = eqn.invars[0].aval.shape
            k = int(np.prod([int(lshape[d]) for d in lhs])) or 1
            counts["macs"] += mult * out * k
        elif prim not in _FREE:
            counts["other"][prim] = counts["other"].get(prim, 0) + mult * out
    return counts


def _stream_args(rounds: int, w: int):
    import jax.numpy as jnp

    return (jnp.zeros(((rounds + 1) * 128, 1), jnp.uint32),
            jnp.zeros((128, 1), jnp.uint32), jnp.zeros((2, w), jnp.uint32),
            jnp.zeros((w, 128), jnp.uint32))


def _trace(fn, *args, **kw):
    import jax

    return count_jaxpr(
        jax.make_jaxpr(functools.partial(fn, **kw))(*args).jaxpr)


def engine_counts(w: int):
    """(name, counts, bytes) for each engine at W stream columns
    (32*W blocks = 512*W bytes)."""
    import jax.numpy as jnp

    from micro_aes.core.bitslice import encrypt_planes
    from micro_aes.ops.ctr_kernel import ctr_fused_kernel
    from micro_aes.ops.stream import (
        ctr_fused_jnp,
        ctrw_fused_jnp,
        seal_fused_jnp,
    )

    nbytes = 512 * w
    kp14, j0c, lohi, x = _stream_args(14, w)
    kp10 = jnp.zeros((11 * 128, 1), jnp.uint32)
    ghm = jnp.zeros((1, w), jnp.uint32)
    w1t = jnp.zeros((128, 4096), jnp.int8)
    return [
        ("AES-256 cipher (bitsliced planes, XLA)",
         _trace(encrypt_planes, kp14.reshape(15, 8, 16),
                jnp.zeros((8, 16, w), jnp.uint32)), nbytes),
        ("AES-256 CTR keystream xor (XLA engine)",
         _trace(ctr_fused_jnp, kp14, j0c, lohi, x), nbytes),
        ("AES-256 CTR keystream xor (GPU kernel)",
         _trace(ctr_fused_kernel, kp14, j0c, lohi, x), nbytes),
        ("AES-256-GCM seal step (XLA engine, GHASH level 1 incl.)",
         _trace(seal_fused_jnp, kp14, j0c, lohi, ghm, w1t, x), nbytes),
        ("AES-128 XEX body seal (OCB/XTS, XLA)",
         _trace(ctrw_fused_jnp, kp10, x, x), nbytes),
        ("AES-128 XEX body open (inverse cipher, XLA)",
         _trace(ctrw_fused_jnp, kp10, x, x, decrypt=True), nbytes),
    ]


def roofline_row(name, counts, nbytes, peaks, measured=None):
    alu_pb = counts["alu"] / nbytes
    mac_pb = counts["macs"] / nbytes
    t_alu = alu_pb / peaks["int32_ops_per_s"]
    t_mac = mac_pb / peaks["int8_macs_per_s"]
    t_hbm = 2.0 / peaks["hbm_bytes_per_s"]          # stream in + out
    sol = 1.0 / max(t_alu, t_mac, t_hbm)
    bound = ("int32 ALU" if t_alu >= max(t_mac, t_hbm)
             else "int8 tensor" if t_mac >= t_hbm else "HBM")
    row = {
        "engine": name,
        "alu_ops_per_byte": round(alu_pb, 2),
        "move_ops_per_byte": round(counts["move"] / nbytes, 2),
        "int8_macs_per_byte": round(mac_pb, 2),
        "other": counts["other"],
        "speed_of_light_bytes_per_s": round(sol),
        "bound_by": bound,
    }
    if measured:
        row["measured_bytes_per_s"] = measured
        row["fraction_of_roofline"] = round(measured / sol, 4)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device-kind", default=None,
                    help="peaks to use (default: jax.devices()[0]'s kind)")
    ap.add_argument("--measured", nargs="*", default=[],
                    metavar="NAME=BYTES_PER_S",
                    help="attach measured rates by row index or name "
                         "prefix, e.g. 2=3.1e11")
    ap.add_argument("--w", type=int, default=1024,
                    help="stream columns traced (32 blocks each)")
    args = ap.parse_args(argv)
    kind = args.device_kind
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise SystemExit(f"no peak rates for device kind {kind!r}; known: "
                         f"{sorted(PEAKS)}")
    peaks = PEAKS[kind]
    measured = dict(kv.split("=") for kv in args.measured)
    rows = []
    for i, (name, counts, nbytes) in enumerate(engine_counts(args.w)):
        m = measured.get(str(i)) or next(
            (v for k, v in measured.items() if name.startswith(k)), None)
        rows.append(roofline_row(name, counts, nbytes, peaks,
                                 float(m) if m else None))
    print(json.dumps({"device_kind": kind, "peaks": peaks, "rows": rows},
                     indent=1))


if __name__ == "__main__":
    main()
