"""Conformance-harness CLI — the equivalent of testvectors/aes_testvectors.c.

Runs every vector suite against the framework and prints a per-mode
summary (total / encrypt failures / decrypt failures), writing
`<MODE>failure.log` files for any mismatches (and deleting clean logs),
mirroring check_testvectors (aes_testvectors.h:104-160).

    python -m micro_aes.testing.run [--suite GCM ...]
"""
from __future__ import annotations

import argparse
import os


def _log(name: str, lines: list[str]) -> None:
    path = f"{name}failure.log"
    if lines:
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    elif os.path.exists(path):
        os.remove(path)


def run_gcm(report):
    from ..modes.bulk import gcm_encrypt_batch
    from . import rsp

    for keylen in (128, 192, 256):
        recs = rsp.load_gcm(keylen)
        outs = gcm_encrypt_batch(
            [rsp.hexval(r, "Key") for r in recs],
            [rsp.hexval(r, "IV") for r in recs],
            [rsp.hexval(r, "AAD") for r in recs],
            [rsp.hexval(r, "PT") for r in recs])
        fails = []
        for r, out in zip(recs, outs):
            taglen = int(r["Taglen"]) // 8
            ct, tag = rsp.hexval(r, "CT"), rsp.hexval(r, "Tag")
            if out[: len(ct)] != ct or out[len(ct): len(ct) + taglen] != tag:
                fails.append(f"Count={r['Count']} Key={r['Key']}")
        report(f"GCM-{keylen}", len(recs), len(fails), 0, fails)


def run_ccm(report):
    from ..modes import ccm_decrypt, ccm_encrypt
    from . import rsp

    for keylen in (128, 192, 256):
        recs = rsp.load_ccm(keylen)
        ef, df = [], []
        for r in recs:
            nlen, tlen = int(r["Nlen"]), int(r["Tlen"])
            key, nonce = rsp.hexval(r, "Key"), rsp.hexval(r, "Nonce")
            aad, pt = rsp.hexval(r, "Adata"), rsp.hexval(r, "Payload")
            expect = rsp.hexval(r, "CT")
            if ccm_encrypt(key, nonce, aad, pt, nlen, tlen) != expect:
                ef.append(f"Count={r['Count']}")
            try:
                if ccm_decrypt(key, nonce, aad, expect, nlen, tlen) != pt:
                    df.append(f"Count={r['Count']}")
            except Exception:
                df.append(f"Count={r['Count']}")
        report(f"CCM-{keylen}", len(recs), len(ef), len(df), ef + df)


def run_xts(report):
    from ..modes.xts import xts_decrypt, xts_encrypt
    from . import rsp

    for keylen in (128, 256):
        recs = [r for r in rsp.load_xts(keylen)
                if int(r["DataUnitLen"]) == 8 * len(rsp.hexval(r, "PT"))]
        ef, df = [], []
        for r in recs:
            key, tw = rsp.hexval(r, "Key"), rsp.hexval(r, "i")
            pt, ct = rsp.hexval(r, "PT"), rsp.hexval(r, "CT")
            if xts_encrypt(key, tw, pt) != ct:
                ef.append(f"COUNT={r['COUNT']}")
            if xts_decrypt(key, tw, ct) != pt:
                df.append(f"COUNT={r['COUNT']}")
        report(f"XTS-{keylen}", len(recs), len(ef), len(df), ef + df)


def run_cmac(report):
    from ..modes.bulk import cmac_batch
    from . import rsp

    for keylen in (128, 192, 256):
        recs = rsp.load_cmac(keylen)
        outs = cmac_batch([rsp.hexval(r, "Key") for r in recs],
                          [rsp.hexval(r, "Msg")[: int(r["Mlen"])] for r in recs])
        fails = [f"Count={r['Count']}" for r, out in zip(recs, outs)
                 if out[: int(r["Tlen"])] != rsp.hexval(r, "Mac")]
        report(f"CMAC-{keylen}", len(recs), len(fails), 0, fails)


def run_gcm_siv(report):
    from ..modes import gcm_siv_decrypt, gcm_siv_encrypt
    from . import rsp

    recs = rsp.load_gcm_siv()
    ef, df = [], []
    for r in recs:
        key, ivb = rsp.hexval(r, "key"), rsp.hexval(r, "iv")
        aad, pt, ct = rsp.hexval(r, "aad"), rsp.hexval(r, "pt"), rsp.hexval(r, "ct")
        if gcm_siv_encrypt(key, ivb, aad, pt) != ct:
            ef.append(f"Count={r['Count']}")
        if gcm_siv_decrypt(key, ivb, aad, ct) != pt:
            df.append(f"Count={r['Count']}")
    report("GCM-SIV", len(recs), len(ef), len(df), ef + df)


def run_eax(report):
    from ..modes import eax_decrypt, eax_encrypt
    from . import rsp

    recs = rsp.load_eax()
    fails = []
    for r in recs:
        key, nonce = rsp.hexval(r, "KEY"), rsp.hexval(r, "NONCE")
        aad, pt = rsp.hexval(r, "HEADER"), rsp.hexval(r, "MSG")
        ct = rsp.hexval(r, "CIPHER")
        if eax_encrypt(key, nonce, aad, pt) != ct or \
                eax_decrypt(key, nonce, aad, ct) != pt:
            fails.append(f"KEY={r['KEY']}")
    report("EAX", len(recs), len(fails), 0, fails)


def run_ocb(report):
    from ..errors import AuthenticationError
    from ..modes import ocb_decrypt, ocb_encrypt
    from . import rsp

    recs = rsp.load_ocb()
    fails = []
    for i, r in enumerate(recs):
        key, nonce = rsp.hexval(r, "Key"), rsp.hexval(r, "IV")
        aad, pt = rsp.hexval(r, "AAD"), rsp.hexval(r, "Plaintext")
        ct, tag = rsp.hexval(r, "Ciphertext"), rsp.hexval(r, "Tag")
        try:
            if r.get("Result") == "CIPHERFINAL_ERROR":
                try:
                    ocb_decrypt(key, nonce, aad, ct + tag, tag_len=len(tag))
                    fails.append(f"case {i}: expected failure")
                except AuthenticationError:
                    pass
                continue
            if ocb_encrypt(key, nonce, aad, pt, tag_len=len(tag)) != ct + tag:
                fails.append(f"case {i}")
        except Exception as e:
            fails.append(f"case {i}: {e}")
    report("OCB", len(recs), len(fails), 0, fails)


def run_poly1305(report):
    from ..modes import poly1305_aes
    from . import rsp

    recs = rsp.load_poly1305()
    fails = [f"Count={r['Count']}" for r in recs
             if poly1305_aes(rsp.hexval(r, "Keys"), rsp.hexval(r, "Nonce"),
                             rsp.hexval(r, "Msg")[: int(r["Mlen"])])
             != rsp.hexval(r, "PolyMac")]
    report("POLY1305", len(recs), len(fails), 0, fails)


def run_fpe(report):
    from ..fpe import fpe_decrypt, fpe_encrypt
    from . import rsp

    recs = rsp.load_fpe()
    fails = []
    for r in recs:
        method = r["Method"].strip().lower()
        if method == "ff3":
            method = "ff3" if len(rsp.hexval(r, "Tweak")) == 8 else "ff3-1"
        try:
            got = fpe_encrypt(rsp.hexval(r, "Key"), rsp.hexval(r, "Tweak"),
                              r["PT"], r["Alphabet"], method)
            back = fpe_decrypt(rsp.hexval(r, "Key"), rsp.hexval(r, "Tweak"),
                               r["CT"], r["Alphabet"], method)
            if got != r["CT"] or back != r["PT"]:
                fails.append(f"Count={r['Count']}")
        except Exception as e:
            fails.append(f"Count={r['Count']}: {e}")
    report("FPE", len(recs), len(fails), 0, fails)


SUITES = {
    "GCM": run_gcm, "CCM": run_ccm, "XTS": run_xts, "CMAC": run_cmac,
    "GCMSIV": run_gcm_siv, "EAX": run_eax, "OCB": run_ocb,
    "POLY1305": run_poly1305, "FPE": run_fpe,
}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--suite", nargs="*", choices=sorted(SUITES),
                        help="subset of suites (default: all)")
    parser.add_argument("--backend", default="cpu",
                        help="jax platform (default cpu; pass 'default' to "
                             "keep the environment's backend)")
    args = parser.parse_args(argv)

    if args.backend != "default":
        import jax

        jax.config.update("jax_platforms", args.backend)

    totals = [0, 0, 0]

    def report(name, n, enc_fail, dec_fail, fails):
        totals[0] += n
        totals[1] += enc_fail
        totals[2] += dec_fail
        status = "ok" if not (enc_fail or dec_fail) else "FAIL"
        print(f"{name:>10}: {n:5d} cases  enc-fail {enc_fail:3d}  "
              f"dec-fail {dec_fail:3d}  [{status}]")
        _log(name, fails)

    for name in (args.suite or sorted(SUITES)):
        SUITES[name](report)
    print(f"\nTotal: {totals[0]} cases, {totals[1]} encrypt failures, "
          f"{totals[2]} decrypt failures")
    return 1 if totals[1] or totals[2] else 0


if __name__ == "__main__":
    raise SystemExit(main())
