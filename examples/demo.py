"""Smoke-test demo — the equivalent of the reference's main.c (L6).

Runs every mode against the embedded known answers and prints
PASSED/FAILED per mode, mirroring main.c:108-113's check() output.

    python examples/demo.py          # whatever device JAX finds
    python examples/demo.py --cpu    # force the CPU

chip_smoke.py imports main() and runs it in its own process.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import micro_aes as aes
    from micro_aes.testing import kat

    key128, key256 = kat.CIPHER_KEY[:16], kat.CIPHER_KEY
    iv, aad, pt = kat.IVEC, kat.AAD, kat.PLAINTEXT
    results = []

    def check(name, got, expect, keybits=128):
        # every embedded KAT here is an AES-128 configuration (XTS/Poly1305
        # take double-width keys but run AES-128 underneath)
        ok = got == expect
        results.append(ok)
        print(f"AES-{keybits} {name}: "
              f"{'PASSED!' if ok else 'FAILED :`('}")

    check("ECB encryption", aes.ecb_encrypt(key128, pt), kat.ECB128)
    check("ECB decryption", aes.ecb_decrypt(key128, kat.ECB128)[: len(pt)], pt)
    check("CBC encryption", aes.cbc_encrypt(key128, iv, pt), kat.CBC128_CTS)
    check("CBC decryption", aes.cbc_decrypt(key128, iv, kat.CBC128_CTS), pt)
    check("CFB encryption", aes.cfb_encrypt(key128, iv, pt), kat.CFB128)
    check("OFB encryption", aes.ofb_encrypt(key128, iv, pt), kat.OFB128)
    check("CTR encryption", aes.ctr_encrypt(key128, iv, pt), kat.CTR128)
    check("XTS encryption", aes.xts_encrypt(key256, iv, pt), kat.XTS128)
    check("plaintext CMAC", aes.cmac(key128, pt), kat.CMAC128)
    check("Poly1305 of PT", aes.poly1305_aes(key256, iv, pt), kat.POLY1305_128)
    check("GCM encryption", aes.gcm_encrypt(key128, iv[:12], aad, pt), kat.GCM128)
    check("GCM decryption", aes.gcm_decrypt(key128, iv[:12], aad, kat.GCM128), pt)
    check("CCM encryption", aes.ccm_encrypt(key128, iv[:11], aad, pt), kat.CCM128)
    check("OCB encryption", aes.ocb_encrypt(key128, iv[:12], aad, pt), kat.OCB128)
    siv_iv, siv_ct = aes.siv_encrypt(key256, aad, pt)
    check("SIV encryption", siv_iv + siv_ct, kat.SIV128)
    check("GCMSIV encrypt", aes.gcm_siv_encrypt(key128, iv[:12], aad, pt),
          kat.GCMSIV128)
    check("EAX encryption", aes.eax_encrypt(key128, iv, aad, pt), kat.EAX128)
    check("FF1 encryption",
          aes.fpe_encrypt(key128, aad, kat.FPE_PLAIN), kat.FPE_FF1_CIPHER)
    check("KW- (key wrap)",
          aes.key_wrap(kat.SECRET_KEY[:16], kat.SECOND_KEY[:16]), kat.KW128)

    n_fail = results.count(False)
    print(f"\n{len(results) - n_fail}/{len(results)} passed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    raise SystemExit(main())
