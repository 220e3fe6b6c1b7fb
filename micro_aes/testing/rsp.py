"""Parsers for NIST CAVP `.rsp` files and the reference's curated `.tv`
files — a Python replication of the headline-prefix logic in
testvectors/aes_testvectors.h:32-96.

One generic line-oriented parser covers every file: `key <sep> value`
lines accumulate into records; a line whose key equals `trigger` starts a
new record; bracket lines `[X = Y]` / `[SECTION]` and key-values seen
outside any record become inherited context.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Iterator

# The reference vector corpus (NIST CAVP .rsp + the reference's .tv
# files) is not part of this repository: MICRO_AES_VECTORS names its
# directory, by default `testvectors/` at the checkout root.
REFERENCE_VECTORS = Path(os.environ.get(
    "MICRO_AES_VECTORS",
    Path(__file__).resolve().parents[2] / "testvectors"))


def parse_records(path, trigger: str, sep: str = "=") -> Iterator[dict]:
    context: dict[str, str] = {}
    record: dict | None = None
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            m = re.fullmatch(r"\[(.+?)\]", line)
            if m:
                if record is not None:
                    yield record
                    record = None
                inner = m.group(1)
                if sep in inner:
                    k, v = inner.split(sep, 1)
                    context[k.strip()] = v.strip()
                else:
                    context["SECTION"] = inner.strip()
                continue
            if sep not in line:
                continue
            k, v = line.split(sep, 1)
            k, v = k.strip(), v.strip()
            if k.lower() == trigger.lower():
                if record is not None:
                    yield record
                record = dict(context)
                record[k] = v
            elif record is not None:
                record[k] = v
            else:
                context[k] = v
    if record is not None:
        yield record


def hexval(record: dict, key: str) -> bytes:
    return bytes.fromhex(record.get(key, "") or "")


# ---- per-suite convenience loaders ----------------------------------------

def load_gcm(keylen: int) -> list[dict]:
    return list(parse_records(REFERENCE_VECTORS / f"GcmEncryptExtIV{keylen}.rsp", "Count"))


def load_ccm(keylen: int) -> list[dict]:
    return list(parse_records(REFERENCE_VECTORS / f"VNT{keylen}.rsp", "Count"))


def load_xts(keylen: int) -> list[dict]:
    return list(parse_records(REFERENCE_VECTORS / f"XTSGenAES{keylen}.rsp", "COUNT"))


def load_cmac(keylen: int) -> list[dict]:
    return list(parse_records(REFERENCE_VECTORS / f"CMACGenAES{keylen}.rsp", "Count"))


def load_gcm_siv() -> list[dict]:
    return list(parse_records(REFERENCE_VECTORS / "SIV_GCM_ACVP.tv", "Count"))


def load_poly1305() -> list[dict]:
    return list(parse_records(REFERENCE_VECTORS / "Poly1305AES128.tv", "Count"))


def load_eax() -> list[dict]:
    return list(parse_records(REFERENCE_VECTORS / "EAX_AES128.tv", "MSG", sep=":"))


def load_ocb() -> list[dict]:
    return list(parse_records(REFERENCE_VECTORS / "OCB_AES128.tv", "Cipher"))


def load_fpe() -> list[dict]:
    return list(parse_records(REFERENCE_VECTORS / "FPE_FF1&FF3&FF3-1.tv", "Count"))
