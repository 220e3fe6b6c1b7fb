"""Key-material cache registry — the BURN analogue.

The reference wipes its expanded round keys after every operation when
INCREASE_SECURITY is on (micro_aes.c:362-368, `BURN(RoundKey)`).  This
package instead memoizes key-derived device arrays (round keys, packed
key planes, CMAC subkeys, GHASH/POLYVAL matrices, Poly1305 power tables)
for throughput — so the parity mechanism is an explicit purge: every
cache that holds key-derived material is declared with `@key_cache(...)`
instead of a bare `functools.lru_cache`, and `purge_key_caches()` clears
them all at once, dropping the last references so the buffers (host and
device) are freed.

Structural caches that hold no key material (powers of the fixed XTS
doubling matrix, FPE radix tables, alphabet LUTs) keep plain lru_cache —
`grep -rn "@key_cache" micro_aes` is the audit surface.

Caveat (documented in README): Python cannot guarantee zeroization of
freed memory the way `memset` over a static C buffer can; purging
removes the library's own retained copies, which is the strongest
available contract in this runtime.
"""
from __future__ import annotations

import functools

_REGISTRY: list = []


def key_cache(maxsize: int = 128):
    """`functools.lru_cache(maxsize)` that also registers the cache for
    `purge_key_caches()`.  Use for ANY memo keyed on (or producing)
    secret key material."""
    def deco(fn):
        wrapped = functools.lru_cache(maxsize=maxsize)(fn)
        _REGISTRY.append(wrapped)
        return wrapped
    return deco


def purge_key_caches() -> int:
    """Clear every registered key-material cache (BURN analogue,
    micro_aes.c:362-368).  Returns the number of caches cleared.
    Subsequent calls with the same key transparently re-derive."""
    for fn in _REGISTRY:
        fn.cache_clear()
    return len(_REGISTRY)


def registered_key_caches() -> tuple:
    """The registered cache-wrapped functions (for tests/audits)."""
    return tuple(_REGISTRY)
