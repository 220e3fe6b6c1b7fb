"""Test bootstrap: an 8-device virtual CPU mesh before JAX imports.

The suite runs on the CPU (JAX_PLATFORMS=cpu) and exercises the sharded
code paths on 8 virtual CPU devices.  Tests that need an NVIDIA GPU carry
the `gpu` marker and skip through the `gpu_device` fixture when none is
present; on a machine with a card run them with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import pytest

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# NOTE: the on-disk persistent compilation cache is intentionally OFF.
# jaxlib's executable (de)serializer segfaults on some of this suite's
# large 8-device sharded modules (observed in both the read and write
# paths, fresh cache, ample disk/RAM).  Within one pytest process the
# in-memory jit cache already deduplicates compiles, so the persistent
# cache only ever helped across runs — not worth a crashing test suite.


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    """Free compiled executables after each test module.  The suite
    compiles hundreds of large programs (unrolled bitslice circuits,
    interpret-mode Pallas kernels, 8-device sharded modules); letting
    them all stay live corrupts jaxlib eventually — three distinct
    late-suite segfaults observed (cache read, cache write, and plain
    backend_compile) that never reproduce on module subsets.  Modules
    are compilation-disjoint, so this costs little."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first JAX device if it is an NVIDIA GPU; skips the test
    otherwise.  Decided here, at run time, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform is {dev.platform})")
    return dev


@pytest.fixture
def vector_corpus():
    """Directory of the CAVP/reference vector corpus
    (MICRO_AES_VECTORS); skips the test when it holds no files."""
    from micro_aes.testing.rsp import REFERENCE_VECTORS as root

    if not root.is_dir() or not any(root.iterdir()):
        pytest.skip(f"vector corpus not present at {root} "
                    "(set MICRO_AES_VECTORS)")
    return root
