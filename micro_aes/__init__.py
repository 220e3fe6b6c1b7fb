"""micro_aes — an accelerator AES framework with the full capability
surface of µAES (polfosol/micro-AES), rebuilt from scratch for JAX/XLA,
with one Pallas kernel for NVIDIA GPUs.

Every mode of the reference is available bit-exactly:

  ECB CBC(+CTS) CFB OFB CTR XTS | CMAC GCM CCM SIV GCM-SIV EAX EAX' OCB |
  KW/KWA | Poly1305-AES | FPE (FF1, FF3, FF3-1) | raw Rijndael

plus bulk engines (modes.bulk, modes.seal) and the mesh-sharded
multi-chip path (parallel/).  See README.md for the component map.
"""

__version__ = "1.0.0"  # capability parity target: µAES v11 ("1.11.0")


def purge_key_caches() -> int:
    """BURN analogue (micro_aes.c:362-368): drop every memoized
    key-derived object (round keys, key planes, CMAC subkeys, GHASH/
    POLYVAL matrices, Poly1305 power tables) across the package.
    Imports the bulk/fused engine modules first so their caches are
    registered even if they haven't been used yet.  Returns the number
    of caches cleared; same-key calls afterwards re-derive."""
    from .fpe import device as _fpe_device  # noqa: F401
    from .modes import (  # noqa: F401
        bulk as _bulk,
        ocb_bulk as _ocb_bulk,
        seal as _seal,
        seal_batch as _seal_batch,
        siv_seal as _siv_seal,
        xts_bulk as _xts_bulk,
    )
    from .ops import mac as _mac, poly_bulk as _poly_bulk  # noqa: F401
    from .utils.keycache import purge_key_caches as _purge

    return _purge()

from .core import aes_cipher, decrypt_blocks, encrypt_blocks, expand_key
from .errors import (
    AuthenticationError,
    DataLengthError,
    DecryptionError,
    EncryptionError,
    MicroAesError,
    ResultCode,
)
from .fpe import ALPHABETS, Alphabet, fpe_decrypt, fpe_encrypt
from .modes import (
    cbc_decrypt, cbc_encrypt, ccm_decrypt, ccm_encrypt, cfb_decrypt,
    cfb_encrypt, cmac, ctr_decrypt, ctr_encrypt, eax_decrypt, eax_encrypt,
    eaxp_decrypt, eaxp_encrypt, ecb_decrypt, ecb_encrypt, gcm_decrypt,
    gcm_encrypt, gcm_siv_decrypt, gcm_siv_encrypt, key_unwrap, key_wrap,
    ocb_decrypt, ocb_encrypt, ofb_decrypt, ofb_encrypt, poly1305_aes,
    siv_decrypt, siv_encrypt, xts_decrypt, xts_encrypt,
)

__all__ = [
    "__version__",
    "purge_key_caches",
    # core
    "aes_cipher", "encrypt_blocks", "decrypt_blocks", "expand_key",
    # errors
    "ResultCode", "MicroAesError", "EncryptionError", "DecryptionError",
    "AuthenticationError", "DataLengthError",
    # modes
    "ecb_encrypt", "ecb_decrypt", "cbc_encrypt", "cbc_decrypt",
    "cfb_encrypt", "cfb_decrypt", "ofb_encrypt", "ofb_decrypt",
    "ctr_encrypt", "ctr_decrypt", "xts_encrypt", "xts_decrypt",
    "cmac", "gcm_encrypt", "gcm_decrypt", "ccm_encrypt", "ccm_decrypt",
    "siv_encrypt", "siv_decrypt", "gcm_siv_encrypt", "gcm_siv_decrypt",
    "eax_encrypt", "eax_decrypt", "eaxp_encrypt", "eaxp_decrypt",
    "ocb_encrypt", "ocb_decrypt", "key_wrap", "key_unwrap",
    "poly1305_aes",
    # fpe
    "fpe_encrypt", "fpe_decrypt", "Alphabet", "ALPHABETS",
]
