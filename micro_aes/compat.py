"""C-style compatibility layer: the reference's exact function surface.

Every `AES_*` function below mirrors its counterpart in micro_aes.h
(names, argument order, buffer-with-appended-tag conventions, and
numeric return codes — including the `0x1L` == 1 quirk).  Use this layer
when porting code from the C library verbatim; the pythonic API in
`micro_aes` proper is preferred for new code.

Fallible functions return (code, output) instead of writing through
pointers; infallible ones (void in C) return output alone.
"""
from __future__ import annotations

from . import modes
from .core.cipher import aes_cipher
from .errors import MicroAesError, ResultCode
from .fpe import fpe_decrypt, fpe_encrypt

M_RESULT_SUCCESS = int(ResultCode.SUCCESS)
M_ENCRYPTION_ERROR = int(ResultCode.ENCRYPTION_ERROR)
M_DECRYPTION_ERROR = int(ResultCode.DECRYPTION_ERROR)
M_AUTHENTICATION_ERROR = int(ResultCode.AUTHENTICATION_ERROR)
M_DATALENGTH_ERROR = int(ResultCode.DATALENGTH_ERROR)


def _guard(fn, *args, **kwargs):
    try:
        return M_RESULT_SUCCESS, fn(*args, **kwargs)
    except MicroAesError as e:
        return int(e.code), b""


def AES_Cipher(key, mode, block):
    """micro_aes.h:163."""
    return aes_cipher(key, mode, block)


def AES_ECB_encrypt(key, pntxt):
    return modes.ecb_encrypt(key, pntxt)


def AES_ECB_decrypt(key, crtxt):
    return _guard(modes.ecb_decrypt, key, crtxt)


def AES_CBC_encrypt(key, iVec, pntxt):
    return _guard(modes.cbc_encrypt, key, iVec, pntxt)


def AES_CBC_decrypt(key, iVec, crtxt):
    return _guard(modes.cbc_decrypt, key, iVec, crtxt)


def AES_CFB_encrypt(key, iVec, pntxt):
    return modes.cfb_encrypt(key, iVec, pntxt)


def AES_CFB_decrypt(key, iVec, crtxt):
    return modes.cfb_decrypt(key, iVec, crtxt)


def AES_OFB_encrypt(key, iVec, pntxt):
    return modes.ofb_encrypt(key, iVec, pntxt)


def AES_OFB_decrypt(key, iVec, crtxt):
    return modes.ofb_decrypt(key, iVec, crtxt)


def AES_CTR_encrypt(key, iv, pntxt):
    return modes.ctr_encrypt(key, iv, pntxt)


def AES_CTR_decrypt(key, iv, crtxt):
    return modes.ctr_decrypt(key, iv, crtxt)


def AES_XTS_encrypt(keys, tweak, pntxt):
    return _guard(modes.xts_encrypt, keys, tweak, pntxt)


def AES_XTS_decrypt(keys, tweak, crtxt):
    return _guard(modes.xts_decrypt, keys, tweak, crtxt)


def AES_SIV_encrypt(keys, aData, pntxt):
    """Returns (iv, crtxt) like the two output buffers of micro_aes.h:273."""
    return modes.siv_encrypt(keys, aData, pntxt)


def AES_SIV_decrypt(keys, iv, aData, crtxt):
    return _guard(modes.siv_decrypt, keys, iv, aData, crtxt)


def AES_GCM_encrypt(key, nonce, aData, pntxt):
    return modes.gcm_encrypt(key, nonce, aData, pntxt)


def AES_GCM_decrypt(key, nonce, aData, crtxt_with_tag):
    return _guard(modes.gcm_decrypt, key, nonce, aData, crtxt_with_tag)


def AES_CCM_encrypt(key, nonce, aData, pntxt):
    return modes.ccm_encrypt(key, nonce, aData, pntxt)


def AES_CCM_decrypt(key, nonce, aData, crtxt_with_tag):
    return _guard(modes.ccm_decrypt, key, nonce, aData, crtxt_with_tag)


def AES_OCB_encrypt(key, nonce, aData, pntxt):
    return modes.ocb_encrypt(key, nonce, aData, pntxt)


def AES_OCB_decrypt(key, nonce, aData, crtxt_with_tag):
    return _guard(modes.ocb_decrypt, key, nonce, aData, crtxt_with_tag)


def AES_EAX_encrypt(key, nonce, aData, pntxt):
    return modes.eax_encrypt(key, nonce, aData, pntxt)


def AES_EAX_decrypt(key, nonce, aData, crtxt_with_tag):
    return _guard(modes.eax_decrypt, key, nonce, aData, crtxt_with_tag)


def GCM_SIV_encrypt(key, nonce, aData, pntxt):
    return modes.gcm_siv_encrypt(key, nonce, aData, pntxt)


def GCM_SIV_decrypt(key, nonce, aData, crtxt_with_tag):
    return _guard(modes.gcm_siv_decrypt, key, nonce, aData, crtxt_with_tag)


def AES_KEY_wrap(kek, secret):
    return _guard(modes.key_wrap, kek, secret)


def AES_KEY_unwrap(kek, wrapped):
    return _guard(modes.key_unwrap, kek, wrapped)


def AES_Poly1305(keys, nonce, data):
    return modes.poly1305_aes(keys, nonce, data)


def AES_CMAC(key, data):
    return modes.cmac(key, data)


def AES_FPE_encrypt(key, tweak, pntxt, alphabet="digits", method="ff1"):
    return _guard(fpe_encrypt, key, tweak, pntxt, alphabet, method)


def AES_FPE_decrypt(key, tweak, crtxt, alphabet="digits", method="ff1"):
    return _guard(fpe_decrypt, key, tweak, crtxt, alphabet, method)
