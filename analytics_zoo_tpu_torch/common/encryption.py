"""Record encryption — AES-GCM/CBC with PBKDF2 key derivation.

The port's copy of ``analytics_zoo_tpu/common/encryption.py``: the same
construction and wire bytes, so either package decrypts what the other
encrypts. The ``cryptography`` package is imported where a key is
derived or a cipher runs, not when this module is imported: on a host
without it each function raises ``ImportError`` naming it.

Parity with the reference's PPML crypto helpers
(pyzoo/zoo/common/encryption_utils.py:29-186 ``encrypt_bytes_with_AES_GCM``/
``..._CBC`` and JVM EncryptSupportive.scala:207), which protect serving
records in SGX deployments (``recordEncrypted``, FlinkInference.scala:55).
Same construction: PBKDF2-HMAC-SHA256(secret, salt) → AES key; GCM output
is ``salt ‖ nonce ‖ ciphertext ‖ tag``, CBC is ``salt ‖ iv ‖ ciphertext``
with PKCS7 padding. Base64 string variants mirror the reference's
``encrypt_with_AES_*`` str API.

``make_cipher`` returns the ``(encrypt, decrypt)`` pair the serving schema
accepts (serving/schema.py Cipher) — that is the wire-level hook for the
reference's record-encryption flag.
"""

from __future__ import annotations

import base64
import os
from typing import Tuple



def _lib():
    """The ``cryptography`` primitives this module uses."""
    from types import SimpleNamespace

    from cryptography.hazmat.primitives import hashes, padding
    from cryptography.hazmat.primitives.ciphers import Cipher
    from cryptography.hazmat.primitives.ciphers import algorithms, modes
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    from cryptography.hazmat.primitives.kdf.pbkdf2 import PBKDF2HMAC
    return SimpleNamespace(hashes=hashes, padding=padding, Cipher=Cipher,
                           algorithms=algorithms, modes=modes, AESGCM=AESGCM,
                           PBKDF2HMAC=PBKDF2HMAC)

SALT_LEN = 16
NONCE_LEN = 12
IV_LEN = 16
# ref encryption_utils.py uses 65536 PBKDF2 rounds and a 128/256-bit key
ITERATIONS = 65536


def _derive_key(secret: str, salt: bytes, key_len: int = 32) -> bytes:
    c = _lib()
    kdf = c.PBKDF2HMAC(algorithm=c.hashes.SHA256(), length=key_len,
                       salt=salt, iterations=ITERATIONS)
    return kdf.derive(secret.encode())


# ------------------------------------------------------------------ AES-GCM
def encrypt_bytes_with_aes_gcm(data: bytes, secret: str,
                               salt: bytes = None) -> bytes:
    salt = salt or os.urandom(SALT_LEN)
    key = _derive_key(secret, salt)
    nonce = os.urandom(NONCE_LEN)
    # ciphertext ‖ 16-byte tag
    ct = _lib().AESGCM(key).encrypt(nonce, data, None)
    return salt + nonce + ct


def decrypt_bytes_with_aes_gcm(blob: bytes, secret: str) -> bytes:
    salt, nonce = blob[:SALT_LEN], blob[SALT_LEN:SALT_LEN + NONCE_LEN]
    key = _derive_key(secret, salt)
    return _lib().AESGCM(key).decrypt(nonce, blob[SALT_LEN + NONCE_LEN:],
                                      None)


# ------------------------------------------------------------------ AES-CBC
def _cbc_encrypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    c = _lib()
    padder = c.padding.PKCS7(128).padder()
    padded = padder.update(data) + padder.finalize()
    enc = c.Cipher(c.algorithms.AES(key), c.modes.CBC(iv)).encryptor()
    return enc.update(padded) + enc.finalize()


def _cbc_decrypt(key: bytes, iv: bytes, ct: bytes) -> bytes:
    c = _lib()
    dec = c.Cipher(c.algorithms.AES(key), c.modes.CBC(iv)).decryptor()
    padded = dec.update(ct) + dec.finalize()
    unpadder = c.padding.PKCS7(128).unpadder()
    return unpadder.update(padded) + unpadder.finalize()


def encrypt_bytes_with_aes_cbc(data: bytes, secret: str,
                               salt: bytes = None) -> bytes:
    salt = salt or os.urandom(SALT_LEN)
    key = _derive_key(secret, salt)
    iv = os.urandom(IV_LEN)
    return salt + iv + _cbc_encrypt(key, iv, data)


def decrypt_bytes_with_aes_cbc(blob: bytes, secret: str) -> bytes:
    salt, iv = blob[:SALT_LEN], blob[SALT_LEN:SALT_LEN + IV_LEN]
    key = _derive_key(secret, salt)
    return _cbc_decrypt(key, iv, blob[SALT_LEN + IV_LEN:])


# --------------------------------------------------------------- str surface
def encrypt_with_aes_gcm(plain: str, secret: str) -> str:
    """str → base64 str (ref encrypt_with_AES_GCM)."""
    return base64.b64encode(
        encrypt_bytes_with_aes_gcm(plain.encode(), secret)).decode()


def decrypt_with_aes_gcm(cipher_b64: str, secret: str) -> str:
    return decrypt_bytes_with_aes_gcm(
        base64.b64decode(cipher_b64), secret).decode()


def encrypt_with_aes_cbc(plain: str, secret: str) -> str:
    return base64.b64encode(
        encrypt_bytes_with_aes_cbc(plain.encode(), secret)).decode()


def decrypt_with_aes_cbc(cipher_b64: str, secret: str) -> str:
    return decrypt_bytes_with_aes_cbc(
        base64.b64decode(cipher_b64), secret).decode()


def make_cipher(secret: str, mode: str = "gcm") -> Tuple:
    """(encrypt, decrypt) byte-callables for serving record encryption
    (serving/schema.py Cipher; ref recordEncrypted flag).

    PBKDF2 at 65536 rounds costs tens of ms — per *record* that would dwarf
    the inference it protects. The cipher therefore derives the encrypt
    key once (one fixed random salt per cipher instance) and memoizes
    decrypt keys by the salt carried on each message, so steady-state
    records cost only the AES pass. Wire format is unchanged — blobs stay
    compatible with the plain encrypt_bytes_with_* functions."""
    if mode not in ("gcm", "cbc"):
        raise ValueError(f"unknown cipher mode {mode!r}; use 'gcm' or 'cbc'")
    enc_salt = os.urandom(SALT_LEN)
    enc_key = _derive_key(secret, enc_salt)
    keys: dict = {enc_salt: enc_key}

    def key_for(salt: bytes) -> bytes:
        k = keys.get(salt)
        if k is None:
            if len(keys) > 1024:  # bound the cache: one salt per peer cipher
                keys.clear()
                keys[enc_salt] = enc_key  # never evict our own encrypt key
            k = keys[salt] = _derive_key(secret, salt)
        return k

    if mode == "gcm":
        def enc(data: bytes) -> bytes:
            nonce = os.urandom(NONCE_LEN)
            return enc_salt + nonce + _lib().AESGCM(keys[enc_salt]).encrypt(
                nonce, data, None)

        def dec(blob: bytes) -> bytes:
            salt = blob[:SALT_LEN]
            nonce = blob[SALT_LEN:SALT_LEN + NONCE_LEN]
            return _lib().AESGCM(key_for(salt)).decrypt(
                nonce, blob[SALT_LEN + NONCE_LEN:], None)
        return enc, dec

    def enc(data: bytes) -> bytes:
        iv = os.urandom(IV_LEN)
        return enc_salt + iv + _cbc_encrypt(keys[enc_salt], iv, data)

    def dec(blob: bytes) -> bytes:
        salt, iv = blob[:SALT_LEN], blob[SALT_LEN:SALT_LEN + IV_LEN]
        return _cbc_decrypt(key_for(salt), iv, blob[SALT_LEN + IV_LEN:])
    return enc, dec
