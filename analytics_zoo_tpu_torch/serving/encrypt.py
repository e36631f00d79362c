"""Encryption at rest for saved models (a copy of
analytics_zoo_tpu/serving/encrypt.py; reference
`zoo/src/main/scala/.../pipeline/inference/EncryptSupportive.scala`:
AES-encrypted model files loaded by InferenceModel).  The bytes on disk
are the JAX package's, so each package reads the other's blobs.

With the `cryptography` package: AES-256-GCM under a
PBKDF2-HMAC-SHA256 key, ``b"AZTE3" | salt(16) | nonce(12) | ct||tag``.

Without it (the standard library only): PBKDF2-HMAC-SHA256 into
domain-separated (k_enc, k_mac), a SHAKE-256 keystream keyed by
k_enc||nonce, and an encrypt-then-MAC HMAC-SHA256 tag under k_mac,
``b"AZTE2" | salt(16) | nonce(16) | tag(32) | ciphertext``.

Decryption reads both and the legacy ``AZTE1`` (an HMAC-CTR keystream),
whatever is installed, except that ``AZTE3`` needs `cryptography`.
`format_of(blob)` names a blob's format.
"""

from __future__ import annotations

import hashlib
import hmac
import os

import numpy as np

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # the standard-library format is written instead
    AESGCM = None

_MAGIC_V3 = b"AZTE3"   # AES-256-GCM (cryptography package)
_MAGIC = b"AZTE2"      # stdlib SHAKE-256 stream + HMAC EtM
_MAGIC_V1 = b"AZTE1"   # legacy HMAC-CTR format: still decryptable
_ITERS = 100_000


def _derive(key: str, salt: bytes):
    """(k_enc, k_mac) — domain-separated so keystream PRF inputs and
    MAC inputs can never collide (an 8-byte ciphertext equal to a
    counter encoding would otherwise make the tag equal a keystream
    block)."""
    k = hashlib.pbkdf2_hmac("sha256", key.encode("utf-8"), salt, _ITERS)
    k_enc = hmac.new(k, b"enc", hashlib.sha256).digest()
    k_mac = hmac.new(k, b"mac", hashlib.sha256).digest()
    return k_enc, k_mac


def _keystream(k: bytes, nonce: bytes, n: int) -> bytes:
    """SHAKE-256 XOF keyed by k_enc||nonce — one C-level call produces
    the whole keystream (an HMAC-per-32B-block Python loop took tens of
    seconds per GB)."""
    return hashlib.shake_256(k + nonce).digest(n)


def _xor(data: bytes, ks: bytes) -> bytes:
    return (np.frombuffer(data, np.uint8)
            ^ np.frombuffer(ks, np.uint8)).tobytes()


def encrypt_bytes(data: bytes, key: str) -> bytes:
    if AESGCM is not None:
        salt = os.urandom(16)
        nonce = os.urandom(12)
        k_enc, _ = _derive(key, salt)
        ct = AESGCM(k_enc).encrypt(nonce, data, _MAGIC_V3)
        return _MAGIC_V3 + salt + nonce + ct
    salt = os.urandom(16)
    nonce = os.urandom(16)
    k_enc, k_mac = _derive(key, salt)
    ct = _xor(data, _keystream(k_enc, nonce, len(data)))
    tag = hmac.new(k_mac, nonce + ct, hashlib.sha256).digest()
    return _MAGIC + salt + nonce + tag + ct


def is_encrypted(blob: bytes) -> bool:
    return blob[:5] in (_MAGIC_V3, _MAGIC, _MAGIC_V1)


def format_of(blob: bytes) -> str:
    """"AZTE3", "AZTE2" or "AZTE1"; raises on a blob of no format."""
    if not is_encrypted(blob):
        raise ValueError("not an AZTE-encrypted blob")
    return blob[:5].decode("ascii")


def _legacy_v1_keystream(k: bytes, nonce: bytes, n: int) -> bytes:
    out = bytearray()
    for counter in range(-(-n // 32)):
        out += hmac.new(k, nonce + counter.to_bytes(8, "big"),
                        hashlib.sha256).digest()
    return bytes(out[:n])


def decrypt_bytes(blob: bytes, key: str) -> bytes:
    if not is_encrypted(blob):
        raise ValueError("not an AZTE-encrypted blob")
    if blob[:5] == _MAGIC_V3:
        if AESGCM is None:
            raise ValueError(
                "blob is AES-GCM encrypted (AZTE3) but the "
                "'cryptography' package is not installed")
        salt = blob[5:21]
        nonce = blob[21:33]
        k_enc, _ = _derive(key, salt)
        from cryptography.exceptions import InvalidTag
        try:
            return AESGCM(k_enc).decrypt(nonce, blob[33:], _MAGIC_V3)
        except InvalidTag:
            raise ValueError("decryption failed: wrong key or corrupted "
                             "file (integrity tag mismatch)")
    v1 = blob[:5] == _MAGIC_V1
    salt = blob[5:21]
    nonce = blob[21:37]
    tag = blob[37:69]
    ct = blob[69:]
    # both formats use the same domain-separated key derivation; only
    # the keystream PRF changed (HMAC-CTR -> SHAKE-256 XOF)
    k_enc, k_mac = _derive(key, salt)
    ks = (_legacy_v1_keystream(k_enc, nonce, len(ct)) if v1
          else _keystream(k_enc, nonce, len(ct)))
    expect = hmac.new(k_mac, nonce + ct, hashlib.sha256).digest()
    if not hmac.compare_digest(tag, expect):
        raise ValueError("decryption failed: wrong key or corrupted "
                         "file (integrity tag mismatch)")
    return _xor(ct, ks)


def encrypt_file(path: str, key: str, out_path: str | None = None) -> str:
    out_path = out_path or path + ".enc"
    with open(path, "rb") as f:
        data = f.read()
    with open(out_path, "wb") as f:
        f.write(encrypt_bytes(data, key))
    return out_path


def decrypt_file(path: str, key: str) -> bytes:
    with open(path, "rb") as f:
        return decrypt_bytes(f.read(), key)
