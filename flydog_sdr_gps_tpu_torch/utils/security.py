"""Auth/security primitives — the `support/security.cpp` analogue.

The reference ships three mechanisms (`support/security.cpp:1-190`):
- a random 256-bit authkey handed to authenticated admins
  ("SET get_authkey", `rx/rx_cmd.cpp:2149-2160`), used by the
  kiwisdr.com proxy path to prove control of the receiver;
- salted one-way password hashing for stored admin credentials
  (`kiwi_crypt_generate`, crypt(3) SHA-512 with a 16-char salt and a
  write sequence number);
- HMAC-signed time-limited tokens for the proxy handshake.

Equivalents here (stdlib only, no crypt(3) dependency):
- :func:`generate_authkey` — 256-bit random hex;
- :func:`hash_password` / :func:`verify_password` — PBKDF2-HMAC-SHA256
  with a 16-byte salt and explicit iteration count, serialized as
  ``$p5$<iters>$<salt_hex>$<hash_hex>`` so hashed values can live in
  the JSON config exactly like the reference's crypt files;
- :func:`make_token` / :func:`check_token` — HMAC-SHA256 over a
  timestamp with a validity window and constant-time comparison.
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
import time

_SCHEME = "p5"
_DEF_ITERS = 50_000


def generate_authkey() -> str:
    """256-bit random hex (the `kiwi_authkey()` analogue)."""
    return secrets.token_hex(32)


def hash_password(password: str, iters: int = _DEF_ITERS) -> str:
    """One-way salted hash for config storage."""
    salt = secrets.token_bytes(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iters)
    return f"${_SCHEME}${iters}${salt.hex()}${dk.hex()}"


def is_hashed(value: str) -> bool:
    return value.startswith(f"${_SCHEME}$")


def verify_password(password: str, stored: str) -> bool:
    """Check ``password`` against a stored value.

    ``stored`` may be a ``$p5$`` hash or a legacy plaintext value
    (the reference likewise migrates plaintext configs forward).
    """
    if not is_hashed(stored):
        return hmac.compare_digest(password, stored)
    try:
        _, _, iters_s, salt_hex, hash_hex = stored.split("$")
        dk = hashlib.pbkdf2_hmac("sha256", password.encode(),
                                 bytes.fromhex(salt_hex), int(iters_s))
        return hmac.compare_digest(dk.hex(), hash_hex)
    except (ValueError, TypeError):
        return False


def make_token(secret: str, t: float | None = None) -> str:
    """Time-limited HMAC-SHA256 token ``<ts>.<mac>``."""
    ts = str(int(time.time() if t is None else t))
    mac = hmac.new(secret.encode(), ts.encode(),
                   hashlib.sha256).hexdigest()
    return f"{ts}.{mac}"


def check_token(secret: str, token: str, window_s: float = 30.0,
                now: float | None = None) -> bool:
    """Verify a :func:`make_token` token within ``window_s`` seconds."""
    try:
        ts_s, mac = token.split(".", 1)
        ts = int(ts_s)
    except (ValueError, AttributeError):
        return False
    now = time.time() if now is None else now
    if not (-5.0 <= now - ts <= window_s):
        return False
    want = hmac.new(secret.encode(), ts_s.encode(),
                    hashlib.sha256).hexdigest()
    return hmac.compare_digest(want, mac)
