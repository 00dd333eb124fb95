"""Account keys, addresses, signing: pure-Python secp256k1.

Copied from celestia_app_tpu/chain/crypto.py. Reference parity:
cosmos-sdk secp256k1 account keys — ECDSA with SHA-256 and deterministic
RFC 6979 nonces, emitting 64-byte low-S (r || s) signatures. Addresses
are the first 20 bytes of SHA-256(compressed pubkey), as in the JAX
package.

The JAX package signs and verifies through OpenSSL (the `cryptography`
package) where it imports, and through this pure-Python path otherwise;
both give byte-identical signatures, because RFC 6979 is deterministic.
The port carries the pure-Python path only, so it needs no
`cryptography`. The batched verifier on the card is
ops/secp256k1.verify_batch; `_py_verify` is its per-lane reference.

Counters (the JAX package's telemetry names): `crypto.verify_errors`
(per call) and `crypto.verify_errors_unique` (per memoized triple).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import hmac

ADDRESS_LEN = 20
# secp256k1 domain parameters (SEC 2): y^2 = x^3 + 7 over F_p.
_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

counters = {"crypto.verify_errors": 0, "crypto.verify_errors_unique": 0}


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


# Jacobian coordinates: one modular inverse per scalar multiplication
# instead of one per point add.


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _jac_double(p):
    x, y, z = p
    if not y:
        return (0, 0, 0)
    ysq = y * y % _P
    s = 4 * x * ysq % _P
    m = 3 * x * x % _P  # a = 0 for secp256k1
    nx = (m * m - 2 * s) % _P
    ny = (m * (s - nx) - 8 * ysq * ysq) % _P
    nz = 2 * y * z % _P
    return (nx, ny, nz)


def _jac_add(p, q):
    if not p[1]:
        return q
    if not q[1]:
        return p
    u1 = p[0] * q[2] * q[2] % _P
    u2 = q[0] * p[2] * p[2] % _P
    s1 = p[1] * q[2] ** 3 % _P
    s2 = q[1] * p[2] ** 3 % _P
    if u1 == u2:
        if s1 != s2:
            return (0, 0, 0)  # P + (-P)
        return _jac_double(p)
    h = (u2 - u1) % _P
    r = (s2 - s1) % _P
    h2 = h * h % _P
    h3 = h * h2 % _P
    u1h2 = u1 * h2 % _P
    nx = (r * r - h3 - 2 * u1h2) % _P
    ny = (r * (u1h2 - nx) - s1 * h3) % _P
    nz = h * p[2] * q[2] % _P
    return (nx, ny, nz)


def _jac_mult(p, d: int):
    r = (0, 0, 0)
    a = p
    while d:
        if d & 1:
            r = _jac_add(r, a)
        a = _jac_double(a)
        d >>= 1
    return r


def _to_affine(p):
    if not p[1]:
        return None  # point at infinity
    zinv = _inv(p[2], _P)
    z2 = zinv * zinv % _P
    return (p[0] * z2 % _P, p[1] * z2 * zinv % _P)


_G = (_GX, _GY, 1)


@functools.lru_cache(maxsize=8192)
def _decompress(compressed: bytes):
    """(x, y) from a 33-byte SEC1 compressed point; None if invalid.

    LRU-cached on the compressed encoding: repeat senders skip the
    modular square root, invalid encodings cache as None, and the bound
    keeps an adversary from growing the table."""
    if len(compressed) != 33 or compressed[0] not in (2, 3):
        return None
    x = int.from_bytes(compressed[1:], "big")
    if x >= _P:
        return None
    y2 = (pow(x, 3, _P) + 7) % _P
    y = pow(y2, (_P + 1) // 4, _P)  # p ≡ 3 (mod 4)
    if y * y % _P != y2:
        return None  # x is not on the curve
    if (y & 1) != (compressed[0] & 1):
        y = _P - y
    return (x, y)


def _compress(x: int, y: int) -> bytes:
    return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")


def _rfc6979_k(x: int, h1: bytes) -> int:
    """RFC 6979 §3.2 deterministic nonce (HMAC-SHA256, qlen = hlen = 256),
    bit for bit what OpenSSL's deterministic signing does."""
    xb = x.to_bytes(32, "big")
    hb = (int.from_bytes(h1, "big") % _N).to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + xb + hb, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + xb + hb, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        kand = int.from_bytes(v, "big")
        if 1 <= kand < _N:
            return kand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def _py_sign(x: int, message: bytes) -> bytes:
    z = int.from_bytes(_sha(message), "big") % _N
    h1 = _sha(message)
    while True:
        k = _rfc6979_k(x, h1)
        pt = _to_affine(_jac_mult(_G, k))
        r = pt[0] % _N
        if not r:
            h1 = _sha(h1)  # unreachable in practice; restart nonce stream
            continue
        s = _inv(k, _N) * (z + r * x) % _N
        if not s:
            h1 = _sha(h1)
            continue
        if s > _N // 2:
            s = _N - s
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def _py_verify(compressed: bytes, signature: bytes, message: bytes) -> bool:
    return _py_verify_digest(compressed, signature, _sha(message))


def _py_verify_digest(compressed: bytes, signature: bytes,
                      digest: bytes) -> bool:
    q = _decompress(compressed)
    if q is None:
        return False
    r = int.from_bytes(signature[:32], "big")
    s = int.from_bytes(signature[32:], "big")
    if not (1 <= r < _N and 1 <= s < _N):
        return False
    z = int.from_bytes(digest, "big") % _N
    w = _inv(s, _N)
    u1 = z * w % _N
    u2 = r * w % _N
    pt = _to_affine(_jac_add(_jac_mult(_G, u1),
                             _jac_mult((q[0], q[1], 1), u2)))
    if pt is None:
        return False
    return pt[0] % _N == r


@functools.lru_cache(maxsize=1 << 16)
def _verify_memo(compressed: bytes, signature: bytes,
                 digest: bytes) -> int:
    """The one ECDSA verification body, memoized: 1 valid, 0 invalid, -1
    raised (callers count per call, so a flood of replayed malformed
    triples still shows). Keys hold the 32-byte digest, never message
    bytes, so 65536 entries cannot pin multi-MB sign docs."""
    try:
        return 1 if _py_verify_digest(compressed, signature, digest) else 0
    except Exception:
        counters["crypto.verify_errors_unique"] += 1
        return -1


@dataclasses.dataclass(frozen=True)
class PublicKey:
    compressed: bytes  # 33-byte SEC1 compressed point

    def address(self) -> bytes:
        return _sha(self.compressed)[:ADDRESS_LEN]

    def verify(self, signature: bytes, message: bytes) -> bool:
        """Verify a 64-byte (r || s) signature over sha256(message)."""
        if len(signature) != 64:
            return False
        s = int.from_bytes(signature[32:], "big")
        if s > _N // 2:
            return False  # reject high-S: tx bytes must not be malleable
        code = _verify_memo(self.compressed, signature, _sha(message))
        if code < 0:
            counters["crypto.verify_errors"] += 1
            return False
        return code == 1


@dataclasses.dataclass(frozen=True)
class PrivateKey:
    scalar: int

    @classmethod
    def from_seed(cls, seed: bytes) -> "PrivateKey":
        """Deterministic key derivation from a seed (test fixtures, wallets)."""
        d = int.from_bytes(_sha(b"celestia_tpu/key" + seed), "big") % (_N - 1) + 1
        return cls(d)

    @classmethod
    def generate(cls) -> "PrivateKey":
        import secrets

        # key generation is operator-side entropy, never consensus
        return cls(secrets.randbelow(_N - 1) + 1)

    def public_key(self) -> PublicKey:
        return PublicKey(_public_key_bytes(self.scalar))

    def sign(self, message: bytes) -> bytes:
        """64-byte (r || s) low-S signature over sha256(message),
        deterministic per RFC 6979."""
        return _py_sign(self.scalar, message)


def address_str(addr: bytes) -> str:
    return "tia1" + addr.hex()


@functools.lru_cache(maxsize=4096)
def _public_key_bytes(scalar: int) -> bytes:
    """The compressed public key of a private scalar, cached: signers call
    `public_key()` once per tx, and each is a full scalar multiplication."""
    x, y = _to_affine(_jac_mult(_G, scalar))
    return _compress(x, y)
