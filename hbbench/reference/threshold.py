"""The group, the trusted dealer, the common coin and threshold decryption,
in Python integers.

A group is the order-q subgroup of quadratic residues of Z_p*, p = 2q + 1
a safe prime, generated by g; a configuration names p and g
(``configs/<config>.json``).  The dealer draws the secret and the Shamir
coefficients from SHA-256("dealer|<seed>|<counter>"), 8 bytes wider than
the group so the reduction mod q is unbiased; the decryption key uses the
roster's seed, the coin's key the seed plus one.  The reference holds the
dealt secrets, so it works out a coin as H2G(id)^s and a decryption key as
c1^s without combining shares: the value every honest set of f + 1 shares
combines to.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Group:
    p: int
    g: int

    @property
    def q(self) -> int:
        return (self.p - 1) // 2

    @property
    def nbytes(self) -> int:
        return (self.p.bit_length() + 7) // 8

    def element(self, x: int) -> bytes:
        return x.to_bytes(self.nbytes, "big")


@dataclasses.dataclass(frozen=True)
class Dealt:
    """One dealt key set: the secret, its n shares (x = 1..n), the master
    public key g^s and the verification keys g^s_i."""

    secret: int
    shares: Tuple[int, ...]
    master: int
    verification_keys: Tuple[int, ...]


def deal(grp: Group, n: int, threshold: int, seed: int) -> Dealt:
    counter = 0

    def draw(width: int) -> int:
        nonlocal counter
        out = b""
        while len(out) < width:
            counter += 1
            out += hashlib.sha256(b"dealer|%d|%d" % (seed, counter)).digest()
        return int.from_bytes(out[:width], "big") % grp.q

    secret = draw(grp.nbytes + 8)
    width = max(32, (grp.q.bit_length() + 7) // 8 + 8)
    coeffs = [secret] + [draw(width) for _ in range(threshold - 1)]
    shares = []
    for x in range(1, n + 1):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % grp.q
        shares.append(acc)
    return Dealt(
        secret=secret,
        shares=tuple(shares),
        master=pow(grp.g, secret, grp.p),
        verification_keys=tuple(pow(grp.g, s, grp.p) for s in shares),
    )


def hash_to_int(*parts: bytes) -> int:
    h = hashlib.sha256(b"".join(len(p).to_bytes(4, "big") + p for p in parts))
    return int.from_bytes(h.digest(), "big")


def hash_to_group(grp: Group, data: bytes) -> int:
    x = hash_to_int(b"h2g", data) % grp.p
    return pow(x or 1, 2, grp.p)


def coin_id(epoch: int, proposer: str, rnd: int) -> bytes:
    return b"%d|%s|%d" % (epoch, proposer.encode(), rnd)


def coin_toss(grp: Group, coin_secret: int, cid: bytes) -> bool:
    """The coin of ``cid``: the low bit of SHA-256("coinval|" || id || x^s),
    x = H2G("coin|" || id)."""
    sigma = pow(hash_to_group(grp, b"coin|" + cid), coin_secret, grp.p)
    value = hashlib.sha256(b"coinval|" + cid + grp.element(sigma)).digest()
    return bool(value[-1] & 1)


def keystream(key: bytes, length: int) -> bytes:
    blocks = [
        hashlib.sha256(key + i.to_bytes(4, "big") + b"ks").digest()
        for i in range((length + 31) // 32)
    ]
    return b"".join(blocks)[:length]


def decrypt(grp: Group, secret: int, c1: int, c2: bytes, tag: bytes) -> bytes:
    """Hashed-ElGamal decryption with the dealt secret: key =
    SHA-256("kem" || c1^s); the tag is HMAC-SHA-256(key, c1 || c2).  Raises
    ValueError when the tag does not check."""
    key = hashlib.sha256(b"kem" + grp.element(pow(c1, secret, grp.p))).digest()
    want = hmac.new(key, grp.element(c1) + c2, hashlib.sha256).digest()
    if not hmac.compare_digest(want, tag):
        raise ValueError("ciphertext tag does not check under the dealt key")
    stream = keystream(key, len(c2))
    return (int.from_bytes(c2, "big") ^ int.from_bytes(stream, "big")).to_bytes(len(c2), "big")
