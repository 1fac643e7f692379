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

A group wider than 256 bits makes each of those powers costly in Python
(about 30 ms at 2,048 bits), so ``pows`` can spread a list of them over
worker processes: they stay Python integers, worked out by ``pow``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import pickle
import subprocess
import sys
from typing import Iterable, List, Optional, Tuple


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


# a worker: pickled (b, e, p) jobs on stdin, their powers pickled on stdout
_WORKER = "import pickle, sys; pickle.dump([pow(*j) for j in pickle.load(sys.stdin.buffer)], sys.stdout.buffer)"


def pows(pairs: Iterable[Tuple[int, int]], p: int, workers: int = 1) -> List[int]:
    """[b^e mod p] for (b, e) in ``pairs``; over ``workers`` Python
    processes of their own when more than one, each given an equal run of
    the pairs, all waited for."""
    jobs = [(b, e, p) for b, e in pairs]
    if workers <= 1 or len(jobs) < 2:
        return [pow(*job) for job in jobs]
    step = -(-len(jobs) // workers)
    procs = [subprocess.Popen([sys.executable, "-I", "-c", _WORKER], stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE) for _ in range(0, len(jobs), step)]
    for i, proc in enumerate(procs):  # each reads all its input before it writes
        proc.stdin.write(pickle.dumps(jobs[i * step : (i + 1) * step]))
        proc.stdin.close()
    out: List[int] = []
    for proc in procs:
        out += pickle.load(proc.stdout)
        proc.stdout.close()
        if proc.wait() != 0:
            raise RuntimeError(f"a power worker exited with {proc.returncode}")
    return out


def deal(grp: Group, n: int, threshold: int, seed: int, workers: int = 1) -> Dealt:
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
    public = pows([(grp.g, secret)] + [(grp.g, s) for s in shares], grp.p, workers)
    return Dealt(
        secret=secret,
        shares=tuple(shares),
        master=public[0],
        verification_keys=tuple(public[1:]),
    )


def hash_to_int(*parts: bytes) -> int:
    h = hashlib.sha256(b"".join(len(p).to_bytes(4, "big") + p for p in parts))
    return int.from_bytes(h.digest(), "big")


def hash_to_group(grp: Group, data: bytes) -> int:
    x = hash_to_int(b"h2g", data) % grp.p
    return pow(x or 1, 2, grp.p)


def coin_id(epoch: int, proposer: str, rnd: int) -> bytes:
    return b"%d|%s|%d" % (epoch, proposer.encode(), rnd)


def coin_base(grp: Group, cid: bytes) -> int:
    return hash_to_group(grp, b"coin|" + cid)


def coin_toss(grp: Group, coin_secret: int, cid: bytes, sigma: Optional[int] = None) -> bool:
    """The coin of ``cid``: the low bit of SHA-256("coinval|" || id || x^s),
    x = H2G("coin|" || id); ``sigma``, when given, is x^s."""
    if sigma is None:
        sigma = pow(coin_base(grp, cid), coin_secret, grp.p)
    value = hashlib.sha256(b"coinval|" + cid + grp.element(sigma)).digest()
    return bool(value[-1] & 1)


def keystream(key: bytes, length: int) -> bytes:
    blocks = [
        hashlib.sha256(key + i.to_bytes(4, "big") + b"ks").digest()
        for i in range((length + 31) // 32)
    ]
    return b"".join(blocks)[:length]


def decrypt(grp: Group, secret: int, c1: int, c2: bytes, tag: bytes,
            shared: Optional[int] = None) -> bytes:
    """Hashed-ElGamal decryption with the dealt secret: key =
    SHA-256("kem" || c1^s); the tag is HMAC-SHA-256(key, c1 || c2).
    ``shared``, when given, is c1^s.  Raises ValueError when the tag does
    not check."""
    if shared is None:
        shared = pow(c1, secret, grp.p)
    key = hashlib.sha256(b"kem" + grp.element(shared)).digest()
    want = hmac.new(key, grp.element(c1) + c2, hashlib.sha256).digest()
    if not hmac.compare_digest(want, tag):
        raise ValueError("ciphertext tag does not check under the dealt key")
    stream = keystream(key, len(c2))
    return (int.from_bytes(c2, "big") ^ int.from_bytes(stream, "big")).to_bytes(len(c2), "big")
