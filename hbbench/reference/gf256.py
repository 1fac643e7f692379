"""GF(2^8) and the systematic Reed-Solomon code of RBC, by table lookups.

The field: reduction polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11d),
generator 2.  The code: the Vandermonde matrix V[i, j] = i^j (0^0 = 1)
over the points 0..n-1, times the inverse of its top k rows, so that the
top k rows of the generator are the identity and any k of the n shards
recover the data.
"""

from __future__ import annotations

import functools

import numpy as np

POLY = 0x11D


def _tables():
    exp = [0] * 510
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    for i in range(255, 510):
        exp[i] = exp[i - 255]
    mul = np.zeros((256, 256), dtype=np.uint8)
    for a in range(1, 256):
        for b in range(1, 256):
            mul[a, b] = exp[log[a] + log[b]]
    return exp, log, mul


EXP, LOG, MUL = _tables()


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("no inverse of 0 in GF(2^8)")
    return EXP[255 - LOG[a]]


def power(a: int, e: int) -> int:
    if e == 0:
        return 1
    if a == 0:
        return 0
    return EXP[(LOG[a] * e) % 255]


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(m, k) x (k, L) over GF(2^8): the XOR over k of table products."""
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for j in range(a.shape[1]):
        out ^= MUL[a[:, j]][:, b[j]]
    return out


def mat_inv(a: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a (k, k) matrix over GF(2^8)."""
    k = a.shape[0]
    aug = [list(map(int, row)) + [int(i == r) for i in range(k)] for r, row in enumerate(a)]
    for col in range(k):
        piv = next((r for r in range(col, k) if aug[r][col]), None)
        if piv is None:
            raise ValueError("singular matrix over GF(2^8)")
        aug[col], aug[piv] = aug[piv], aug[col]
        s = inv(aug[col][col])
        aug[col] = [int(MUL[s, v]) for v in aug[col]]
        for r in range(k):
            c = aug[r][col]
            if r != col and c:
                aug[r] = [v ^ int(MUL[c, w]) for v, w in zip(aug[r], aug[col])]
    return np.array([row[k:] for row in aug], dtype=np.uint8)


@functools.lru_cache(maxsize=8)
def generator(n: int, k: int) -> np.ndarray:
    """The (n, k) systematic generator matrix."""
    v = np.array([[power(i, j) for j in range(k)] for i in range(n)], dtype=np.uint8)
    g = matmul(v, mat_inv(v[:k]))
    if not np.array_equal(g[:k], np.eye(k, dtype=np.uint8)):
        raise AssertionError("generator is not systematic")
    g.setflags(write=False)
    return g


def encode(data: np.ndarray, n: int) -> np.ndarray:
    """(B, k, L) data shards -> (B, n, L) data and parity shards."""
    b, k, length = data.shape
    g = generator(n, k)
    parity = np.zeros((b, n - k, length), dtype=np.uint8)
    for j in range(k):
        parity ^= MUL[g[k:, j]][:, data[:, j, :]].transpose(1, 0, 2)
    return np.concatenate([data, parity], axis=1)

