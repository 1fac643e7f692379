"""GF(2^8) arithmetic and the bit-linear lifting used by the TPU codec.

The field is GF(2^8) with the standard Reed-Solomon reduction
polynomial x^8+x^4+x^3+x^2+1 (0x11d) and generator alpha=2 — the same
field the reference's codec dependency uses (klauspost/reedsolomon,
reference go.mod:10).

Two representations live here:

1. Classic exp/log tables for scalar/numpy CPU math.
2. The *bit-matrix lifting*: multiplication by a constant c is a
   GF(2)-linear map on the 8 bits of the operand, y_bits = M_c @ x_bits
   (mod 2).  Lifting every entry of a GF matrix A (m x k) to its 8x8
   bit-matrix yields a (8m x 8k) 0/1 matrix G with
   (A (*) X)_bits = G @ X_bits (mod 2) — which turns the whole RS
   encode/decode into ONE dense matmul that the TPU MXU executes in
   bf16 with exact f32 accumulation (sums of 0/1 terms stay well under
   2^24).  This is the TPU-native analogue of the AVX2 nibble-table
   trick in the reference's dependency.
"""

from __future__ import annotations

import functools

import numpy as np

_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1

# ---------------------------------------------------------------------------
# Table construction (module-load time; a few microseconds)
# ---------------------------------------------------------------------------


def _build_tables():
    exp = np.zeros(512, dtype=np.uint8)  # doubled to skip the mod-255
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[0:255]
    return exp, log


GF_EXP, GF_LOG = _build_tables()

# Full 256x256 multiplication table: 64 KiB, used by the numpy CPU codec.
_a = np.arange(256)
_la = GF_LOG[_a][:, None] + GF_LOG[_a][None, :]
GF_MUL_TABLE = GF_EXP[_la].astype(np.uint8)
GF_MUL_TABLE[0, :] = 0
GF_MUL_TABLE[:, 0] = 0


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[GF_LOG[a] + GF_LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(GF_EXP[255 - GF_LOG[a]])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % 255])


# ---------------------------------------------------------------------------
# Matrix math over GF(2^8) (numpy, host-side; all matrices are tiny:
# at N=128 the largest is 84x44)
# ---------------------------------------------------------------------------


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(m,k) x (k,n) matrix product over GF(2^8)."""
    m, k = a.shape
    k2, n = b.shape
    assert k == k2
    out = np.zeros((m, n), dtype=np.uint8)
    for i in range(k):
        out ^= GF_MUL_TABLE[a[:, i]][:, b[i, :]]
    return out


def gf_mat_inv(a: np.ndarray) -> np.ndarray:
    """Invert a (k,k) GF(2^8) matrix by Gauss-Jordan elimination.

    Used per-decode to build the reconstruction matrix from the
    surviving shard rows (reference rbc/rbc.go:88-90 `interpolate`);
    O(k^3) table lookups on host — microseconds at k<=64.
    """
    k = a.shape[0]
    aug = np.concatenate([a.astype(np.uint8), np.eye(k, dtype=np.uint8)], axis=1)
    for col in range(k):
        pivot = None
        for row in range(col, k):
            if aug[row, col]:
                pivot = row
                break
        if pivot is None:
            raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv_p = gf_inv(int(aug[col, col]))
        aug[col] = GF_MUL_TABLE[inv_p][aug[col]]
        factors = aug[:, col].copy()
        factors[col] = 0
        nz = np.nonzero(factors)[0]
        if nz.size:
            # aug[r] ^= factors[r] * aug[col] for every row with a
            # nonzero entry in this column, vectorized via the table.
            aug[nz] ^= GF_MUL_TABLE[factors[nz]][:, aug[col]]
    return aug[:, k:]


def systematic_rs_matrix(n: int, k: int) -> np.ndarray:
    """Build the (n,k) systematic RS generator matrix.

    Vandermonde V[i,j] = x_i^j with distinct points x_i = i, normalised
    so the top k rows are the identity: A = V @ inv(V[:k]).  Any k rows
    of A are invertible, so any k of the n shards reconstruct the data
    (docs/RBC-EN.md:17, "even if a maximum of k data is lost").
    """
    assert 1 <= k <= n <= 256
    v = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        for j in range(k):
            v[i, j] = gf_pow(i, j)
    a = gf_matmul(v, gf_mat_inv(v[:k]))
    assert np.array_equal(a[:k], np.eye(k, dtype=np.uint8))
    return a


# ---------------------------------------------------------------------------
# Bit-matrix lifting
# ---------------------------------------------------------------------------


@functools.cache
def _bitmat_table() -> np.ndarray:
    """(256, 8, 8) uint8: BITMAT[c] is M_c with y_bits = M_c @ x_bits.

    Column j of M_c holds the bits (LSB-first) of c * x^j, i.e. of
    gf_mul(c, 1 << j).
    """
    t = np.zeros((256, 8, 8), dtype=np.uint8)
    for c in range(256):
        for j in range(8):
            prod = gf_mul(c, 1 << j)
            for r in range(8):
                t[c, r, j] = (prod >> r) & 1
    return t


def lift_to_bits(a: np.ndarray) -> np.ndarray:
    """Lift a GF(2^8) matrix (m,k) to its (8m, 8k) 0/1 bit-matrix G.

    G[i*8+r, j*8+c] = M_{a[i,j]}[r, c]; then for byte matrices X,
    bits(A (*) X) = G @ bits(X) mod 2.
    """
    m, k = a.shape
    g = _bitmat_table()[a]  # (m, k, 8, 8)
    return g.transpose(0, 2, 1, 3).reshape(8 * m, 8 * k)
