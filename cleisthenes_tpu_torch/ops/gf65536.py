"""GF(2^16) arithmetic and 16-bit lifting: rosters past 256 validators.

The port's copy of ``cleisthenes_tpu/ops/gf65536.py``.  GF(2^8) admits
at most 256 distinct shard indices, so an N=512 roster needs the same
systematic Reed-Solomon construction one field up: GF(2^16) with the
reduction polynomial x^16 + x^12 + x^3 + x + 1 (0x1100B) and generator
alpha=2, supporting up to 65536 shard indices.

Two representations live here, as in ops/gf256.py:

1. exp/log tables (512 KiB + 256 KiB) for host math and for the plain
   PyTorch version of the CUDA codec (ops/rs16_cuda.py) — the full
   2^16 x 2^16 product table would be 4 GiB, so vectorized
   multiplication goes through exp[log a + log b] with zero masking.
2. The bit-matrix lifting the TPU codec runs on its matrix unit: an
   (m, k) GF(2^16) matrix lifts to a (16m, 16k) 0/1 matrix over
   bit-planes.  The card's kernel (csrc/gf65536.cu) multiplies the same
   lifted matrix on its binary tensor cores, lifting in shared memory;
   ``lift_to_bits`` here is the reference's form, for the parity tests.

Symbols are uint16; shard byte rows of even length L view as L/2
symbols little-endian (ops/rs16.py handles the byte<->symbol view).
"""

from __future__ import annotations

import numpy as np

_POLY = 0x1100B  # x^16 + x^12 + x^3 + x + 1
ORDER = 1 << 16
E = 16


def _build_tables():
    exp = np.zeros(2 * (ORDER - 1), dtype=np.uint16)
    log = np.zeros(ORDER, dtype=np.int32)
    x = 1
    for i in range(ORDER - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & ORDER:
            x ^= _POLY
    exp[ORDER - 1 :] = exp[: ORDER - 1]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[GF_LOG[a] + GF_LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(GF_EXP[(ORDER - 1) - GF_LOG[a]])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    # Multiply in Python ints: GF_LOG is int32 and GF_LOG[a] * n wraps
    # silently for n >~ 32768 at this field's index scale.
    return int(GF_EXP[(int(GF_LOG[a]) * n) % (ORDER - 1)])


def gf_mul_vec(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise product of uint16 arrays (broadcasting ok)."""
    a = np.asarray(a, dtype=np.uint16)
    b = np.asarray(b, dtype=np.uint16)
    out = GF_EXP[GF_LOG[a] + GF_LOG[b]].astype(np.uint16)
    return np.where((a == 0) | (b == 0), np.uint16(0), out)


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(m,k) x (k,n) matrix product over GF(2^16)."""
    m, k = a.shape
    k2, n = b.shape
    assert k == k2
    out = np.zeros((m, n), dtype=np.uint16)
    for i in range(k):
        out ^= gf_mul_vec(a[:, i : i + 1], b[i : i + 1, :])
    return out


def gf_mat_inv(a: np.ndarray) -> np.ndarray:
    """Invert a (k,k) GF(2^16) matrix by Gauss-Jordan elimination
    (same shape of algorithm as gf256.gf_mat_inv)."""
    k = a.shape[0]
    aug = np.concatenate(
        [a.astype(np.uint16), np.eye(k, dtype=np.uint16)], axis=1
    )
    for col in range(k):
        pivot = None
        for row in range(col, k):
            if aug[row, col]:
                pivot = row
                break
        if pivot is None:
            raise np.linalg.LinAlgError("singular GF(2^16) matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv_p = gf_inv(int(aug[col, col]))
        aug[col] = gf_mul_vec(np.uint16(inv_p), aug[col])
        factors = aug[:, col].copy()
        factors[col] = 0
        nz = np.nonzero(factors)[0]
        if nz.size:
            aug[nz] ^= gf_mul_vec(factors[nz][:, None], aug[col][None, :])
    return aug[:, k:]


def systematic_rs_matrix(n: int, k: int) -> np.ndarray:
    """(n,k) systematic RS generator over GF(2^16): Vandermonde at
    distinct points x_i = i, normalised so the top k rows are the
    identity (any k rows invertible — docs/RBC-EN.md:17)."""
    assert 1 <= k <= n <= ORDER
    i_col = np.arange(n, dtype=np.int64)
    v = np.zeros((n, k), dtype=np.uint16)
    v[:, 0] = 1
    for j in range(1, k):
        v[:, j] = gf_mul_vec(v[:, j - 1], i_col.astype(np.uint16))
    a = gf_matmul(v, gf_mat_inv(v[:k]))
    assert np.array_equal(a[:k], np.eye(k, dtype=np.uint16))
    return a


# ---------------------------------------------------------------------------
# Bit-matrix lifting (the 2^16-entry analogue of gf256._bitmat_table is
# 16 MiB and touched sparsely, so lifting computes per-matrix instead)
# ---------------------------------------------------------------------------


def lift_to_bits(a: np.ndarray) -> np.ndarray:
    """Lift a GF(2^16) matrix (m,k) to its (16m, 16k) 0/1 bit-matrix.

    Column j of the 16x16 block for constant c holds the bits
    (LSB-first) of c * x^j."""
    m, k = a.shape
    # prods[i, j, col] = a[i,j] * 2^col  — vectorized exp/log multiply
    pow2 = (np.uint16(1) << np.arange(E, dtype=np.uint16))
    prods = gf_mul_vec(a[:, :, None], pow2[None, None, :])  # (m,k,16)
    bits = (
        (prods[:, :, None, :] >> np.arange(E, dtype=np.uint16)[None, None, :, None])
        & 1
    ).astype(np.uint8)  # (m, k, 16 rows, 16 cols)
    return bits.transpose(0, 2, 1, 3).reshape(E * m, E * k)


def symbols_to_bits(x: np.ndarray) -> np.ndarray:
    """(r, S) uint16 -> (16r, S) uint8 bit-planes, LSB-first."""
    r, s = x.shape
    bits = (
        (x[:, None, :] >> np.arange(E, dtype=np.uint16)[None, :, None]) & 1
    ).astype(np.uint8)
    return bits.reshape(E * r, s)


def bits_to_symbols(bits: np.ndarray) -> np.ndarray:
    """(16r, S) 0/1 -> (r, S) uint16, inverse of symbols_to_bits."""
    r16, s = bits.shape
    b = bits.reshape(r16 // E, E, s).astype(np.uint32)
    weights = (1 << np.arange(E, dtype=np.uint32))[None, :, None]
    return (b * weights).sum(axis=1).astype(np.uint16)


__all__ = [
    "E",
    "ORDER",
    "GF_EXP",
    "GF_LOG",
    "gf_mul",
    "gf_inv",
    "gf_pow",
    "gf_mul_vec",
    "gf_matmul",
    "gf_mat_inv",
    "systematic_rs_matrix",
    "lift_to_bits",
    "symbols_to_bits",
    "bits_to_symbols",
]
