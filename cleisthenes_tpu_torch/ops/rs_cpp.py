"""Native C++ Reed-Solomon codec (the 'cpp' backend).

The port's copy of ``cleisthenes_tpu/ops/rs_cpp.py``: the same math as
rs_cpu (systematic Vandermonde over GF(2^8), poly 0x11D) with the hot
matmul running in the compiled host kernel of native/gf256.cpp.  It
raises when the toolchain is missing (no fallback to numpy): callers
that want to degrade check ``native.native_available()`` and pick
'cpu' themselves.
"""

from __future__ import annotations

import functools

import numpy as np

from cleisthenes_tpu_torch.native.build import load_error, load_gf256
from cleisthenes_tpu_torch.ops import gf256
from cleisthenes_tpu_torch.ops.backend import ErasureCoder


class CppErasureCoder(ErasureCoder):
    def __init__(self, n: int, k: int):
        super().__init__(n, k)
        self._lib = load_gf256()
        if self._lib is None:
            raise RuntimeError(
                "native gf256 kernel unavailable (no C++ toolchain?): "
                f"{load_error('gf256')}"
            )
        self.matrix = gf256.systematic_rs_matrix(n, k)
        self._parity = np.ascontiguousarray(self.matrix[k:])
        self._decode_matrix = functools.lru_cache(maxsize=512)(
            self._decode_matrix_impl
        )

    def _apply(self, mat: np.ndarray, data: np.ndarray) -> np.ndarray:
        m = mat.shape[0]
        out = np.empty((m, data.shape[1]), dtype=np.uint8)
        self._lib.gf256_matmul(
            mat.ctypes.data,
            data.ctypes.data,
            out.ctypes.data,
            m,
            mat.shape[1],
            data.shape[1],
        )
        return out

    def encode(self, data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.ndim != 2 or data.shape[0] != self.k:
            raise ValueError(f"expected (k={self.k}, L) data, got {data.shape}")
        if self.n == self.k:
            return data.copy()
        parity = self._apply(self._parity, data)
        return np.concatenate([data, parity], axis=0)

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.ndim != 3 or data.shape[1] != self.k:
            raise ValueError(f"expected (B, k={self.k}, L) data, got {data.shape}")
        if self.n == self.k:
            return data.copy()
        b, _, length = data.shape
        m = self.n - self.k
        parity = np.empty((b, m, length), dtype=np.uint8)
        self._lib.gf256_matmul_batch(
            self._parity.ctypes.data,
            data.ctypes.data,
            parity.ctypes.data,
            b,
            m,
            self.k,
            length,
        )
        return np.concatenate([data, parity], axis=1)

    def _decode_matrix_impl(self, indices: tuple) -> np.ndarray:
        return np.ascontiguousarray(
            gf256.gf_mat_inv(self.matrix[list(indices)])
        )

    def _decode_impl(self, indices: tuple, shards: np.ndarray) -> np.ndarray:
        return self._apply(self._decode_matrix(indices), shards)


__all__ = ["CppErasureCoder"]
