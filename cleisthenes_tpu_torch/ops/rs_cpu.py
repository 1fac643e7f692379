"""CPU reference Reed-Solomon codec (numpy table lookups).

The correctness anchor for the TPU codec, standing in for the
reference's klauspost/reedsolomon SIMD dependency (reference go.mod:10)
until the native C++ backend supersedes it for speed.
"""

from __future__ import annotations

import functools

import numpy as np

from cleisthenes_tpu_torch.ops import gf256
from cleisthenes_tpu_torch.ops.backend import ErasureCoder


class CpuErasureCoder(ErasureCoder):
    def __init__(self, n: int, k: int):
        super().__init__(n, k)
        self.matrix = gf256.systematic_rs_matrix(n, k)
        # Per-instance cache of decode matrices by erasure pattern
        # (class-level lru_cache would pin instances alive forever).
        self._decode_matrix = functools.lru_cache(maxsize=512)(
            self._decode_matrix_impl
        )

    def encode(self, data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        assert data.ndim == 2 and data.shape[0] == self.k, data.shape
        if self.n == self.k:
            return data.copy()
        parity = gf256.gf_matmul(self.matrix[self.k :], data)
        return np.concatenate([data, parity], axis=0)

    def _decode_matrix_impl(self, indices: tuple) -> np.ndarray:
        return gf256.gf_mat_inv(self.matrix[list(indices)])

    def _decode_impl(self, indices: tuple, shards: np.ndarray) -> np.ndarray:
        return gf256.gf_matmul(self._decode_matrix(indices), shards)
