"""Reed-Solomon over GF(2^16): rosters past the 256-shard ceiling.

The port's counterpart of ``cleisthenes_tpu/ops/rs16.py``: the same
systematic construction as the GF(2^8) codec one field up.  Shard byte
rows of even length L are L/2 little-endian uint16 symbols.

- ``Cpu16ErasureCoder``: the host reference (exp/log-table products
  over uint16 symbols), a copy of the reference's.
- ``Cuda16ErasureCoder``: every call, single or batched, runs on
  ``device`` through ops/rs16_cuda.py (K11, csrc/gf65536.cu); its encode
  matrix is checked systematic once, here, so the kernel multiplies the
  parity rows only.  Unlike
  the reference's ``Xla16ErasureCoder`` it sends no single instance and
  no mixed erasure pattern to the host: a mixed batch decodes with one
  (B, k, k) stack of inverses.  It has no fused ``decode_recheck_batch``,
  so ``BatchCrypto.decode_recheck_batch`` runs its 3-step route for it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cleisthenes_tpu_torch.ops import gf65536 as gf
from cleisthenes_tpu_torch.ops.backend import ErasureCoder, resolve_device
from cleisthenes_tpu_torch.ops.rs16_cuda import mark_systematic, rs16_decode, rs16_encode


def _to_symbols(x: np.ndarray) -> np.ndarray:
    """(..., L) uint8, L even -> (..., L/2) uint16 little-endian."""
    x = np.ascontiguousarray(x, dtype=np.uint8)
    if x.shape[-1] % 2:
        raise ValueError(
            f"GF(2^16) shards need even byte length, got L={x.shape[-1]}"
        )
    return x.view("<u2")


def _to_bytes(x: np.ndarray) -> np.ndarray:
    """(..., S) uint16 -> (..., 2S) uint8 little-endian."""
    return np.ascontiguousarray(x, dtype="<u2").view(np.uint8)


class Cpu16ErasureCoder(ErasureCoder):
    """Host reference: exp/log-table matmul over uint16 symbols."""

    MAX_N = gf.ORDER

    def __init__(self, n: int, k: int):
        super().__init__(n, k)
        self.matrix = gf.systematic_rs_matrix(n, k)
        self._decode_matrix = functools.lru_cache(maxsize=512)(
            self._decode_matrix_impl
        )

    def encode(self, data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        assert data.ndim == 2 and data.shape[0] == self.k, data.shape
        if self.n == self.k:
            return data.copy()
        syms = _to_symbols(data)
        parity = gf.gf_matmul(self.matrix[self.k :], syms)
        return np.concatenate([data, _to_bytes(parity)], axis=0)

    def _decode_matrix_impl(self, indices: tuple) -> np.ndarray:
        return gf.gf_mat_inv(self.matrix[list(indices)])

    def _decode_impl(self, indices: tuple, shards: np.ndarray) -> np.ndarray:
        return _to_bytes(
            gf.gf_matmul(self._decode_matrix(indices), _to_symbols(shards))
        )


class Cuda16ErasureCoder(ErasureCoder):
    """numpy-in/numpy-out GF(2^16) codec whose every call runs on
    ``device`` (the plain PyTorch versions on a CPU device)."""

    MAX_N = gf.ORDER

    def __init__(self, n: int, k: int, device="cuda", mesh=None):
        super().__init__(n, k)
        self.device = resolve_device(device)
        self.mesh = mesh  # accepted for factory symmetry, as the
        # reference's Xla16ErasureCoder (rs16.py:77): not sharded
        self.matrix = gf.systematic_rs_matrix(n, k)
        self._enc = self._put(self.matrix)
        mark_systematic(self._enc, self.matrix)
        # per-instance cache (a class-level cache would pin instances)
        self._decode_matrix = functools.lru_cache(maxsize=512)(
            self._decode_matrix_impl
        )

    def _decode_matrix_impl(self, indices: tuple) -> torch.Tensor:
        return self._put(gf.gf_mat_inv(self.matrix[list(indices)]))

    def _put(self, a: np.ndarray) -> torch.Tensor:
        # a fresh array: a symbol view of a size-1 axis may keep an odd
        # byte stride, which torch refuses
        return torch.from_numpy(np.array(a, dtype=np.uint16)).to(self.device)

    def _decode_mats(self, indices: np.ndarray) -> torch.Tensor:
        """(k, k) when every instance lost the same shards (the common
        case), else the (B, k, k) stack."""
        patterns = [self._normalize_indices(ix) for ix in indices]
        if not patterns:
            raise ValueError("empty batch")
        if len(set(patterns)) == 1:
            return self._decode_matrix(patterns[0])
        # stacked as int16: CUDA has no uint16 cat kernel
        return torch.stack(
            [self._decode_matrix(p).view(torch.int16) for p in patterns]
        ).view(torch.uint16)

    def _run(self, fn, mat: torch.Tensor, shards: np.ndarray) -> np.ndarray:
        """(B, r, L) bytes through ``fn(mat, symbols)`` -> (B, m, L) bytes."""
        syms = self._put(_to_symbols(shards))
        return _to_bytes(fn(mat, syms).cpu().numpy())

    def encode(self, data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.ndim != 2 or data.shape[0] != self.k:
            raise ValueError(f"expected (k={self.k}, L) data, got {data.shape}")
        return self.encode_batch(data[None])[0]

    def _decode_impl(self, indices: tuple, shards: np.ndarray) -> np.ndarray:
        return self._run(rs16_decode, self._decode_matrix(indices), shards[None])[0]

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.ndim != 3 or data.shape[1] != self.k:
            raise ValueError(f"expected (B, k={self.k}, L) data, got {data.shape}")
        return self._run(rs16_encode, self._enc, data)

    def decode_batch(self, indices: np.ndarray, shards: np.ndarray) -> np.ndarray:
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        if shards.ndim != 3 or shards.shape[1] != self.k:
            raise ValueError(f"expected (B, k={self.k}, L) shards, got {shards.shape}")
        return self._run(rs16_decode, self._decode_mats(indices), shards)


__all__ = ["Cpu16ErasureCoder", "Cuda16ErasureCoder"]
