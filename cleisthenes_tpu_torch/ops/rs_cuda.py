"""Reed-Solomon over GF(2^8) on the card: ``CudaErasureCoder``.

The port's counterpart of ``cleisthenes_tpu/ops/rs_xla.py``.  One CUDA
kernel, ``gf256_apply`` (csrc/gf256.cu), computes out[b] = M_b (*) x[b]
over GF(2^8) with log/exp tables, M shared or one per instance, and
carries the three TPU kernels of the codec:

- K1 encode (rs_xla.py:59/:71): M = the full (n, k) systematic matrix,
  whose identity top rows copy the data shards through;
- K2 decode (rs_xla.py:65/:72/:76): M = the inverse of the surviving
  rows, inverted on the host (gf256.gf_mat_inv) and cached per erasure
  pattern as a (k, k) uint8 device tensor;
- K3 ``decode_recheck`` (rs_xla.py:80): decode, re-encode and the
  Merkle forest (ops/sha256_cuda.py) in one call on device tensors,
  returning the data shards and the roots.

A wrapper given CPU tensors runs the plain PyTorch version
(``gf256_apply_plain``: the multiplication table and an XOR fold);
given CUDA tensors it launches the kernel or raises.  Every batch call
goes to the card: the reference's host floor (rs_xla.py:104) and
power-of-two batch buckets (rs_xla.py:186-192) were tuned for a TPU
relay and do not carry over.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from cleisthenes_tpu_torch.csrc import build as _kb
from cleisthenes_tpu_torch.ops import gf256
from cleisthenes_tpu_torch.ops.backend import ErasureCoder, resolve_device
from cleisthenes_tpu_torch.ops.sha256_cuda import (
    FOREST_SITES,
    _build_forest,
    _check_u8,
    _on_cuda,
    build_forest_plain,
)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(exp (512,) u8, log (256,) i16, mul (256*256,) u8) on ``device``."""
    return (
        torch.from_numpy(np.ascontiguousarray(gf256.GF_EXP)).to(device),
        torch.from_numpy(gf256.GF_LOG.astype(np.int16)).to(device),
        torch.from_numpy(gf256.GF_MUL_TABLE.reshape(-1).copy()).to(device),
    )


def _check_apply(mat: torch.Tensor, x: torch.Tensor) -> None:
    _check_u8("gf256_apply x", x, 3)
    if mat.dtype != torch.uint8 or mat.dim() not in (2, 3) or not mat.is_contiguous():
        raise ValueError(
            f"gf256_apply: need a contiguous (m, k) or (B, m, k) uint8 "
            f"matrix, got {mat.dtype} {tuple(mat.shape)}"
        )
    b, k, _ = x.shape
    if mat.shape[-1] != k or (mat.dim() == 3 and mat.shape[0] != b):
        raise ValueError(
            f"gf256_apply: matrix {tuple(mat.shape)} does not fit data "
            f"{tuple(x.shape)}"
        )


def gf256_apply_plain(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[b, r, l] = XOR_j mat_b[r, j] * x[b, j, l] over GF(2^8):
    mat (m, k) or (B, m, k), x (B, k, L) -> (B, m, L) uint8."""
    b, k, l = x.shape
    m = mat.shape[-2]
    mul = _tables(x.device)[2]
    rows = (mat.to(torch.int64) << 8).expand(b, m, k)
    xs = x.to(torch.int64)
    out = torch.zeros((b, m, l), dtype=torch.uint8, device=x.device)
    for j in range(k):
        out ^= mul[rows[:, :, j, None] + xs[:, None, j, :]]
    return out


def _gf256_apply(
    mat: torch.Tensor, x: torch.Tensor, sites: Tuple[str, ...]
) -> torch.Tensor:
    """The kernel wrapper: plain version on CPU tensors, one
    gf256_apply launch (counted under ``sites``) on CUDA tensors."""
    _check_apply(mat, x)
    if not _on_cuda(mat, x):
        return gf256_apply_plain(mat, x)
    b, k, l = x.shape
    m = mat.shape[-2]
    out = torch.empty((b, m, l), dtype=torch.uint8, device=x.device)
    if b == 0 or l == 0:
        return out
    exp_t, log_t, _ = _tables(x.device)
    lib = _kb.load("gf256")
    with torch.cuda.device(x.device):
        rc = lib.gf256_apply(
            mat.data_ptr(), m * k if mat.dim() == 3 else 0,
            exp_t.data_ptr(), log_t.data_ptr(), x.data_ptr(), out.data_ptr(),
            b, m, k, l, _kb.stream_of(x),
        )
    _kb.check(rc, "gf256_apply")
    _kb.COUNTS.add("gf256_apply", sites)
    return out


def rs_encode(enc_mat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """K1: (n, k) systematic matrix, (B, k, L) data -> (B, n, L) shards."""
    return _gf256_apply(enc_mat, data, ("rs_encode",))


def rs_decode(dec_mat: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """K2: (k, k) shared or (B, k, k) per-instance inverse, (B, k, L)
    surviving shards -> (B, k, L) data."""
    return _gf256_apply(dec_mat, shards, ("rs_decode",))


def decode_recheck(
    dec_mat: torch.Tensor, enc_mat: torch.Tensor, shards: torch.Tensor
):
    """K3: decode, re-encode the full shard set and hash its Merkle
    forest, all on the tensors' device with no host round-trip.
    Returns (data (B, k, L), roots (B, 32))."""
    data = _gf256_apply(dec_mat, shards, ("rs_decode", "decode_recheck"))
    full = _gf256_apply(enc_mat, data, ("rs_encode", "decode_recheck"))
    if _on_cuda(full):
        forest = _build_forest(full, FOREST_SITES + ("decode_recheck",))
    else:
        forest = build_forest_plain(full)
    return data, forest[:, -1]


def decode_recheck_plain(
    dec_mat: torch.Tensor, enc_mat: torch.Tensor, shards: torch.Tensor
):
    """The plain version of ``decode_recheck`` on any device."""
    data = gf256_apply_plain(dec_mat, shards)
    forest = build_forest_plain(gf256_apply_plain(enc_mat, data))
    return data, forest[:, -1]


class CudaErasureCoder(ErasureCoder):
    """numpy-in/numpy-out codec whose every batch runs on ``device``."""

    def __init__(self, n: int, k: int, device="cuda"):
        super().__init__(n, k)
        self.device = resolve_device(device)
        self.matrix = gf256.systematic_rs_matrix(n, k)
        self._enc = self._put(self.matrix)
        # per-instance cache (a class-level cache would pin instances)
        self._decode_matrix = functools.lru_cache(maxsize=512)(
            self._decode_matrix_impl
        )

    def _decode_matrix_impl(self, indices: tuple) -> torch.Tensor:
        inv = gf256.gf_mat_inv(self.matrix[list(indices)])
        return self._put(inv)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)).to(
            self.device
        )

    def _decode_mats(self, indices: np.ndarray) -> torch.Tensor:
        """(k, k) when every instance lost the same shards (the common
        case), else the (B, k, k) stack."""
        patterns = [self._normalize_indices(ix) for ix in indices]
        if not patterns:
            raise ValueError("empty batch")
        if len(set(patterns)) == 1:
            return self._decode_matrix(patterns[0])
        return torch.stack([self._decode_matrix(p) for p in patterns])

    def encode(self, data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.ndim != 2 or data.shape[0] != self.k:
            raise ValueError(f"expected (k={self.k}, L) data, got {data.shape}")
        return self.encode_batch(data[None])[0]

    def _decode_impl(self, indices: tuple, shards: np.ndarray) -> np.ndarray:
        out = rs_decode(self._decode_matrix(indices), self._put(shards[None]))
        return out[0].cpu().numpy()

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.ndim != 3 or data.shape[1] != self.k:
            raise ValueError(f"expected (B, k={self.k}, L) data, got {data.shape}")
        return rs_encode(self._enc, self._put(data)).cpu().numpy()

    def decode_batch(self, indices: np.ndarray, shards: np.ndarray) -> np.ndarray:
        return rs_decode(self._decode_mats(indices), self._put(shards)).cpu().numpy()

    def decode_recheck_batch(self, indices: np.ndarray, shards: np.ndarray):
        """K3 over a batch: (data (B, k, L), roots (B, 32)) as numpy."""
        data, roots = decode_recheck(
            self._decode_mats(indices), self._enc, self._put(shards)
        )
        return data.cpu().numpy(), roots.cpu().numpy()


__all__ = [
    "CudaErasureCoder",
    "decode_recheck",
    "decode_recheck_plain",
    "gf256_apply_plain",
    "rs_decode",
    "rs_encode",
]
