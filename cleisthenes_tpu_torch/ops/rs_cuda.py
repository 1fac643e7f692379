"""Reed-Solomon over GF(2^8) on the card: ``CudaErasureCoder``.

The port's counterpart of ``cleisthenes_tpu/ops/rs_xla.py``.  One CUDA
kernel, ``gf256_apply`` (csrc/gf256.cu), computes out[b] = M_b (*) x[b]
over GF(2^8) as the reference does, as a GF(2) product of the lifted
(8m, 8k) 0/1 matrix with the bytes' bits, on the binary tensor cores;
M shared or one per instance.  It carries the three TPU kernels of the
codec:

- K1 encode (rs_xla.py:59/:71): given the (n, k) systematic matrix, the
  kernel multiplies its n - k parity rows and copies the data shards
  into rows [0, k).  The matrix's identity top is checked on the host
  once per matrix (``mark_systematic``, called where the codec builds
  it), never per call, and an encode given a matrix it did not check
  raises;
- K2 decode (rs_xla.py:65/:72/:76): M = the inverse of the surviving
  rows, inverted on the host (gf256.gf_mat_inv) and cached per erasure
  pattern as a (k, k) uint8 device tensor;
- K3 ``decode_recheck`` (rs_xla.py:80): decode, re-encode and the
  Merkle forest (ops/sha256_cuda.py) in one call on device tensors,
  returning the data shards and the roots.

A wrapper given CPU tensors runs the plain PyTorch version
(``gf256_apply_plain``: the multiplication table and an XOR fold, over
the full matrix);
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
def _mul_table(device: torch.device) -> torch.Tensor:
    """The (256*256,) u8 multiplication table on ``device``."""
    return torch.from_numpy(gf256.GF_MUL_TABLE.reshape(-1).copy()).to(device)


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
    mul = _mul_table(x.device)
    rows = (mat.to(torch.int64) << 8).expand(b, m, k)
    xs = x.to(torch.int64)
    out = torch.zeros((b, m, l), dtype=torch.uint8, device=x.device)
    for j in range(k):
        out ^= mul[rows[:, :, j, None] + xs[:, None, j, :]]
    return out


def mark_systematic(enc_mat: torch.Tensor, host: np.ndarray) -> None:
    """Record on ``enc_mat``, a copy of the host array ``host``, that it
    is an (n, k) matrix with an identity top, checking ``host``; a codec
    calls this where it builds the matrix, so that no encode reads the
    matrix back from the card.  Serves both codecs' encodes
    (``rs_encode``, ``rs16_cuda.rs16_encode``)."""
    if host.ndim != 2 or host.shape[0] < host.shape[1]:
        raise ValueError(
            f"mark_systematic: need an (n, k) systematic matrix, n >= k, got {host.shape}"
        )
    if tuple(enc_mat.shape) != host.shape:
        raise ValueError(f"mark_systematic: {tuple(enc_mat.shape)} is not {host.shape}")
    k = host.shape[1]
    if not np.array_equal(host[:k], np.eye(k, dtype=host.dtype)):
        raise ValueError(f"mark_systematic: a {host.shape} matrix without an identity top")
    enc_mat._systematic_at = enc_mat._version  # the tensor's version when checked


def require_systematic(enc_mat: torch.Tensor, what: str) -> None:
    """Raise unless ``mark_systematic`` checked ``enc_mat`` and it has not
    been written to since; ``what`` names the encode in the message."""
    if getattr(enc_mat, "_systematic_at", None) != enc_mat._version:
        raise ValueError(
            f"{what}: the matrix was not checked by mark_systematic, or "
            "was written to since"
        )


def _gf256_apply(
    mat: torch.Tensor, x: torch.Tensor, sites: Tuple[str, ...], systematic: bool
) -> torch.Tensor:
    """The kernel wrapper: plain version on CPU tensors, one gf256_apply
    launch (counted under ``sites``) on CUDA tensors.  With
    ``systematic`` the kernel multiplies the parity rows only and copies
    ``x`` into rows [0, k)."""
    _check_apply(mat, x)
    if systematic:
        require_systematic(mat, "rs_encode")
    if not _on_cuda(mat, x):
        return gf256_apply_plain(mat, x)
    b, k, l = x.shape
    m = mat.shape[-2]
    out = torch.empty((b, m, l), dtype=torch.uint8, device=x.device)
    if b == 0 or l == 0:
        return out
    row0 = k if systematic else 0
    _kb.launch(
        "gf256", "gf256_apply", sites, x,
        mat.data_ptr() + row0 * k, m * k if mat.dim() == 3 else 0,
        x.data_ptr(), out.data_ptr(), b, m - row0, k, l, row0,
    )
    return out


def rs_encode(enc_mat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """K1: (n, k) systematic matrix (identity top, checked by
    ``mark_systematic``), (B, k, L) data -> (B, n, L) shards (data rows,
    then parity)."""
    return _gf256_apply(enc_mat, data, ("rs_encode",), True)


def rs_decode(dec_mat: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """K2: (k, k) shared or (B, k, k) per-instance inverse, (B, k, L)
    surviving shards -> (B, k, L) data."""
    return _gf256_apply(dec_mat, shards, ("rs_decode",), False)


def decode_recheck(
    dec_mat: torch.Tensor, enc_mat: torch.Tensor, shards: torch.Tensor
):
    """K3: decode, re-encode the full shard set (``enc_mat`` as
    ``rs_encode`` takes it) and hash its Merkle forest, all on the
    tensors' device with no host round-trip.
    Returns (data (B, k, L), roots (B, 32))."""
    data = _gf256_apply(dec_mat, shards, ("rs_decode", "decode_recheck"), False)
    full = _gf256_apply(enc_mat, data, ("rs_encode", "decode_recheck"), True)
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
    """numpy-in/numpy-out codec whose every batch runs on ``device``.

    With a ``parallel.mesh.CryptoMesh`` the batch calls cut (B, k, L)
    over the mesh as the reference's P('v', None, 'l') (rs_xla.py:106-226):
    B padded to 'v' (row 0 repeated), L to 'l' (zeros), one K1/K2 launch
    a tile on its device, the result reassembled and cut back to
    ``[:B, :, :L]``; per-instance decode matrices cut over 'v' only.
    The contraction is over k, so tiles exchange nothing, and the fused
    K3 does not apply (``decode_recheck_batch`` returns None)."""

    def __init__(self, n: int, k: int, device="cuda", mesh=None):
        super().__init__(n, k)
        self.device = resolve_device(device)
        self.matrix = gf256.systematic_rs_matrix(n, k)
        self._enc = self._put(self.matrix)
        mark_systematic(self._enc, self.matrix)
        self.mesh = mesh
        # the encode matrix on each mesh device, each copy checked
        self._enc_on = {self.device: self._enc}
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

    def _enc_for(self, dev: torch.device) -> torch.Tensor:
        enc = self._enc_on.get(dev)
        if enc is None:
            enc = self._enc_on[dev] = self._enc.to(dev)
            mark_systematic(enc, self.matrix)
        return enc

    def _patterns(self, indices: np.ndarray) -> list:
        patterns = [self._normalize_indices(ix) for ix in indices]
        if not patterns:
            raise ValueError("empty batch")
        return patterns

    def _decode_mats(self, indices: np.ndarray) -> torch.Tensor:
        """(k, k) when every instance lost the same shards (the common
        case), else the (B, k, k) stack."""
        patterns = self._patterns(indices)
        if len(set(patterns)) == 1:
            return self._decode_matrix(patterns[0])
        return torch.stack([self._decode_matrix(p) for p in patterns])

    def _sharded(self, x: np.ndarray, rows: int, kernel, mats) -> np.ndarray:
        """``kernel(mat, tile)`` over the mesh's (v, l) tiles of x
        (B, r, L) -> (B, rows, L); ``mats(tiles)`` gives each tile's
        matrix on the tile's device."""
        mesh = self.mesh
        v, l_dim = mesh.shape
        x, b = mesh.pad_rows(x, v)
        x, l = mesh.pad_cols(x, l_dim)
        tiles = mesh.put_vl(x)
        outs = [kernel(m, t.tensor) for m, t in zip(mats(tiles), tiles)]
        full = mesh.gather(tiles, outs, (x.shape[0], rows, x.shape[-1]))
        return full[:b, :, :l]

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
        if self.mesh is not None:
            return self._sharded(
                data, self.n, rs_encode,
                lambda tiles: [self._enc_for(t.tensor.device) for t in tiles],
            )
        return rs_encode(self._enc, self._put(data)).cpu().numpy()

    def decode_batch(self, indices: np.ndarray, shards: np.ndarray) -> np.ndarray:
        if self.mesh is None:
            return rs_decode(self._decode_mats(indices), self._put(shards)).cpu().numpy()
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        patterns = self._patterns(indices)
        if len(set(patterns)) == 1:
            shared = self._decode_matrix(patterns[0])
            return self._sharded(
                shards, self.k, rs_decode,
                lambda tiles: [shared.to(t.tensor.device) for t in tiles],
            )
        # the per-instance decode matrices cut batch-only: their
        # trailing axes are the contraction dims
        per, _ = self.mesh.pad_rows(self._decode_mats(indices).cpu().numpy(), self.mesh.shape[0])
        return self._sharded(
            shards, self.k, rs_decode,
            lambda tiles: [m.tensor for m in self.mesh.put_v(per)],
        )

    def decode_recheck_batch(self, indices: np.ndarray, shards: np.ndarray):
        """K3 over a batch: (data (B, k, L), roots (B, 32)) as numpy, or
        None under a mesh (the caller's three-step path, as the
        reference's rs_xla.py:177)."""
        if self.mesh is not None:
            return None
        data, roots = decode_recheck(
            self._decode_mats(indices), self._enc, self._put(shards)
        )
        return data.cpu().numpy(), roots.cpu().numpy()


__all__ = [
    "CudaErasureCoder",
    "decode_recheck",
    "decode_recheck_plain",
    "gf256_apply_plain",
    "mark_systematic",
    "require_systematic",
    "rs_decode",
    "rs_encode",
]
