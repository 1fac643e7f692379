"""Reed-Solomon over GF(2^16) on the card: the port's K11.

The counterpart of ``cleisthenes_tpu/ops/rs16_xla_kernels.py``.  One
CUDA kernel, ``gf65536_apply`` (csrc/gf65536.cu), computes
out[b] = M_b (*) x[b] over GF(2^16) on uint16 symbols as the reference
does, as a GF(2) product of the lifted (16m, 16k) 0/1 matrix with the
symbols' bits, on the binary tensor cores; M shared or one per instance.
It carries both TPU kernels of the wide codec:

- encode (rs16_xla_kernels.py:47/:57): given the (n, k) systematic
  matrix, the kernel multiplies its n - k parity rows and copies the data
  symbols into rows [0, k), so the result is the whole (B, n, S) shard
  set.  The matrix's identity top is checked on the host once per matrix
  (``mark_systematic``, called where the codec builds it), never per call,
  and an encode given a matrix it did not check raises;
- decode (:53/:58): M = the inverse of the surviving rows, inverted on
  the host (gf65536.gf_mat_inv), shared (k, k) or per instance
  (B, k, k).

A wrapper given CPU tensors runs the plain PyTorch version
(``gf65536_apply_plain``: exp/log tables as tensors, one XOR fold per
column of M); given CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from cleisthenes_tpu_torch.csrc import build as _kb
from cleisthenes_tpu_torch.ops import gf65536 as gf
from cleisthenes_tpu_torch.ops.rs_cuda import mark_systematic, require_systematic
from cleisthenes_tpu_torch.ops.sha256_cuda import _on_cuda

# the multiplicative group's order; exp index 65535 is the zero slot
_ORDER = gf.ORDER - 1
# a log sentinel for 0: every sum with it clamps to the zero slot
_ZERO_LOG = 1 << 20


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(exp (65536,) uint16 with exp[65535] = 0, log (65536,) uint16)
    on ``device``, for the plain version."""
    exp = np.zeros(gf.ORDER, dtype=np.uint16)
    exp[:_ORDER] = gf.GF_EXP[:_ORDER]
    return (
        torch.from_numpy(exp).to(device),
        torch.from_numpy(gf.GF_LOG.astype(np.uint16)).to(device),
    )


def _check_apply(mat: torch.Tensor, x: torch.Tensor) -> None:
    if x.dtype != torch.uint16 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(
            f"gf65536_apply x: need a contiguous (B, k, S) uint16 tensor, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    if mat.dtype != torch.uint16 or mat.dim() not in (2, 3) or not mat.is_contiguous():
        raise ValueError(
            f"gf65536_apply: need a contiguous (m, k) or (B, m, k) uint16 "
            f"matrix, got {mat.dtype} {tuple(mat.shape)}"
        )
    b, k, _ = x.shape
    if mat.shape[-1] != k or (mat.dim() == 3 and mat.shape[0] != b):
        raise ValueError(
            f"gf65536_apply: matrix {tuple(mat.shape)} does not fit data "
            f"{tuple(x.shape)}"
        )


def _logs(t: torch.Tensor, log: torch.Tensor) -> torch.Tensor:
    """int64 logs of uint16 symbols, ``_ZERO_LOG`` for 0."""
    v = t.to(torch.int64)
    return torch.where(v == 0, _ZERO_LOG, log.to(torch.int64)[v])


def gf65536_apply_plain(mat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[b, r, s] = XOR_j mat_b[r, j] * x[b, j, s] over GF(2^16):
    mat (m, k) or (B, m, k), x (B, k, S) uint16 -> (B, m, S) uint16."""
    b, k, s = x.shape
    m = mat.shape[-2]
    exp, log = _tables(x.device)
    exp = exp.to(torch.int64)
    lm = _logs(mat, log).expand(b, m, k)
    lx = _logs(x, log)
    out = torch.zeros((b, m, s), dtype=torch.int64, device=x.device)
    for j in range(k):
        e = lm[:, :, j, None] + lx[:, None, j, :]
        e = torch.where(e >= _ORDER, e - _ORDER, e).clamp_(max=_ORDER)
        out ^= exp[e]
    return out.to(torch.uint16)


def _gf65536_apply(
    mat: torch.Tensor, x: torch.Tensor, sites: Tuple[str, ...], systematic: bool
) -> torch.Tensor:
    """The kernel wrapper: plain version on CPU tensors, one
    gf65536_apply launch (counted under ``sites``) on CUDA tensors.  With
    ``systematic`` the kernel multiplies the parity rows only and copies
    ``x`` into rows [0, k)."""
    _check_apply(mat, x)
    if systematic:
        require_systematic(mat, "rs16_encode")
    if not _on_cuda(mat, x):
        return gf65536_apply_plain(mat, x)
    b, k, s = x.shape
    m = mat.shape[-2]
    out = torch.empty((b, m, s), dtype=torch.uint16, device=x.device)
    if b == 0 or s == 0:
        return out
    row0 = k if systematic else 0
    _kb.launch(
        "gf65536", "gf65536_apply", sites, x,
        mat.data_ptr() + row0 * k * mat.element_size(),
        m * k if mat.dim() == 3 else 0,
        x.data_ptr(), out.data_ptr(), b, m - row0, k, s, row0,
    )
    return out


def rs16_encode(enc_mat: torch.Tensor, syms: torch.Tensor) -> torch.Tensor:
    """K11 encode: (n, k) systematic matrix (identity top), (B, k, S)
    data symbols -> (B, n, S) shards (data rows, then parity)."""
    return _gf65536_apply(enc_mat, syms, ("rs16_encode",), True)


def rs16_decode(dec_mat: torch.Tensor, syms: torch.Tensor) -> torch.Tensor:
    """K11 decode: (k, k) shared or (B, k, k) per-instance inverse,
    (B, k, S) surviving shard symbols -> (B, k, S) data symbols."""
    return _gf65536_apply(dec_mat, syms, ("rs16_decode",), False)


__all__ = ["gf65536_apply_plain", "mark_systematic", "rs16_decode", "rs16_encode"]
