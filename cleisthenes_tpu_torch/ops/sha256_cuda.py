"""Batched SHA-256, Merkle forests and branch checks on the card.

The port's counterpart of ``cleisthenes_tpu/ops/sha256_xla.py``: the
RBC ECHO phase costs N^2 log N independent hashes per epoch (reference
docs/HONEYBADGER-EN.md:96), so hashing runs over a batch axis with one
CUDA thread per message (csrc/sha256.cu), a forest with one block a tree.

Three entry points, each with its plain PyTorch version beside it:

- ``sha256_rows``      K4, ``sha256_batch`` (sha256_xla.py:127)
- ``build_forest``     K5, ``build_forest`` (sha256_xla.py:157): one
                       ``merkle_forest`` launch a forest, a block a tree
- ``verify_branches``  K6, ``verify_branches`` (sha256_xla.py:206)

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.  The plain SHA-256 works in int64
masked to 32 bits: PyTorch's CPU uint32 lacks ``+`` and int32 ``>>`` is
arithmetic.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Optional, Tuple

import torch

from cleisthenes_tpu_torch.csrc import build as _kb

LEAF_PREFIX = 0x00
NODE_PREFIX = 0x01
# wire-visible in every root of a non-power-of-two roster
EMPTY_LEAF_DIGEST = hashlib.sha256(b"cleisthenes-tpu:empty-leaf").digest()

_MASK = 0xFFFFFFFF
_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
_H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _MASK


def sha256_rows_plain(
    msgs: torch.Tensor, prefix: Optional[int] = None
) -> torch.Tensor:
    """SHA-256 of [prefix byte] || each row: (B, L) u8 -> (B, 32) u8."""
    b, l = msgs.shape
    dev = msgs.device
    if prefix is not None:
        msgs = torch.cat(
            [torch.full((b, 1), prefix, dtype=torch.uint8, device=dev), msgs], 1
        )
        l += 1
    nblocks = (l + 9 + 63) // 64
    padded = torch.zeros((b, nblocks * 64), dtype=torch.int64, device=dev)
    padded[:, :l] = msgs.to(torch.int64)
    padded[:, l] = 0x80
    bitlen = l * 8
    for i in range(8):
        padded[:, nblocks * 64 - 1 - i] = (bitlen >> (8 * i)) & 0xFF
    by = padded.view(b, nblocks, 16, 4)
    words = (by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8) | by[..., 3]
    state = [torch.full((b,), h, dtype=torch.int64, device=dev) for h in _H0]
    for blk in range(nblocks):
        w = [words[:, blk, i] for i in range(16)]
        for t in range(16, 64):
            s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
            s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & _MASK)
        a, b_, c, d, e, f, g, h = state
        for t in range(64):
            s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ ((e ^ _MASK) & g)
            t1 = (h + s1 + ch + _K[t] + w[t]) & _MASK
            s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b_) ^ (a & c) ^ (b_ & c)
            h, g, f, e = g, f, e, (d + t1) & _MASK
            d, c, b_, a = c, b_, a, (t1 + s0 + maj) & _MASK
        state = [
            (s + v) & _MASK for s, v in zip(state, (a, b_, c, d, e, f, g, h))
        ]
    st = torch.stack(state, 1)  # (B, 8)
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=dev)
    return ((st[:, :, None] >> shifts) & 0xFF).to(torch.uint8).reshape(b, 32)


def _empty_leaf(device: torch.device) -> torch.Tensor:
    return torch.frombuffer(
        bytearray(EMPTY_LEAF_DIGEST), dtype=torch.uint8
    ).to(device)


def build_forest_plain(shards: torch.Tensor) -> torch.Tensor:
    """B Merkle trees: (B, n, L) u8 -> (B, 2p-1, 32), leaf row first
    (p = next power of two >= n, padded with the empty-leaf digest),
    root last."""
    b, n, l = shards.shape
    p = next_pow2(n)
    cur = sha256_rows_plain(shards.reshape(b * n, l), LEAF_PREFIX).reshape(b, n, 32)
    if p != n:
        pad = _empty_leaf(shards.device).expand(b, p - n, 32)
        cur = torch.cat([cur, pad], 1)
    levels = [cur]
    width = p
    while width > 1:
        half = width // 2
        cur = sha256_rows_plain(cur.reshape(b * half, 64), NODE_PREFIX)
        cur = cur.reshape(b, half, 32)
        levels.append(cur)
        width = half
    return torch.cat(levels, 1)


def branch_digests_plain(
    leaves: torch.Tensor, branches: torch.Tensor, indices: torch.Tensor
) -> torch.Tensor:
    """The root each branch proves: leaves (B, L), branches (B, D, 32) u8
    sibling paths bottom-up, indices (B,) (their low 32 bits) -> (B, 32)."""
    cur = sha256_rows_plain(leaves, LEAF_PREFIX)
    idx = indices.to(torch.int64) & _MASK  # u32, as the reference's kernel
    for lvl in range(branches.shape[1]):
        sib = branches[:, lvl]
        bit = (idx & 1).bool()[:, None]
        left = torch.where(bit, sib, cur)
        right = torch.where(bit, cur, sib)
        cur = sha256_rows_plain(torch.cat([left, right], 1), NODE_PREFIX)
        idx = idx >> 1
    return cur


def verify_branches_plain(
    roots: torch.Tensor,
    leaves: torch.Tensor,
    branches: torch.Tensor,
    indices: torch.Tensor,
) -> torch.Tensor:
    """roots (B, 32), leaves (B, L), branches (B, D, 32) u8 sibling
    paths bottom-up, indices (B,) -> (B,) bool."""
    return (branch_digests_plain(leaves, branches, indices) == roots).all(1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_u8(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.uint8 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {ndim}-D uint8 tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA tensors on
    one card; anything else raises."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError(f"tensors on several devices: {sorted({str(t.device) for t in tensors})}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


@functools.lru_cache(maxsize=None)
def _empty_leaf_on(device: torch.device) -> torch.Tensor:
    return _empty_leaf(device)


def sha256_rows(msgs: torch.Tensor, prefix: Optional[int] = None) -> torch.Tensor:
    """SHA-256 of [prefix byte] || each row: (B, L) u8 -> (B, 32) u8."""
    _check_u8("sha256_rows", msgs, 2)
    if not _on_cuda(msgs):
        return sha256_rows_plain(msgs, prefix)
    b, l = msgs.shape
    out = torch.empty((b, 32), dtype=torch.uint8, device=msgs.device)
    if b:
        _kb.launch(
            "sha256", "sha256_rows", ("sha256_rows",), msgs,
            msgs.data_ptr(), b, l, -1 if prefix is None else prefix, out.data_ptr(),
        )
    return out


FOREST_SITES = ("merkle_forest",)


def _build_forest(shards: torch.Tensor, sites: Tuple[str, ...]) -> torch.Tensor:
    """One merkle_forest launch (counted under ``sites``): one block a
    tree builds its leaf level and every level above it."""
    b, n, l = shards.shape
    p = next_pow2(n)
    forest = torch.empty((b, 2 * p - 1, 32), dtype=torch.uint8, device=shards.device)
    if b == 0:
        return forest
    pad = _empty_leaf_on(shards.device)
    _kb.launch(
        "sha256", "merkle_forest", sites, shards,
        shards.data_ptr(), b, n, l, forest.data_ptr(), pad.data_ptr(),
    )
    return forest


def build_forest(shards: torch.Tensor) -> torch.Tensor:
    """B Merkle trees: (B, n, L) u8 -> (B, 2p-1, 32), leaf row first,
    root last (the reference's ``build_forest`` layout)."""
    _check_u8("build_forest", shards, 3)
    if not _on_cuda(shards):
        return build_forest_plain(shards)
    return _build_forest(shards, FOREST_SITES)


def verify_branches(
    roots: torch.Tensor,
    leaves: torch.Tensor,
    branches: torch.Tensor,
    indices: torch.Tensor,
) -> torch.Tensor:
    """B branch proofs -> (B,) bool (see ``verify_branches_plain``)."""
    _check_u8("verify_branches roots", roots, 2)
    _check_u8("verify_branches leaves", leaves, 2)
    _check_u8("verify_branches branches", branches, 3)
    b = leaves.shape[0]
    if roots.shape != (b, 32) or branches.shape[0] != b or (
        branches.shape[2] != 32 or indices.shape != (b,)
    ):
        raise ValueError(
            f"verify_branches: shapes roots {tuple(roots.shape)} leaves "
            f"{tuple(leaves.shape)} branches {tuple(branches.shape)} "
            f"indices {tuple(indices.shape)} do not agree"
        )
    if not _on_cuda(roots, leaves, branches, indices):
        return verify_branches_plain(roots, leaves, branches, indices)
    idx = indices.to(torch.int64).contiguous()
    ok = torch.empty((b,), dtype=torch.bool, device=leaves.device)  # the kernel writes 0/1 bytes
    if b:
        _kb.launch(
            "sha256", "merkle_verify", ("merkle_verify",), leaves,
            roots.data_ptr(), leaves.data_ptr(), leaves.shape[1],
            branches.data_ptr(), branches.shape[1], idx.data_ptr(), ok.data_ptr(), b,
        )
    return ok


__all__ = [
    "EMPTY_LEAF_DIGEST",
    "branch_digests_plain",
    "build_forest",
    "build_forest_plain",
    "next_pow2",
    "sha256_rows",
    "sha256_rows_plain",
    "verify_branches",
    "verify_branches_plain",
]
