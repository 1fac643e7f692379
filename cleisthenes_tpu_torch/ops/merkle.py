"""Merkle forest: batched tree build and branch verification.

RBC attaches to every VAL/ECHO a Merkle root h and branch b(j) proving
shard s(j) (reference rbc/request.go:9-13, docs/RBC-EN.md:31-39); after
interpolation the root is recomputed to catch corrupt shards
(docs/RBC-EN.md:37-38).  The network-wide cost is N^2 log N hashes per
epoch (docs/HONEYBADGER-EN.md:96) — all independent, so both the build
(one tree per validator's proposal) and the verify (N branches per
delivered instance) are batched onto the card via ops/sha256_cuda.

This is the PyTorch port's copy of ``cleisthenes_tpu/ops/merkle.py``
with ``CudaMerkle`` in place of ``XlaMerkle``.

Convention: leaf digest = SHA256(0x00 || shard), interior node =
SHA256(0x01 || left || right) (domain separation against second-
preimage splices); leaf sets pad to the next power of two with a fixed
sentinel digest.
"""

from __future__ import annotations

import abc
import dataclasses
import hashlib
from typing import List, Sequence

import numpy as np
import torch

from cleisthenes_tpu_torch.ops import sha256_cuda

_LEAF_PREFIX = b"\x00"
_NODE_PREFIX = b"\x01"
_EMPTY_LEAF_DIGEST = sha256_cuda.EMPTY_LEAF_DIGEST
_next_pow2 = sha256_cuda.next_pow2


@dataclasses.dataclass
class MerkleTree:
    """A built tree: levels[0] is the (padded) leaf-digest row, levels[-1]
    is the single root digest.  All rows are (width, 32) uint8."""

    levels: List[np.ndarray]
    n_leaves: int

    @property
    def root(self) -> bytes:
        return self.levels[-1][0].tobytes()

    def branch(self, index: int) -> List[bytes]:
        """Sibling path for leaf ``index``, bottom-up
        (the b(j) of reference rbc/request.go:11)."""
        if not (0 <= index < self.n_leaves):
            raise IndexError(index)
        out = []
        for level in self.levels[:-1]:
            out.append(level[index ^ 1].tobytes())
            index >>= 1
        return out

    @property
    def depth(self) -> int:
        return len(self.levels) - 1


class MerkleBackend(abc.ABC):
    """Batched tree building + branch verification."""

    def build(self, shards: np.ndarray) -> MerkleTree:
        """(N, L) uint8 shard matrix -> tree over N leaves."""
        return self.build_batch(shards[None])[0]

    @abc.abstractmethod
    def build_batch(self, shards: np.ndarray) -> List[MerkleTree]:
        """(B, N, L) uint8 shards -> B trees."""

    def verify_branch(
        self, root: bytes, leaf: bytes, branch: Sequence[bytes], index: int
    ) -> bool:
        """One proof, pure hashlib: a scalar verify is a handful of
        SHA-256 calls, cheaper than any array assembly or device call.
        Batch waves use verify_batch."""
        cur = hashlib.sha256(_LEAF_PREFIX + leaf).digest()
        idx = index
        for sib in branch:
            if idx & 1:
                cur = hashlib.sha256(_NODE_PREFIX + sib + cur).digest()
            else:
                cur = hashlib.sha256(_NODE_PREFIX + cur + sib).digest()
            idx >>= 1
        return cur == root

    @abc.abstractmethod
    def verify_batch(
        self,
        roots: np.ndarray,
        leaves: np.ndarray,
        branches: np.ndarray,
        indices: np.ndarray,
    ) -> np.ndarray:
        """roots (B, 32), leaves (B, L) raw shard bytes, branches
        (B, D, 32) sibling paths bottom-up, indices (B,) leaf positions
        -> (B,) bool."""


class CpuMerkle(MerkleBackend):
    """Host backend: one native batched-SHA crossing per level
    (ops/hashrows; identical digests to the old hashlib loop)."""

    def _hash_batch(self, msgs: np.ndarray) -> np.ndarray:
        """(B, L) uint8 -> (B, 32) uint8."""
        from cleisthenes_tpu_torch.ops.hashrows import sha256_rows

        return sha256_rows(msgs)

    # -- building ----------------------------------------------------

    def build_batch(self, shards: np.ndarray) -> List[MerkleTree]:
        """(B, N, L) -> B trees, all leaf hashing/level hashing batched."""
        b, n, l = shards.shape
        p = _next_pow2(n)
        prefixed = np.concatenate(
            [
                np.zeros((b * n, 1), dtype=np.uint8),
                shards.reshape(b * n, l),
            ],
            axis=1,
        )
        leaf_dig = self._hash_batch(prefixed).reshape(b, n, 32)
        if p != n:
            pad = np.broadcast_to(
                np.frombuffer(_EMPTY_LEAF_DIGEST, dtype=np.uint8), (b, p - n, 32)
            )
            leaf_dig = np.concatenate([leaf_dig, pad], axis=1)
        levels = [leaf_dig]
        width = p
        while width > 1:
            cur = levels[-1]  # (b, width, 32)
            pairs = cur.reshape(b, width // 2, 64)
            msgs = np.concatenate(
                [
                    np.ones((b * (width // 2), 1), dtype=np.uint8),
                    pairs.reshape(b * (width // 2), 64),
                ],
                axis=1,
            )
            levels.append(self._hash_batch(msgs).reshape(b, width // 2, 32))
            width //= 2
        return [
            MerkleTree([lvl[i] for lvl in levels], n_leaves=n) for i in range(b)
        ]

    # -- verification ------------------------------------------------

    def verify_batch(
        self,
        roots: np.ndarray,
        leaves: np.ndarray,
        branches: np.ndarray,
        indices: np.ndarray,
    ) -> np.ndarray:
        """Verify B branches at once.

        roots (B, 32), leaves (B, L) raw shard bytes, branches
        (B, D, 32) sibling paths bottom-up, indices (B,) leaf positions
        -> (B,) bool.  The whole thing is D+1 batched hash dispatches.
        """
        b, l = leaves.shape
        d = branches.shape[1]
        prefixed = np.concatenate(
            [np.zeros((b, 1), dtype=np.uint8), leaves], axis=1
        )
        cur = self._hash_batch(prefixed)  # (B, 32)
        idx = np.asarray(indices).copy()
        for lvl in range(d):
            sib = branches[:, lvl]
            bit = (idx & 1).astype(bool)[:, None]
            left = np.where(bit, sib, cur)
            right = np.where(bit, cur, sib)
            msgs = np.concatenate(
                [np.ones((b, 1), dtype=np.uint8), left, right], axis=1
            )
            cur = self._hash_batch(msgs)
            idx >>= 1
        return (cur == roots).all(axis=1)


class CudaMerkle(MerkleBackend):
    """Merkle forests and branch checks on the card (the counterpart of
    the reference's ``XlaMerkle``, merkle.py:152).

    ``build_batch`` and ``verify_batch`` each run as one device call
    (ops/sha256_cuda.py: K5 ``build_forest``, K6 ``verify_branches``)
    and bring the result back to the host: trees come back as
    ``MerkleTree``s with numpy levels, which the lockstep executor
    indexes for branch assembly.  Every batch goes to the device; the
    reference's host floors and power-of-two buckets (merkle.py:198-218)
    were tuned for a TPU relay and do not carry over.  On a CPU
    ``device`` the same calls run the plain PyTorch versions.

    With a ``parallel.mesh.CryptoMesh`` the batch axis cuts over EVERY
    mesh device flat (the reference's ``P(('v','l'))``): hashing is
    sequential within a message but independent across the batch, so
    each device builds or checks its block with one launch.  The batch
    pads with zero rows to a multiple of the device count (``_bucket``).
    """

    def __init__(self, device="cuda", mesh=None):
        from cleisthenes_tpu_torch.ops.backend import resolve_device

        self.device = resolve_device(device)
        self.mesh = mesh

    def _put(self, a: np.ndarray, dtype=np.uint8) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            self.device
        )

    def _bucket(self, b: int) -> int:
        """The batch padded to a multiple of the mesh's device count
        (a (3, 2) mesh pads 5 to 6); ``b`` itself without a mesh."""
        if self.mesh is None:
            return b
        return b + (-b) % self.mesh.n_devices

    def _flat(self, kernel, arrays, dtype=np.uint8) -> np.ndarray:
        """``kernel`` once a device over the mesh's flat cut of
        ``arrays`` (zero-padded to ``_bucket`` rows); the result's first
        ``len(arrays[0])`` rows."""
        b = arrays[0].shape[0]
        parts = self.mesh.put_flat(
            *(self.mesh.pad_zero_rows(a, self.mesh.n_devices) for a in arrays)
        )
        outs = [kernel(*(p.tensor for p in row)) for row in zip(*parts)]
        shape = (self._bucket(b),) + tuple(outs[0].shape[1:])
        return self.mesh.gather(parts[0], outs, shape, dtype)[:b]

    def build_batch(self, shards: np.ndarray) -> List[MerkleTree]:
        b, n, _ = shards.shape
        # (b, 2p-1, 32): the whole forest in one transfer
        if self.mesh is None:
            forest = sha256_cuda.build_forest(self._put(shards)).cpu().numpy()
        else:
            forest = self._flat(
                sha256_cuda.build_forest, [np.ascontiguousarray(shards, np.uint8)]
            )
        levels = []
        off, width = 0, _next_pow2(n)
        while width >= 1:
            levels.append(forest[:, off : off + width])
            off += width
            width //= 2
        return [
            MerkleTree([lvl[i] for lvl in levels], n_leaves=n)
            for i in range(b)
        ]

    def verify_batch(
        self,
        roots: np.ndarray,
        leaves: np.ndarray,
        branches: np.ndarray,
        indices: np.ndarray,
    ) -> np.ndarray:
        if self.mesh is not None:
            return self._flat(
                sha256_cuda.verify_branches,
                [
                    np.ascontiguousarray(roots, np.uint8),
                    np.ascontiguousarray(leaves, np.uint8),
                    np.ascontiguousarray(branches, np.uint8),
                    np.ascontiguousarray(indices, np.int64),
                ],
                dtype=bool,
            )
        ok = sha256_cuda.verify_branches(
            self._put(roots),
            self._put(leaves),
            self._put(branches),
            self._put(indices, np.int64),
        )
        return ok.cpu().numpy()


def make_merkle(backend: str, device="cuda", mesh=None) -> MerkleBackend:
    if backend == "cpu":
        return CpuMerkle()
    if backend == "cuda":
        return CudaMerkle(device=device, mesh=mesh)
    raise ValueError(f"unknown merkle backend {backend!r}")


__all__ = [
    "MerkleTree",
    "MerkleBackend",
    "CpuMerkle",
    "CudaMerkle",
    "make_merkle",
]
