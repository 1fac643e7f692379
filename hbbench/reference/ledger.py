"""Byte formats, queues and the commit rule of a lockstep epoch.

- A transaction list: a 4-byte big-endian count, then each transaction
  as a 4-byte big-endian length and its bytes.
- A ciphertext: c1 big-endian at the group's width, the 4-byte length of
  c2, c2, the 32-byte tag.
- A proposal's shard matrix: the value framed by its 4-byte length,
  zero-padded to k rows of w bytes, w the least multiple of 128 that
  holds it; an epoch lays its N matrices side by side in (N, k, L), each
  padded with zero columns to the widest w.
- Queues: every validator keeps a FIFO of the transactions submitted to
  it; an epoch's proposal from each is the first max(B, N) // N of them.
- The commit rule: an epoch's batch is the proposals in the order of
  the sorted validator ids, each transaction once.
"""

from __future__ import annotations

import collections
import struct
from typing import Dict, List, Sequence

import numpy as np

LANE = 128


def tx_list(txs: Sequence[bytes]) -> bytes:
    return struct.pack(">I", len(txs)) + b"".join(
        struct.pack(">I", len(t)) + t for t in txs
    )


def ciphertext(nbytes: int, c1: int, c2: bytes, tag: bytes) -> bytes:
    return c1.to_bytes(nbytes, "big") + struct.pack(">I", len(c2)) + c2 + tag


def shard_matrix(value: bytes, k: int) -> np.ndarray:
    framed = struct.pack(">I", len(value)) + value
    width = -(-len(framed) // k)
    width = -(-width // LANE) * LANE
    buf = np.zeros(k * width, dtype=np.uint8)
    buf[: len(framed)] = np.frombuffer(framed, dtype=np.uint8)
    return buf.reshape(k, width)


def epoch_data(values: Sequence[bytes], k: int) -> np.ndarray:
    """The (N, k, L) data shards of an epoch's N proposals."""
    mats = [shard_matrix(v, k) for v in values]
    out = np.zeros((len(mats), k, max(m.shape[1] for m in mats)), dtype=np.uint8)
    for i, m in enumerate(mats):
        out[i, :, : m.shape[1]] = m
    return out


class Queues:
    """The validators' FIFOs, fed in submission order."""

    def __init__(self, ids: Sequence[str], batch_size: int) -> None:
        self.ids = sorted(ids)
        self.per_node = max(batch_size, len(self.ids)) // len(self.ids)
        self.q: Dict[str, collections.deque] = {i: collections.deque() for i in self.ids}

    def submit(self, node: str, tx: int) -> None:
        self.q[node].append(tx)

    def propose(self) -> Dict[str, List[int]]:
        """Each validator's proposal for the next epoch, popped."""
        out = {}
        for nid in self.ids:
            q = self.q[nid]
            out[nid] = [q.popleft() for _ in range(min(self.per_node, len(q)))]
        return out

    def pending(self) -> int:
        return sum(len(q) for q in self.q.values())


def commit(proposals: Dict[str, List[bytes]]) -> List[bytes]:
    """The epoch's batch under the commit rule."""
    seen = set()
    out = []
    for nid in sorted(proposals):
        for tx in proposals[nid]:
            if tx not in seen:
                seen.add(tx)
                out.append(tx)
    return out
