"""Deterministic cross-lane total-order merge.

Horizontal shard-out runs S independent HBBFT lane instances over one
roster; each lane commits its own settled epoch stream.  Two pure
functions turn those S streams into one system:

``lane_of``
    The admission partitioner: ``sha256(seed || digest) % S``.  A pure
    function of (seed, tx digest, S) — identical on every node and
    under every PYTHONHASHSEED, so all honest nodes admit a given
    transaction into the SAME lane and the per-lane ledgers stay
    disjoint by construction.

``MergeCursor``
    The settled-frontier merge: the merged total order enumerates
    slots epoch-major, lane-minor —

        (epoch 0, lane 0), (epoch 0, lane 1), ..., (epoch 0, lane S-1),
        (epoch 1, lane 0), ...

    A slot emits the moment its lane settles that epoch AND every
    earlier slot has emitted.  Because each lane settles strictly in
    epoch order and the slot sequence is fixed, the merged order is a
    pure function of the committed bytes: honest nodes that settled
    the same per-lane prefixes hold byte-identical merged prefixes,
    regardless of the wall-clock interleaving in which lanes settled.

The merge is deliberately NOT fee- or timestamp-aware: any dynamic
key would make the total order depend on per-node observation order.
Slot arithmetic only.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

__all__ = ["lane_of", "merge_order", "MergeCursor"]


def _seed_bytes(seed: Optional[int]) -> bytes:
    # the mempool tiebreak's packing (core.mempool): unseeded
    # configs partition with seed 0 — still deterministic, just not
    # operator-chosen
    return (seed or 0).to_bytes(8, "big", signed=True)


def lane_of(seed: Optional[int], digest: bytes, lanes: int) -> int:
    """Admission lane for a transaction digest: seeded
    ``sha256(seed || digest) % S``.  ``lanes=1`` maps everything to
    lane 0 (the single-lane build never calls this)."""
    if lanes <= 1:
        return 0
    h = hashlib.sha256(_seed_bytes(seed) + digest).digest()
    return int.from_bytes(h[:8], "big") % lanes


class MergeCursor:
    """Incremental epoch-major, lane-minor merge over S settled lane
    streams.

    ``push(lane, epoch, batch)`` records one lane settlement (epochs
    per lane must arrive in order — they do, lanes settle strictly in
    epoch order); ``drain()`` returns every newly emittable merged
    slot as ``(seq, lane, epoch, batch)`` rows, where ``seq`` is the
    global merged position ``epoch * S + lane``.  The emitted prefix
    is also kept in ``merged`` for subscription replay.
    """

    __slots__ = ("lanes", "_pending", "_next", "merged")

    def __init__(self, lanes: int) -> None:
        if lanes < 1:
            raise ValueError(f"lanes={lanes} must be >= 1")
        self.lanes = lanes
        # (epoch, lane) -> batch, settled but not yet merge-emitted
        self._pending: Dict[Tuple[int, int], object] = {}
        self._next = 0  # next merged seq = epoch * S + lane
        self.merged: List[object] = []  # emitted batches, seq order

    @property
    def frontier(self) -> int:
        """Number of merged slots emitted (the merged settled
        frontier)."""
        return self._next

    def push(self, lane: int, epoch: int, batch) -> None:
        if not (0 <= lane < self.lanes):
            raise ValueError(f"lane={lane} out of range 0..{self.lanes - 1}")
        self._pending[(epoch, lane)] = batch

    def drain(self) -> List[Tuple[int, int, int, object]]:
        out: List[Tuple[int, int, int, object]] = []
        pending = self._pending
        while True:
            epoch, lane = divmod(self._next, self.lanes)
            if (epoch, lane) not in pending:
                return out
            batch = pending.pop((epoch, lane))
            out.append((self._next, lane, epoch, batch))
            self.merged.append(batch)
            self._next += 1


def merge_order(settled: List[List[object]]) -> List[object]:
    """The batch merge rule applied wholesale: per-lane settled batch
    lists in, the emittable merged prefix out (fuzz oracle; the live
    path uses MergeCursor incrementally)."""
    cur = MergeCursor(max(1, len(settled)))
    for lane, batches in enumerate(settled):
        for epoch, batch in enumerate(batches):
            cur.push(lane, epoch, batch)
    cur.drain()
    return cur.merged
