"""In-memory FIFO transaction queue.

Semantics mirror the reference's mutex-guarded ``memQueue``
(reference queue.go:15-94): Push appends, Poll pops the head, ``at``
indexes without removal, with typed errors for empty-queue and
index-out-of-bounds conditions (queue.go:21-47).  Transactions are
opaque to the framework (reference honeybadger.go:115
``Transaction interface{}``).
"""

from __future__ import annotations

import collections
from typing import Any, Deque

from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_lock

# A transaction is opaque to the consensus core (honeybadger.go:115).
Transaction = Any


class EmptyQueueError(Exception):
    """Raised when polling/peeking an empty queue (reference queue.go:21-26)."""

    def __init__(self) -> None:
        super().__init__("empty queue")


class IndexBoundaryError(Exception):
    """Raised on out-of-range ``at`` access (reference queue.go:28-34)."""

    def __init__(self, index: int, size: int) -> None:
        super().__init__(f"index {index} out of bounds for queue of size {size}")
        self.index = index
        self.size = size


@guarded_by("_lock", "_txs")
class TxQueue:
    """Thread-safe FIFO of opaque transactions (reference queue.go:15-94)."""

    def __init__(self) -> None:
        self._txs: Deque[Transaction] = collections.deque()
        self._lock = new_lock()

    def push(self, tx: Transaction) -> None:
        """Append a transaction (reference queue.go:89-94)."""
        with self._lock:
            self._txs.append(tx)

    def poll(self) -> Transaction:
        """Pop and return the head (reference queue.go:59-76)."""
        with self._lock:
            if not self._txs:
                raise EmptyQueueError()
            return self._txs.popleft()

    def peek(self) -> Transaction:
        """Return the head without removing it (reference queue.go:50-57)."""
        with self._lock:
            if not self._txs:
                raise EmptyQueueError()
            return self._txs[0]

    def at(self, index: int) -> Transaction:
        """Return the item at ``index`` without removal (queue.go:78-87)."""
        with self._lock:
            if index < 0 or index >= len(self._txs):
                raise IndexBoundaryError(index, len(self._txs))
            return self._txs[index]

    def __len__(self) -> int:
        with self._lock:
            return len(self._txs)

    def len(self) -> int:
        """Go-style alias (reference queue.go uses Len())."""
        return len(self)
