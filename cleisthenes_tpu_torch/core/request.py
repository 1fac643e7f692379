"""Typed request repositories and the epoch catch-up buffer.

Reference request.go:3-17 defines ``Request`` (marker), a per-ConnId
``RequestRepository{Save, Find, FindAll}`` and an
``IncomingRequestRepository`` additionally keyed by epoch — the buffer
for messages "sent from a node that is already in a later epoch …
saved and handled in the next epoch" (reference bba/request.go:28-32,
wired at bba/bba.go:55).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_lock

Request = Any  # marker interface (reference request.go:3-5)


class DuplicateRequestError(Exception):
    """A peer tried to save a second request for the same key.

    Protocol handlers rely on first-write-wins per (sender, type) to
    enforce the at-most-one-vote-per-peer rule in quorum counting.
    """


@guarded_by("_lock", "_reqs")
class RequestRepository:
    """Per-connection-id request store (reference request.go:7-11).

    First save wins; duplicates raise, which callers treat as "already
    counted this peer" (idempotent message delivery).
    """

    def __init__(self) -> None:
        self._reqs: Dict[str, Request] = {}
        self._lock = new_lock()

    def save(self, conn_id: str, req: Request) -> None:
        with self._lock:
            if conn_id in self._reqs:
                raise DuplicateRequestError(conn_id)
            self._reqs[conn_id] = req

    def find(self, conn_id: str) -> Request:
        with self._lock:
            return self._reqs.get(conn_id)

    def find_all(self) -> List[Tuple[str, Request]]:
        with self._lock:
            return list(self._reqs.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._reqs)

    def __contains__(self, conn_id: str) -> bool:
        with self._lock:
            return conn_id in self._reqs


@guarded_by("_lock", "_reqs")
class IncomingRequestRepository:
    """Epoch-keyed buffer for future-epoch messages
    (reference request.go:13-17, bba/request.go:28-32).

    Messages from nodes already in a later epoch are parked here and
    replayed when the local node advances.
    """

    def __init__(
        self, max_epoch_horizon: int = 8, max_per_sender: int = 256
    ) -> None:
        # DoS bounds (absent in the reference, which keeps one request
        # per sender in a bare map): a Byzantine peer must not be able
        # to park unbounded messages for arbitrarily-distant epochs.
        self._max_epoch_horizon = max_epoch_horizon
        self._max_per_sender = max_per_sender
        self._reqs: Dict[int, Dict[str, List[Request]]] = {}
        self._lock = new_lock()
        self.dropped = 0

    def save(
        self, epoch: int, conn_id: str, req: Request, current_epoch: int
    ) -> bool:
        """Buffer ``req`` for a future ``epoch``; returns False if dropped.

        Only strictly-future epochs within ``max_epoch_horizon`` are
        buffered (current-epoch messages are handled directly and
        past-epoch messages are useless), and at most
        ``max_per_sender`` per (epoch, sender) — a correct peer never
        needs more.
        """
        with self._lock:
            if not (
                current_epoch < epoch <= current_epoch + self._max_epoch_horizon
            ):
                self.dropped += 1
                return False
            bucket = self._reqs.setdefault(epoch, {}).setdefault(conn_id, [])
            if len(bucket) >= self._max_per_sender:
                self.dropped += 1
                return False
            bucket.append(req)
            return True

    def find_all(self, epoch: int) -> List[Tuple[str, Request]]:
        """All buffered (sender, request) pairs for ``epoch``."""
        with self._lock:
            out: List[Tuple[str, Request]] = []
            for conn_id, reqs in self._reqs.get(epoch, {}).items():
                out.extend((conn_id, r) for r in reqs)
            return out

    def pop_epoch(self, epoch: int) -> List[Tuple[str, Request]]:
        """Drain and return everything buffered for ``epoch``.

        Also garbage-collects anything parked for earlier epochs — a
        node draining epoch e will never revisit e' < e.
        """
        with self._lock:
            buf = self._reqs.pop(epoch, {})
            for stale in [e for e in self._reqs if e < epoch]:
                del self._reqs[stale]
        out: List[Tuple[str, Request]] = []
        for conn_id, reqs in buf.items():
            out.extend((conn_id, r) for r in reqs)
        return out
