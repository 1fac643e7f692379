"""Fee-priority mempool: the admission stage ahead of the TxQueue.

The ingress plane (transport/ingress.py) terminates untrusted client
submissions; this module is its policy core.  Where the FIFO TxQueue
(core/queue.py) trusts its callers — the node itself, protocol-internal
transactions — the mempool assumes an open-loop, adversarial client
population and makes three promises the ingress ack contract
(docs/ARCHITECTURE.md "Ingress plane") is built on:

1. **No silent drops.**  Every ``admit`` returns an explicit verdict:
   OK, DUPLICATE (the tx is already pending, in flight, or recently
   settled), RETRY_AFTER (per-client cap or global pressure — come
   back in ``retry_after_ms``), or REJECTED (malformed/oversized).
   An OK'd tx either settles or is *visibly* evicted (the ``evicted``
   counter + the on_evict hook), never lost in between — the fuzz
   band's settles-exactly-once invariant (tools/fuzz.py --ingress).

2. **Priority under pressure.**  Entries order by (fee desc, seeded
   tie-break, admission seq): batch selection drains highest-fee
   first, and when the pool is full a NEW submission bumps the
   lowest-priority *pending* entry only if it strictly outbids it —
   otherwise the newcomer waits.  In-flight entries (already drained
   into the TxQueue) are past the point of eviction.

3. **Determinism.**  The tie-break among equal fees is
   sha256(seed || digest) — a pure function of the config seed and
   the tx bytes — so two nodes (or two PYTHONHASHSEED arms) given the
   same submission stream admit, order, and evict identically.  No
   wall clock, no id(), no hash() anywhere in the policy.

Dedup layering: the mempool's bounded seen-ring is the cheap front
door (a resubmit never re-enters the pool); the committed-history
filter at batch selection (HoneyBadger._load_candidate_txs) remains
the authoritative settle-time dedup.  ``mark_settled`` is the
coordination point — settling a tx retires its in-flight accounting,
frees the client's cap slot, and leaves the digest in the seen-ring so
late resubmits still ack DUPLICATE.
"""

from __future__ import annotations

import collections
import hashlib
import heapq
from typing import Callable, Deque, Dict, Iterable, List, NamedTuple, Optional, Tuple

from cleisthenes_tpu_torch.core.merge import lane_of
from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_lock

# admission verdicts (mirrored onto the wire as
# transport.message.IngressStatus; core stays transport-free)
OK = "ok"
DUPLICATE = "duplicate"
REJECTED = "rejected"
RETRY_AFTER = "retry_after"

# a tx larger than this is rejected outright (same order as the wire
# field cap; a mempool must bound its per-entry memory)
MAX_TX_BYTES = 1 << 20


class Admission(NamedTuple):
    """One admit() verdict: ``status`` is OK/DUPLICATE/REJECTED/
    RETRY_AFTER, ``retry_after_ms`` is nonzero only for RETRY_AFTER,
    ``reason`` is a human-readable cause, ``digest`` names the tx."""

    status: str
    retry_after_ms: int
    reason: str
    digest: bytes


class _Entry:
    __slots__ = (
        "digest", "client_id", "fee", "tb", "seq", "tx", "drained", "lane",
    )

    def __init__(self, digest, client_id, fee, tb, seq, tx, lane=0):
        self.digest = digest
        self.client_id = client_id
        self.fee = fee
        self.tb = tb
        self.seq = seq
        self.tx = tx
        self.drained = False
        self.lane = lane


def tx_digest(tx: bytes) -> bytes:
    """The mempool's name for a transaction: sha256 of its bytes."""
    return hashlib.sha256(tx).digest()


@guarded_by(
    "_lock",
    "_live",
    "_seen",
    "_by_client",
    "_drain_heaps",
    "_evict_heap",
    "_seq",
    "_lane_pending",
)
class Mempool:
    """One node's fee-priority admission pool.  Thread-safe: admit()
    runs on gRPC ingress threads while drain_into()/mark_settled()
    run on the protocol dispatcher."""

    def __init__(
        self,
        *,
        capacity: int,
        client_cap: int = 64,
        seen_cap: int = 1 << 16,
        retry_after_ms: int = 100,
        seed: int = 0,
        on_evict: Optional[Callable[[bytes, str], None]] = None,
        lanes: int = 1,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        if client_cap < 1 or seen_cap < 1:
            raise ValueError(
                f"client_cap={client_cap} seen_cap={seen_cap}: both "
                "must be >= 1"
            )
        if lanes < 1:
            raise ValueError(f"lanes={lanes} must be >= 1")
        self.capacity = capacity
        self.client_cap = client_cap
        self.seen_cap = seen_cap
        self.retry_after_ms = retry_after_ms
        self.lanes = lanes
        self._seed = seed
        self._tb_seed = seed.to_bytes(8, "big", signed=True)
        self._on_evict = on_evict
        self._lock = new_lock()
        # digest -> entry, pending AND in-flight (drained, unsettled)
        self._live: Dict[bytes, _Entry] = {}
        # bounded FIFO dedup ring: admitted + settled digests
        self._seen: Deque[bytes] = collections.deque()
        self._seen_set: set = set()
        # client -> live (pending + in-flight) entry count
        self._by_client: Dict[str, int] = {}
        # lazy-deletion heaps over PENDING entries; stale slots are
        # skipped at pop when the digest is gone or already drained.
        # One drain heap PER LANE (horizontal shard-out): admission
        # routes each entry to lane_of(seed, digest, lanes) and each
        # lane's batch selection drains only its own heap, so the
        # per-lane ledgers stay disjoint.  lanes=1 keeps the single
        # heap and bit-identical drain order.  Eviction stays global
        # (the lowest-priority pending entry across all lanes).
        self._drain_heaps: List[List[Tuple[int, bytes, int, bytes]]] = [
            [] for _ in range(lanes)
        ]
        self._evict_heap: List[Tuple[int, bytes, int, bytes]] = []
        self._seq = 0
        # per-lane gauges/fill counters (partition-skew reporting)
        self._lane_pending: List[int] = [0] * lanes
        self.lane_admitted: List[int] = [0] * lanes
        # lifetime counters (the ingress metrics block reads these)
        self.submitted = 0
        self.admitted = 0
        self.deduped = 0
        self.rejected = 0
        self.retried = 0
        self.evicted = 0

    # -- policy helpers (pure; no lock needed) --------------------------

    def _tiebreak(self, digest: bytes) -> bytes:
        """Seeded, hash()-free order among equal fees: a pure function
        of (seed, digest), identical across nodes and interpreter
        hash randomization."""
        return hashlib.sha256(self._tb_seed + digest).digest()[:16]

    @staticmethod
    def _inv(tb: bytes) -> bytes:
        """Byte-wise complement: reverses the tb order so the eviction
        min-heap surfaces the entry the drain order ranks LAST."""
        return bytes(255 - b for b in tb)

    def _outranks(self, fee: int, tb: bytes, e: "_Entry") -> bool:
        """Does (fee, tb) strictly outbid entry ``e`` in drain order?"""
        return (fee, self._inv(tb)) > (e.fee, self._inv(e.tb))

    # -- admission ------------------------------------------------------

    def admit(self, tx: bytes, client_id: str, fee: int) -> Admission:
        """Admit one client transaction; returns an explicit verdict
        (promise 1 above: never a silent drop)."""
        digest = tx_digest(tx)
        with self._lock:
            self.submitted += 1
            if not tx or len(tx) > MAX_TX_BYTES or fee < 0:
                self.rejected += 1
                return Admission(
                    REJECTED, 0,
                    "empty tx" if not tx else (
                        f"tx of {len(tx)} bytes exceeds cap"
                        if len(tx) > MAX_TX_BYTES else "negative fee"
                    ),
                    digest,
                )
            if digest in self._seen_set:
                self.deduped += 1
                return Admission(
                    DUPLICATE, 0, "tx already pending or settled", digest
                )
            if self._by_client.get(client_id, 0) >= self.client_cap:
                self.retried += 1
                return Admission(
                    RETRY_AFTER, self.retry_after_ms,
                    f"client has {self.client_cap} txs in flight",
                    digest,
                )
            tb = self._tiebreak(digest)
            if len(self._live) >= self.capacity:
                victim = self._lowest_pending_locked()
                if victim is None or not self._outranks(fee, tb, victim):
                    # full of equal-or-better work: the newcomer waits
                    self.retried += 1
                    return Admission(
                        RETRY_AFTER, self.retry_after_ms,
                        "mempool at capacity", digest,
                    )
                self._evict_locked(victim)
            self._seq += 1
            lane = (
                lane_of(self._seed, digest, self.lanes)
                if self.lanes > 1
                else 0
            )
            e = _Entry(digest, client_id, fee, tb, self._seq, tx, lane)
            self._live[digest] = e
            self._by_client[client_id] = (
                self._by_client.get(client_id, 0) + 1
            )
            self._remember_locked(digest)
            heapq.heappush(
                self._drain_heaps[lane], (-fee, tb, e.seq, digest)
            )
            heapq.heappush(
                self._evict_heap, (fee, self._inv(tb), -e.seq, digest)
            )
            self.admitted += 1
            self.lane_admitted[lane] += 1
            self._lane_pending[lane] += 1
            return Admission(OK, 0, "", digest)

    def _remember_locked(self, digest: bytes) -> None:
        self._seen.append(digest)
        self._seen_set.add(digest)
        while len(self._seen) > self.seen_cap:
            old = self._seen.popleft()
            self._seen_set.discard(old)

    def _lowest_pending_locked(self) -> Optional[_Entry]:
        """The pending entry the drain order ranks last (lazy-deletion
        scan of the eviction heap; in-flight entries are skipped AND
        popped — they can never become eviction candidates again)."""
        while self._evict_heap:
            fee, inv_tb, neg_seq, digest = self._evict_heap[0]
            e = self._live.get(digest)
            if e is None or e.drained or e.seq != -neg_seq:
                heapq.heappop(self._evict_heap)
                continue
            return e
        return None

    def _evict_locked(self, e: "_Entry") -> None:
        heapq.heappop(self._evict_heap)
        del self._live[e.digest]
        self._lane_pending[e.lane] -= 1
        self._dec_client_locked(e.client_id)
        # an evicted digest stays in the seen-ring: a resubmit of it
        # acks DUPLICATE until the ring forgets it, which is the
        # documented cost of the bounded-memory front door
        self.evicted += 1
        if self._on_evict is not None:
            self._on_evict(e.digest, e.client_id)

    def _dec_client_locked(self, client_id: str) -> None:
        n = self._by_client.get(client_id, 0) - 1
        if n <= 0:
            self._by_client.pop(client_id, None)
        else:
            self._by_client[client_id] = n

    # -- the TxQueue seam ----------------------------------------------

    def drain_into(self, queue, max_n: int, lane: int = 0) -> int:
        """Move up to ``max_n`` highest-priority pending txs of
        ``lane`` into the FIFO TxQueue ahead of batch selection (the
        single-lane build always drains lane 0, the only heap).
        Drained entries stay live (in flight) for client-cap
        accounting and the settles-exactly-once ledger until
        mark_settled retires them."""
        moved = 0
        with self._lock:
            heap = self._drain_heaps[lane]
            while moved < max_n and heap:
                neg_fee, tb, seq, digest = heap[0]
                e = self._live.get(digest)
                if e is None or e.drained or e.seq != seq:
                    heapq.heappop(heap)
                    continue
                heapq.heappop(heap)
                e.drained = True
                self._lane_pending[e.lane] -= 1
                queue.push(e.tx)
                moved += 1
        return moved

    # -- settle-time coordination --------------------------------------

    def mark_settled(self, txs: Iterable[bytes]) -> None:
        """Retire settled txs: frees the client's cap slot and the
        entry's memory; the digest stays in the seen-ring so a late
        resubmit still acks DUPLICATE."""
        with self._lock:
            for tx in txs:
                digest = tx_digest(tx)
                e = self._live.pop(digest, None)
                if e is not None:
                    if not e.drained:
                        # settled from a PEER's proposal while still
                        # pending here: retire the lane gauge too
                        self._lane_pending[e.lane] -= 1
                    self._dec_client_locked(e.client_id)

    # -- introspection --------------------------------------------------

    def pending_count(self, lane: Optional[int] = None) -> int:
        """Entries admitted but not yet drained into the TxQueue
        (optionally of one lane only — the lane's propose gate)."""
        with self._lock:
            if lane is not None:
                return self._lane_pending[lane]
            return sum(1 for e in self._live.values() if not e.drained)

    def lane_fill(self) -> List[int]:
        """Lifetime admissions per lane — the partition-skew witness
        (loadgen reports max/min over this; snapshot()["lanes"]
        carries the spread)."""
        with self._lock:
            return list(self.lane_admitted)

    def inflight_count(self) -> int:
        """Entries drained into the TxQueue but not yet settled."""
        with self._lock:
            return sum(1 for e in self._live.values() if e.drained)

    def depth(self) -> int:
        """All live (pending + in-flight) entries — the gauge the
        queue-backpressure SLO watchdog reads."""
        with self._lock:
            return len(self._live)

    def __len__(self) -> int:
        return self.depth()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "submitted": self.submitted,
                "admitted": self.admitted,
                "deduped": self.deduped,
                "rejected": self.rejected,
                "retried": self.retried,
                "evicted": self.evicted,
                "depth": len(self._live),
            }


__all__ = [
    "Admission",
    "Mempool",
    "MAX_TX_BYTES",
    "OK",
    "DUPLICATE",
    "REJECTED",
    "RETRY_AFTER",
    "tx_digest",
]
