# The reference's tests/test_mempool.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Fee-priority mempool (core/mempool.py), unit level.

The admission contract under test: every admit() returns an explicit
verdict (OK / DUPLICATE / REJECTED / RETRY_AFTER — never a silent
drop); under pressure the pool evicts by priority, visibly, and only
when the newcomer strictly outbids the lowest pending entry; dedup
spans the entry's whole lifetime (pending, in flight, settled,
evicted) via the bounded seen-ring; equal-fee ordering is a seeded
pure function of the tx digest, identical across interpreters.
"""

from __future__ import annotations

import pytest

from cleisthenes_tpu_torch.core.mempool import (
    DUPLICATE,
    MAX_TX_BYTES,
    OK,
    REJECTED,
    RETRY_AFTER,
    Mempool,
    tx_digest,
)


class _Queue:
    """Minimal TxQueue stand-in recording drain order."""

    def __init__(self):
        self.items = []

    def push(self, tx):
        self.items.append(tx)


def _fill(pool, fees, client="c0"):
    txs = []
    for i, fee in enumerate(fees):
        tx = b"tx-%04d" % i
        assert pool.admit(tx, client, fee).status == OK
        txs.append(tx)
    return txs


def test_priority_eviction_order():
    """A full pool evicts its LOWEST-priority pending entry — and only
    for a newcomer that strictly outbids it; losers ack RETRY_AFTER."""
    evicted = []
    pool = Mempool(
        capacity=3, seed=7, on_evict=lambda d, c: evicted.append(d)
    )
    txs = _fill(pool, [10, 20, 30])
    # fee 40 outbids the fee-10 floor: admitted, floor evicted
    assert pool.admit(b"rich", "c1", 40).status == OK
    assert evicted == [tx_digest(txs[0])]
    assert pool.stats()["evicted"] == 1
    # fee 5 does NOT outbid the new fee-20 floor: visible RETRY_AFTER
    v = pool.admit(b"poor", "c1", 5)
    assert v.status == RETRY_AFTER
    assert v.retry_after_ms > 0
    assert pool.depth() == 3
    # an evicted tx stays in the seen-ring: resubmit acks DUPLICATE,
    # never a second OK for bytes the client already got an OK for
    assert pool.admit(txs[0], "c0", 99).status == DUPLICATE
    # drain order is fee-descending: 40, 30, 20
    q = _Queue()
    assert pool.drain_into(q, 10) == 3
    assert q.items == [b"rich", txs[2], txs[1]]


def test_equal_fee_order_is_seeded_and_digest_pure():
    """Equal-fee ordering is a pure function of (seed, digest): two
    pools with the same seed drain identically whatever the admission
    order; a different seed reorders the same txs."""
    txs = [b"tie-%04d" % i for i in range(8)]

    def drain_order(seed, order):
        pool = Mempool(capacity=16, seed=seed)
        for tx in order:
            assert pool.admit(tx, f"c{tx[-1]}", 5).status == OK
        q = _Queue()
        pool.drain_into(q, 16)
        return q.items

    a = drain_order(3, txs)
    b = drain_order(3, list(reversed(txs)))
    assert a == b
    assert drain_order(4, txs) != a


def test_backpressure_rejected_and_retry_after():
    """Malformed txs ack REJECTED; per-client and global pressure ack
    RETRY_AFTER carrying the configured backoff hint."""
    pool = Mempool(capacity=8, client_cap=2, retry_after_ms=250, seed=1)
    assert pool.admit(b"", "c0", 1).status == REJECTED
    assert pool.admit(b"x" * (MAX_TX_BYTES + 1), "c0", 1).status == REJECTED
    assert pool.admit(b"neg", "c0", -1).status == REJECTED
    assert pool.stats()["rejected"] == 3
    # per-client cap: the 3rd live tx from one client backs off
    assert pool.admit(b"a", "c0", 1).status == OK
    assert pool.admit(b"b", "c0", 1).status == OK
    v = pool.admit(b"c", "c0", 1)
    assert (v.status, v.retry_after_ms) == (RETRY_AFTER, 250)
    # other clients are unaffected by c0's cap
    assert pool.admit(b"c", "c1", 1).status == OK
    # settling frees the cap slot: c0 can submit fresh bytes again
    q = _Queue()
    pool.drain_into(q, 8)
    pool.mark_settled([b"a"])
    assert pool.admit(b"d", "c0", 1).status == OK


def test_dedup_spans_pending_inflight_and_settled():
    """DUPLICATE acks cover the full lifetime: pending, drained (in
    flight), and settled — the settle-time seen-ring keeps late
    resubmits idempotent after the entry's memory is freed."""
    pool = Mempool(capacity=8, seed=2)
    assert pool.admit(b"tx", "c0", 3).status == OK
    assert pool.admit(b"tx", "c9", 9).status == DUPLICATE  # pending
    q = _Queue()
    assert pool.drain_into(q, 8) == 1
    assert pool.admit(b"tx", "c0", 3).status == DUPLICATE  # in flight
    assert (pool.pending_count(), pool.inflight_count()) == (0, 1)
    pool.mark_settled([b"tx"])
    assert pool.depth() == 0
    assert pool.admit(b"tx", "c0", 3).status == DUPLICATE  # settled
    assert pool.stats()["deduped"] == 3


def test_seen_ring_is_bounded():
    """The dedup ring forgets oldest-first at seen_cap — bounded
    memory is the contract; a forgotten digest re-admits."""
    pool = Mempool(capacity=4, seen_cap=4, seed=0)
    assert pool.admit(b"old", "c0", 1).status == OK
    q = _Queue()
    pool.drain_into(q, 4)
    pool.mark_settled([b"old"])
    for i in range(4):  # push b"old" out of the 4-slot ring
        tx = b"new-%d" % i
        assert pool.admit(tx, "c1", 1).status == OK
        pool.drain_into(q, 4)
        pool.mark_settled([tx])
    assert pool.admit(b"old", "c0", 1).status == OK


def test_capacity_validation():
    with pytest.raises(ValueError):
        Mempool(capacity=0)
    with pytest.raises(ValueError):
        Mempool(capacity=1, client_cap=0)
