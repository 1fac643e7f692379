# The reference's tests/test_lanes.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Horizontal shard-out: S parallel consensus
lanes over one roster with a deterministic cross-lane total-order merge.

Covers the acceptance matrix:

- merge rule unit coverage: ``lane_of`` purity/range, MergeCursor's
  epoch-major lane-minor slot order, ``seq = epoch * S + lane``, the
  out-of-range lane guard, and the wholesale ``merge_order`` oracle
  agreeing with the incremental cursor;
- the byte-equivalence baseline arm: ``lanes=1`` commits a ledger
  byte-identical to a default (pre-lane) Config on the same seed;
- the shard-out arm: ``lanes=4`` honest nodes hold byte-identical
  merged total orders, deterministic across independent runs, with
  every submitted tx settling exactly once in its partitioned lane;
- crash/WAL-restart at lanes=4: the lane-tagged record streams replay
  every lane's frontier and the restarted node keeps committing;
- LanePayload wire framing: codec round-trip under kind 21, nesting
  rejection both ways (no lane-in-lane, no bundle-in-lane), wire-range
  guard;
- mempool lane partitioning: admission routes by ``lane_of``,
  ``drain_into(lane=k)`` drains only that lane's heap, ``lane_fill``
  witnesses the partition;
- Config.validate bounds: 1 <= lanes <= MAX_LANES.
"""

from __future__ import annotations

import hashlib
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from cleisthenes_tpu_torch.config import MAX_LANES, Config  # noqa: E402
from cleisthenes_tpu_torch.core.ledger import encode_batch_body  # noqa: E402
from cleisthenes_tpu_torch.core.mempool import (  # noqa: E402
    OK,
    Mempool,
    tx_digest,
)
from cleisthenes_tpu_torch.core.merge import (  # noqa: E402
    MergeCursor,
    lane_of,
    merge_order,
)
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster  # noqa: E402
from cleisthenes_tpu_torch.transport.message import (  # noqa: E402
    BbaPayload,
    BbaType,
    BundlePayload,
    LanePayload,
    Message,
    RbcPayload,
    RbcType,
    decode_message,
    encode_message,
)


# ---------------------------------------------------------------------------
# merge rule units
# ---------------------------------------------------------------------------


def test_lane_of_purity_and_range():
    digests = [hashlib.sha256(b"t%d" % i).digest() for i in range(256)]
    for lanes in (2, 4, 8):
        got = [lane_of(7, d, lanes) for d in digests]
        # pure: identical on recomputation
        assert got == [lane_of(7, d, lanes) for d in digests]
        # range: every lane index valid, every lane actually hit at
        # this sample size (256 digests over <= 8 lanes)
        assert set(got) <= set(range(lanes))
        assert set(got) == set(range(lanes))
    # the seed re-keys the partition (operators can rebalance)
    four = [lane_of(7, d, 4) for d in digests]
    assert four != [lane_of(8, d, 4) for d in digests]
    # unseeded == seed 0 (the documented fallback), still deterministic
    assert [lane_of(None, d, 4) for d in digests] == [
        lane_of(0, d, 4) for d in digests
    ]
    # lanes <= 1 short-circuits to lane 0
    assert all(lane_of(7, d, 1) == 0 for d in digests[:8])


def test_merge_cursor_epoch_major_lane_minor():
    S = 3
    cur = MergeCursor(S)
    # settle out of wall-clock order: lane 2 races ahead, lane 0 lags
    cur.push(2, 0, "L2E0")
    cur.push(1, 0, "L1E0")
    cur.push(2, 1, "L2E1")
    assert cur.drain() == []  # slot (0,0) missing: nothing emittable
    assert cur.frontier == 0
    cur.push(0, 0, "L0E0")
    rows = cur.drain()
    # emits through the first hole only: epoch 0 complete, epoch 1
    # blocked on lane 0
    assert rows == [
        (0, 0, 0, "L0E0"),
        (1, 1, 0, "L1E0"),
        (2, 2, 0, "L2E0"),
    ]
    assert all(seq == epoch * S + lane for seq, lane, epoch, _ in rows)
    assert cur.frontier == 3
    cur.push(0, 1, "L0E1")
    cur.push(1, 1, "L1E1")
    assert [r[3] for r in cur.drain()] == ["L0E1", "L1E1", "L2E1"]
    assert cur.merged == [
        "L0E0", "L1E0", "L2E0", "L0E1", "L1E1", "L2E1",
    ]


def test_merge_cursor_rejects_out_of_range_lane():
    cur = MergeCursor(2)
    with pytest.raises(ValueError):
        cur.push(2, 0, "x")
    with pytest.raises(ValueError):
        cur.push(-1, 0, "x")
    with pytest.raises(ValueError):
        MergeCursor(0)


def test_merge_order_oracle_matches_cursor():
    # ragged settled prefixes: the wholesale oracle and the
    # incremental cursor must agree on the emittable prefix
    settled = [
        ["a0", "a1", "a2"],
        ["b0"],
        ["c0", "c1"],
    ]
    got = merge_order(settled)
    # epoch 0 complete; epoch 1 blocked at lane 1 after emitting a1
    assert got == ["a0", "b0", "c0", "a1"]
    cur = MergeCursor(3)
    for lane, batches in enumerate(settled):
        for epoch, batch in enumerate(batches):
            cur.push(lane, epoch, batch)
            cur.drain()
    assert cur.merged == got


# ---------------------------------------------------------------------------
# cluster equivalence: lanes=1 baseline, lanes=4 shard-out
# ---------------------------------------------------------------------------


def _merged_digest(cluster: SimulatedCluster, nid: str) -> str:
    h = hashlib.sha256()
    for seq, batch in enumerate(cluster.nodes[nid].merged_batches):
        h.update(encode_batch_body(seq, batch))
    return h.hexdigest()


def _run_cluster(lanes: int, txs: int = 48, seed: int = 9, **kw):
    cfg = Config(
        n=4, batch_size=8, seed=seed, lanes=lanes, crypto_backend="cpu"
    )
    cluster = SimulatedCluster(config=cfg, seed=seed, key_seed=3, **kw)
    for i in range(txs):
        cluster.submit(b"ln-tx-%04d" % i)
    cluster.run_until_drained(max_rounds=200)
    return cluster


def test_lanes1_byte_identical_to_default_build():
    """The byte-equivalence baseline arm: lanes=1 must be
    indistinguishable from a Config that never mentions lanes."""
    base = SimulatedCluster(
        config=Config(n=4, batch_size=8, seed=9, crypto_backend="cpu"),
        seed=9,
        key_seed=3,
    )
    armed = _run_cluster(lanes=1)
    for i in range(48):
        base.submit(b"ln-tx-%04d" % i)
    base.run_until_drained(max_rounds=200)
    base.assert_agreement()
    armed.assert_agreement()
    for nid in base.ids:
        assert _merged_digest(base, nid) == _merged_digest(armed, nid)
    # no lane machinery was ever built: self.lanes is [self]
    hb = armed.nodes[armed.ids[0]]
    assert hb.lanes == [hb]
    assert hb.merged_batches == hb.committed_batches


def test_lanes4_merged_orders_agree_and_settle_exactly_once():
    cluster = _run_cluster(lanes=4)
    depth = cluster.assert_agreement()
    assert depth > 0
    digests = {_merged_digest(cluster, nid) for nid in cluster.ids}
    assert len(digests) == 1, "honest merged orders diverged"
    # every submitted tx settled exactly once, in the lane the
    # production partitioner routed it to
    hb = cluster.nodes[cluster.ids[0]]
    assert len(hb.lanes) == 4
    seed = hb.config.seed
    seen = {}
    for lane_idx, lane in enumerate(hb.lanes):
        for batch in lane.committed_batches:
            for tx in (
                t for v in batch.contributions.values() for t in v
            ):
                assert tx not in seen, "tx settled twice"
                seen[tx] = lane_idx
                assert lane_of(seed, tx_digest(tx), 4) == lane_idx
    assert len(seen) == 48
    # every lane actually ordered something (the partition spread txs)
    assert all(lane.epoch > 0 for lane in hb.lanes)
    # the merged frontier counts ALL lanes' settled slots
    assert hb.merged_settled_frontier == sum(
        len(lane.committed_batches) for lane in hb.lanes
    )


def test_lanes4_deterministic_across_runs():
    a = _run_cluster(lanes=4)
    b = _run_cluster(lanes=4)
    a.assert_agreement()
    b.assert_agreement()
    assert _merged_digest(a, a.ids[0]) == _merged_digest(b, b.ids[0])


# ---------------------------------------------------------------------------
# crash / WAL restart at lanes=4 (lane-tagged record streams)
# ---------------------------------------------------------------------------


def test_wal_restart_recovers_all_lane_frontiers(tmp_path):
    cfg = Config(n=4, batch_size=8, seed=9, lanes=4, crypto_backend="cpu")
    c = SimulatedCluster(
        config=cfg, seed=9, key_seed=3, wal_dir=str(tmp_path)
    )
    try:
        for i in range(48):
            c.submit(b"wl-tx-%04d" % i)
        c.run_until_drained(max_rounds=200)
        victim = c.ids[1]
        pre = c.nodes[victim]
        pre_frontiers = [len(l.committed_batches) for l in pre.lanes]
        pre_merged = _merged_digest(c, victim)
        assert sum(pre_frontiers) > 0
        # fail-stop + process restart from the lane-tagged WAL
        c.crash(victim)
        hb2 = c.restart_node(victim)
        assert len(hb2.lanes) == 4
        assert [
            len(l.committed_batches) for l in hb2.lanes
        ] == pre_frontiers
        assert _merged_digest(c, victim) == pre_merged
        # the restarted node keeps ordering across every lane
        for i in range(48, 96):
            c.submit(b"wl-tx-%04d" % i)
        c.run_until_drained(max_rounds=200)
        depth = c.assert_agreement()
        assert depth > sum(pre_frontiers)
        post = [len(l.committed_batches) for l in hb2.lanes]
        assert all(p >= q for p, q in zip(post, pre_frontiers))
        assert sum(post) > sum(pre_frontiers)
        digests = {_merged_digest(c, nid) for nid in c.ids}
        assert len(digests) == 1
    finally:
        c.stop()


# ---------------------------------------------------------------------------
# LanePayload wire framing (kind 21)
# ---------------------------------------------------------------------------


def _inner_payloads():
    return [
        RbcPayload(RbcType.READY, "p", 3, b"h" * 32),
        BbaPayload(BbaType.AUX, "n1", 2, 0, False),
    ]


def test_lane_payload_round_trip():
    for lane in (0, 1, 7, 255):
        for inner in _inner_payloads():
            msg = Message("n0", 1.5, LanePayload(lane, inner), b"sig")
            out = decode_message(encode_message(msg))
            assert out == msg
            assert out.payload.lane == lane
            assert out.payload.inner == inner
    # lane frames ride inside coalesced bundles like any payload
    bundle = BundlePayload(
        tuple(
            LanePayload(k, p)
            for k in (0, 3)
            for p in _inner_payloads()
        )
    )
    msg = Message("n0", 1.5, bundle, b"sig")
    assert decode_message(encode_message(msg)) == msg


def test_lane_payload_nesting_and_range_rejected():
    inner = RbcPayload(RbcType.READY, "p", 0, b"h")
    # no lane-in-lane, no bundle-in-lane: the lane axis is
    # outermost-but-one
    for bad in (
        LanePayload(1, LanePayload(0, inner)),
        LanePayload(1, BundlePayload((inner,))),
    ):
        with pytest.raises(ValueError):
            encode_message(Message("n0", 0.0, bad, b"s"))
    with pytest.raises(ValueError):
        encode_message(
            Message("n0", 0.0, LanePayload(256, inner), b"s")
        )


# ---------------------------------------------------------------------------
# mempool lane partitioning
# ---------------------------------------------------------------------------


class _SinkQueue:
    def __init__(self):
        self.items = []

    def push(self, tx):
        self.items.append(tx)


def test_mempool_partitions_admission_by_lane():
    pool = Mempool(capacity=64, seed=7, lanes=4)
    txs = [b"mp-%03d" % i for i in range(32)]
    for i, tx in enumerate(txs):
        assert pool.admit(tx, "c%d" % (i % 8), fee=10 + i).status == OK
    fill = pool.lane_fill()
    assert sum(fill) == 32
    by_lane = {}
    for tx in txs:
        by_lane.setdefault(lane_of(7, tx_digest(tx), 4), []).append(tx)
    assert fill == [len(by_lane.get(k, [])) for k in range(4)]
    # drain_into(lane=k) surfaces ONLY that lane's txs, highest fee
    # first; other lanes' gauges are untouched
    for k in range(4):
        q = _SinkQueue()
        moved = pool.drain_into(q, max_n=64, lane=k)
        assert moved == len(by_lane.get(k, []))
        assert set(q.items) == set(by_lane.get(k, []))
        fees = [txs.index(t) for t in q.items]
        assert fees == sorted(fees, reverse=True)
    assert pool.pending_count() == 0


# ---------------------------------------------------------------------------
# Config bounds
# ---------------------------------------------------------------------------


def test_config_validates_lane_bounds():
    Config(n=4, lanes=MAX_LANES)  # the cap itself is legal
    with pytest.raises(ValueError):
        Config(n=4, lanes=0)
    with pytest.raises(ValueError):
        Config(n=4, lanes=MAX_LANES + 1)
