"""The port's robustness planes against the reference's, at zero
tolerance: the cross-lane merge (core/merge.py), the fee-priority
mempool (core/mempool.py), the wire adversary (utils/adversary.py), the
semantic Byzantine behaviours (protocol/byzantine.py) and the client
ingress plane (transport/ingress.py).

Every input comes from a numpy seed and goes through both packages; the
outputs must be equal value for value and byte for byte.  The semantic
coalitions run N=7, f=2 ``SimulatedCluster``s of both packages on the
host backend, and two of them also on the port's ``'cuda'`` backend on
``device='cpu'`` (the kernels' plain versions) against the reference's
``'tpu'`` (JAX on the CPU, its RS host floor set to 0 as in
tests/test_torch_async_parity.py)."""

import numpy as np
import pytest

from cleisthenes_tpu.config import Config as RefConfig
from cleisthenes_tpu.core import mempool as ref_mempool
from cleisthenes_tpu.core import merge as ref_merge
from cleisthenes_tpu.core.ledger import encode_batch_body as ref_body
from cleisthenes_tpu.ops import rs_xla
from cleisthenes_tpu.protocol import byzantine as ref_byzantine
from cleisthenes_tpu.protocol.cluster import SimulatedCluster as RefCluster
from cleisthenes_tpu.transport import message as ref_message
from cleisthenes_tpu.utils import adversary as ref_adversary
from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core import mempool, merge
from cleisthenes_tpu_torch.core.ledger import encode_batch_body
from cleisthenes_tpu_torch.protocol import byzantine
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster
from cleisthenes_tpu_torch.transport import message
from cleisthenes_tpu_torch.utils import adversary

SEMANTIC_KINDS = (
    "share_forger",
    "bad_dealer",
    "equivocator",
    "split_voter",
    "selective_mute",
    "epoch_sprayer",
)


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanes", range(1, 9))
def test_lane_of_matches_reference(lanes):
    rng = np.random.default_rng(100 + lanes)
    digests = [rng.bytes(32) for _ in range(4096)]
    for seed in (None, 0, 7, -3, 2**40):
        got = [merge.lane_of(seed, d, lanes) for d in digests]
        assert got == [ref_merge.lane_of(seed, d, lanes) for d in digests]
        assert set(got) <= set(range(lanes))


@pytest.mark.parametrize("lanes", [1, 3, 4, 8])
def test_merge_cursor_and_merge_order_match_reference(lanes):
    """A seeded push schedule: each lane settles its epochs in order,
    the lanes interleave at random, and both cursors drain after every
    push."""
    rng = np.random.default_rng(7 * lanes)
    depth = [int(d) for d in rng.integers(0, 12, size=lanes)]
    todo = [(lane, epoch) for lane in range(lanes) for epoch in range(depth[lane])]
    order = rng.permutation(len(todo))
    next_epoch = [0] * lanes
    ours, ref = merge.MergeCursor(lanes), ref_merge.MergeCursor(lanes)
    for i in order:
        lane = todo[i][0]
        epoch = next_epoch[lane]
        next_epoch[lane] += 1
        batch = b"lane%d-epoch%d" % (lane, epoch)
        ours.push(lane, epoch, batch)
        ref.push(lane, epoch, batch)
        assert ours.drain() == ref.drain()
        assert ours.frontier == ref.frontier
    assert ours.merged == ref.merged
    settled = [
        [b"s%d-%d" % (lane, e) for e in range(depth[lane])]
        for lane in range(lanes)
    ]
    assert merge.merge_order(settled) == ref_merge.merge_order(settled)
    with pytest.raises(ValueError):
        ours.push(lanes, 0, b"x")


# ---------------------------------------------------------------------------
# mempool
# ---------------------------------------------------------------------------


class _Sink:
    def __init__(self):
        self.items = []

    def push(self, tx):
        self.items.append(tx)


def _mempool_trace(module, lanes):
    """Drive one Mempool through a seeded 2,000-entry admission stream
    (duplicates, empty and negative-fee txs, clients over their cap,
    eviction pressure) with drains and settles in between; returns
    everything it said."""
    rng = np.random.default_rng(31 + lanes)
    evicted = []
    pool = module.Mempool(
        capacity=48, client_cap=6, seen_cap=400, retry_after_ms=25, seed=9,
        on_evict=lambda digest, client: evicted.append((digest, client)),
        lanes=lanes,
    )
    out, sent, drained = [], [], []
    for i in range(2000):
        op = rng.random()
        if op < 0.06:
            sink = _Sink()
            lane = int(rng.integers(0, lanes))
            moved = pool.drain_into(sink, int(rng.integers(1, 16)), lane=lane)
            out.append(("drain", lane, moved, tuple(sink.items)))
            drained.extend(sink.items)
            continue
        if op < 0.09 and drained:
            k = int(rng.integers(1, len(drained) + 1))
            settled, drained = drained[:k], drained[k:]
            pool.mark_settled(settled)
            out.append(("settle", len(settled)))
            continue
        if op < 0.2 and sent:
            tx = sent[int(rng.integers(0, len(sent)))]
        elif op < 0.21:
            tx = b""
        else:
            tx = rng.bytes(int(rng.integers(1, 80)))
            sent.append(tx)
        client = "client-%02d" % int(rng.integers(0, 14))
        fee = int(rng.integers(-1, 60))
        out.append(("admit", tuple(pool.admit(tx, client, fee))))
    out.append(("stats", pool.stats(), pool.lane_fill()))
    out.append((pool.pending_count(), pool.inflight_count(), pool.depth()))
    out.append([pool.pending_count(lane) for lane in range(lanes)])
    return out, evicted


@pytest.mark.parametrize("lanes", [1, 3])
def test_mempool_admission_stream_matches_reference(lanes):
    ours, our_evicted = _mempool_trace(mempool, lanes)
    ref, ref_evicted = _mempool_trace(ref_mempool, lanes)
    assert ours == ref
    assert our_evicted == ref_evicted and len(our_evicted) > 0
    verdicts = {v[1][0] for v in ours if v[0] == "admit"}
    assert verdicts == {"ok", "duplicate", "rejected", "retry_after"}
    assert mempool.tx_digest(b"abc") == ref_mempool.tx_digest(b"abc")
    assert mempool.MAX_TX_BYTES == ref_mempool.MAX_TX_BYTES


# ---------------------------------------------------------------------------
# the wire adversary
# ---------------------------------------------------------------------------

FAULTS = {
    "drop": lambda c: c.drop(0.4),
    "tamper": lambda c: c.tamper(0.5),
    "duplicate": lambda c: c.duplicate(0.4, copies=3),
    "delay": lambda c: c.delay(0.3, hold=20),
    "reorder": lambda c: c.reorder(0.4, window=5),
    "replay": lambda c: c.replay(0.3),
    "all": lambda c: c.drop(0.1).tamper(0.1).duplicate(0.2).delay(0.1)
    .reorder(0.2).replay(0.2),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_coalition_filter_matches_reference(fault):
    rng = np.random.default_rng(sorted(FAULTS).index(fault))
    names = ["node%03d" % i for i in range(5)]
    ours = FAULTS[fault](adversary.Coalition(names[3:], seed=13))
    ref = FAULTS[fault](ref_adversary.Coalition(names[3:], seed=13))
    for _ in range(3000):
        s, r = (names[int(i)] for i in rng.integers(0, 5, size=2))
        wire = rng.bytes(int(rng.integers(1, 200)))
        assert ours.filter(s, r, wire) == ref.filter(s, r, wire)
    assert (ours.held_total, ours.released_total) == (
        ref.held_total,
        ref.released_total,
    )
    assert ours._captured == ref._captured


# ---------------------------------------------------------------------------
# the semantic behaviours
# ---------------------------------------------------------------------------

BAD = ("node005", "node006")


def _byzantine_run(pkg, cfg_cls, cluster_cls, kind, backend, **kw):
    cfg = cfg_cls(n=7, batch_size=8, seed=3, crypto_backend=backend, **kw)
    behaviors = {
        b: pkg.make_behavior(kind, seed=11 + i) for i, b in enumerate(BAD)
    }
    cluster = cluster_cls(config=cfg, key_seed=5, seed=3, behaviors=behaviors)
    honest = [i for i in cluster.ids if i not in BAD]
    rng = np.random.default_rng(17)
    for i in range(28):
        tx = b"tx-" + rng.bytes(24)
        cluster.submit(tx, node_id=honest[i % len(honest)])
    cluster.run_until_drained(max_rounds=30, skip=BAD)
    depth = cluster.assert_agreement(skip=BAD)
    assert depth >= 1
    return cluster


def _honest_ledgers(cluster, body):
    return {
        nid: [body(e, b) for e, b in enumerate(hb.committed_batches)]
        for nid, hb in cluster.nodes.items()
        if nid not in BAD
    }


def _check(kind, ref_backend, backend, **kw):
    ref = _byzantine_run(
        ref_byzantine, RefConfig, RefCluster, kind, ref_backend
    )
    ours = _byzantine_run(
        byzantine, Config, SimulatedCluster, kind, backend, **kw
    )
    assert _honest_ledgers(ours, encode_batch_body) == _honest_ledgers(
        ref, ref_body
    )
    rewrites = [ours.behaviors[b].rewrites for b in BAD]
    assert rewrites == [ref.behaviors[b].rewrites for b in BAD]
    assert all(r > 0 for r in rewrites), "the adversary never lied"
    assert ours._hub.stats() == ref._hub.stats()
    return ours, ref


@pytest.mark.parametrize("kind", SEMANTIC_KINDS)
def test_semantic_coalition_matches_reference_cpu(kind):
    _check(kind, "cpu", "cpu")


@pytest.mark.parametrize("kind", ["share_forger", "bad_dealer"])
def test_semantic_coalition_matches_reference_cuda(kind, monkeypatch):
    """The two reject paths the card carries: forged shares burn in the
    pooled CP check (K8's plain version here), forged branches and
    shards in the branch wave (K6's)."""
    monkeypatch.setattr(rs_xla.XlaErasureCoder, "HOST_FLOOR_BYTES", 0)
    ours, ref = _check(kind, "tpu", "cuda", device="cpu")
    assert ours._hub.wave_widths == ref._hub.wave_widths


def test_behavior_registry_matches_reference():
    assert sorted(byzantine.BEHAVIOR_KINDS) == sorted(ref_byzantine.BEHAVIOR_KINDS)
    assert set(SEMANTIC_KINDS) == set(byzantine.BEHAVIOR_KINDS) - {"tx_injector"}


# ---------------------------------------------------------------------------
# the ingress plane
# ---------------------------------------------------------------------------


def _ingress_run(pkg_message, cfg_cls, cluster_cls, frames):
    cluster = cluster_cls(
        config=cfg_cls(
            n=4, batch_size=8, seed=7, mempool_capacity=12,
            mempool_client_cap=4, crypto_backend="cpu",
        ),
        seed=7,
        key_seed=11,
        auto_propose=False,
    )
    gate = cluster.ingress()
    plane = gate._plane
    acks = [plane.submit_frame(f) for f in frames[:40]]
    feed = plane.subscribe(0)
    cluster.run_until_drained()
    acks += [plane.submit_frame(f) for f in frames[40:]]
    late = plane.subscribe(1)
    cluster.run_until_drained()
    streams = []
    for f in (feed, late):
        got = []
        while True:
            frame = f.next_frame(timeout=0.05)
            if frame is None:
                break
            got.append(frame)
        streams.append(got)
    return acks, streams


def test_ingress_plane_frames_match_reference():
    rng = np.random.default_rng(23)
    payloads = []
    for i in range(60):
        tx = b"" if i == 5 else rng.bytes(int(rng.integers(8, 40)))
        if i % 9 == 4:
            tx = payloads[-3][3]  # a resubmit: DUPLICATE
        payloads.append(
            ("client-%d" % int(rng.integers(0, 6)), i, int(rng.integers(0, 30)), tx)
        )
    frames = [
        message.encode_client_frame(message.IngressSubmitPayload(*p))
        for p in payloads
    ]
    assert frames == [
        ref_message.encode_client_frame(ref_message.IngressSubmitPayload(*p))
        for p in payloads
    ]
    ours = _ingress_run(message, Config, SimulatedCluster, frames)
    ref = _ingress_run(ref_message, RefConfig, RefCluster, frames)
    assert ours == ref
    acks, (feed, late) = ours
    statuses = {message.decode_client_frame(a).status for a in acks}
    assert len(statuses) >= 3
    assert len(feed) >= 2 and len(late) == len(feed) - 1
