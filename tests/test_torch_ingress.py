# The reference's tests/test_ingress.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Client ingress plane (transport/ingress.py), end to end.

The surface under test is the production admission/subscription path:
encoded client frames -> IngressPlane -> fee-priority mempool ->
TxQueue -> settled batches -> subscription feeds.  The in-proc twin
(SimulatedCluster.ingress) and the real gRPC mount on ValidatorHost
run the IDENTICAL plane code, so the channel-transport tests here and
the socket round-trip exercise one code path.

Contract: explicit acks (OK/DUPLICATE/REJECTED/RETRY_AFTER) carrying
the admitting node's two commit frontiers; dedup coordinated across
ingress admission AND settle time; subscribe(from_epoch) replays
committed history then follows the live settled tail with no gap and
no duplicate at the seam; the whole plane is a pure function of the
seeds (cross-PYTHONHASHSEED subprocess replay).
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import threading

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.ledger import encode_batch_body
from cleisthenes_tpu_torch.core.mempool import MAX_TX_BYTES
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster
from cleisthenes_tpu_torch.protocol.honeybadger import setup_keys
from cleisthenes_tpu_torch.transport.host import ValidatorHost
from cleisthenes_tpu_torch.transport.ingress import IngressGrpcClient
from cleisthenes_tpu_torch.transport.message import IngressStatus

REPO = pathlib.Path(__file__).resolve().parent.parent


def _ingress_cluster(*, n: int = 4, seed: int = 7, capacity: int = 64,
                     client_cap: int = 64) -> SimulatedCluster:
    return SimulatedCluster(
        config=Config(
            n=n,
            batch_size=8,
            seed=seed,
            mempool_capacity=capacity,
            mempool_client_cap=client_cap,
            crypto_backend="cpu",
        ),
        seed=seed,
        key_seed=11,
        auto_propose=False,
    )


def test_submit_ack_carries_frontiers_and_settles_once():
    """An OK ack carries the admitting node's ordered/settled
    frontiers; the tx settles exactly once on every node."""
    cluster = _ingress_cluster()
    gate = cluster.ingress()
    ack = gate.submit("alice", 0, 5, b"tx-hello")
    assert IngressStatus(ack.status) is IngressStatus.OK
    assert (ack.client_id, ack.nonce) == ("alice", 0)
    assert ack.ordered_epoch == 0 and ack.settled_epoch == 0
    cluster.run_until_drained()
    assert cluster.assert_agreement() >= 1
    for nid in cluster.ids:
        settled = [
            tx
            for b in cluster.nodes[nid].committed_batches
            for tx in b.tx_list()
        ]
        assert settled.count(b"tx-hello") == 1
    # the frontiers in a fresh ack moved with the commit
    ack2 = gate.submit("alice", 1, 5, b"tx-second")
    assert ack2.settled_epoch >= 1


def test_dedup_across_ingress_and_settle():
    """One tx, three resubmit points — while pending, from another
    client, and AFTER settlement — all ack DUPLICATE; the ledger
    carries the bytes exactly once."""
    cluster = _ingress_cluster()
    gate = cluster.ingress()
    assert IngressStatus(
        gate.submit("c0", 0, 5, b"tx-once").status
    ) is IngressStatus.OK
    # pending: same bytes, same client / different client
    for client, nonce in (("c0", 1), ("c1", 0)):
        dup = gate.submit(client, nonce, 9, b"tx-once")
        assert IngressStatus(dup.status) is IngressStatus.DUPLICATE
    cluster.run_until_drained()
    # settled: the settle-time seen-ring still answers
    late = gate.submit("c2", 0, 99, b"tx-once")
    assert IngressStatus(late.status) is IngressStatus.DUPLICATE
    settled = [
        tx
        for b in cluster.nodes[cluster.ids[0]].committed_batches
        for tx in b.tx_list()
    ]
    assert settled.count(b"tx-once") == 1
    assert cluster.assert_agreement() >= 1


def test_backpressure_rejected_and_retry_after_acks():
    """Admission failures are explicit acks, never silent drops:
    malformed -> REJECTED; per-client cap and a full pool the bid
    does not outrank -> RETRY_AFTER with a backoff hint."""
    cluster = _ingress_cluster(capacity=2, client_cap=2)
    gate = cluster.ingress()
    bad = gate.submit("c0", 0, 1, b"x" * (MAX_TX_BYTES + 1))
    assert IngressStatus(bad.status) is IngressStatus.REJECTED
    assert IngressStatus(
        gate.submit("c0", 1, 10, b"tx-a").status
    ) is IngressStatus.OK
    assert IngressStatus(
        gate.submit("c0", 2, 10, b"tx-b").status
    ) is IngressStatus.OK
    # per-client cap (2 live) trips first for c0
    v = gate.submit("c0", 3, 10, b"tx-c")
    assert IngressStatus(v.status) is IngressStatus.RETRY_AFTER
    assert v.retry_after_ms > 0
    # global capacity (2) with a NON-outranking fee trips for c1
    v2 = gate.submit("c1", 0, 1, b"tx-d")
    assert IngressStatus(v2.status) is IngressStatus.RETRY_AFTER
    # ...and an outranking fee evicts instead of backing off
    v3 = gate.submit("c1", 1, 99, b"tx-e")
    assert IngressStatus(v3.status) is IngressStatus.OK


def test_subscribe_replays_then_follows_live_tail():
    """subscribe(from_epoch) replays committed history from the WAL
    state and then streams fresh settles, gap- and duplicate-free
    across the replay/live seam."""
    cluster = _ingress_cluster()
    gate = cluster.ingress()
    for i in range(3):
        gate.submit("c0", i, 5, b"warm-%02d" % i)
        cluster.run_until_drained()
    node = cluster.nodes[cluster.ids[0]]
    depth = len(node.committed_batches)
    assert depth >= 3
    feed = gate.subscribe(1)  # skip epoch 0: replay honors from_epoch
    replayed = []
    while True:
        b = gate.next_batch(feed, timeout=0.05)
        if b is None:
            break
        replayed.append(b)
    assert [b.epoch for b in replayed] == list(range(1, depth))
    for b in replayed:
        assert b.body == encode_batch_body(
            b.epoch, node.committed_batches[b.epoch]
        )
    # live tail: a new settle lands on the SAME feed, next epoch, once
    gate.submit("c0", 99, 5, b"tail-tx")
    cluster.run_until_drained()
    tail = gate.next_batch(feed, timeout=1.0)
    assert tail is not None and tail.epoch == depth
    assert b"tail-tx" in encode_batch_body(
        tail.epoch, node.committed_batches[tail.epoch]
    )
    assert gate.next_batch(feed, timeout=0.05) is None
    feed.close()


def test_grpc_roundtrip_on_real_validator_host():
    """The full socket path: 4 ValidatorHosts with ingress mounted,
    submits pipelined over real gRPC streams (acks in order), commits
    driven by the admission kick, and a gRPC subscriber streaming the
    settled batch."""
    n = 4
    cfg = Config(crypto_backend="cpu",
        n=n,
        batch_size=8,
        ingress_port=0,  # ephemeral: each host reports its bound port
        mempool_capacity=64,
    )
    ids = [f"node{i}" for i in range(n)]
    keys = setup_keys(cfg, ids, seed=55)
    hosts = {i: ValidatorHost(cfg, i, ids, keys[i]) for i in ids}
    clients = []
    try:
        addrs = {i: h.listen() for i, h in hosts.items()}
        threads = [
            threading.Thread(target=h.connect, args=(addrs,))
            for h in hosts.values()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        txs = [b"ingress-tx-%02d" % i for i in range(2 * n)]
        # every node admits its share over its own ingress socket, so
        # every node proposes (the on_admitted kick starts its epoch)
        for rank, nid in enumerate(ids):
            c = IngressGrpcClient(
                f"127.0.0.1:{hosts[nid].ingress_server.port}"
            )
            clients.append(c)
            batch = [
                (f"cli-{i % 3}", i, 1 + i % 5, tx)
                for i, tx in enumerate(txs)
                if i % n == rank
            ]
            acks = c.submit_many(batch)
            assert len(acks) == len(batch)
            assert all(
                IngressStatus(a.status) is IngressStatus.OK for a in acks
            )
            # acks come back in submit order (pipelined one stream)
            assert [a.nonce for a in acks] == [s[1] for s in batch]
        first = {i: h.wait_commit(timeout=60) for i, h in hosts.items()}
        bodies = {
            encode_batch_body(e, b) for e, b in first.values()
        }
        assert len(bodies) == 1
        committed = first[ids[0]][1].tx_list()
        assert set(committed) <= set(txs) and len(committed) > 0
        # subscription over the same socket streams that batch
        sub = clients[0].subscribe(0, timeout=30)
        streamed = next(sub)
        assert streamed.epoch == first[ids[0]][0]
        assert streamed.body == bodies.pop()
    finally:
        for c in clients:
            c.close()
        for h in hosts.values():
            h.stop()


# Runs the seeded loadgen (tiny band) through the in-proc ingress
# plane and prints the settled-ledger digest — the exact order-
# independent digest the acceptance harness compares across arms.
_DRIVER = r"""
from cleisthenes_tpu_torch.tools.loadgen import build_schedule, run_arm
sched = build_schedule(clients=300, txs=300, ticks=6, seed=9)
arm = run_arm(sched, depth=2, n=4, batch=64, seed=9, crypto="cpu")
print("LEDGER_DIGEST=%s settled=%d" % (arm["ledger_digest"],
                                       arm["settled"]))
"""


def test_ingress_plane_identical_across_hash_seeds():
    """Cross-PYTHONHASHSEED replay: the mempool's seeded tiebreak and
    the plane's admission path must leak no hash()-order, so two
    interpreters with different hash seeds settle byte-identical
    ledgers for the same client schedule."""
    digests = set()
    for hash_seed in ("0", "1"):
        proc = subprocess.run(
            [sys.executable, "-c", _DRIVER],
            capture_output=True,
            text=True,
            cwd=str(REPO),
            env={
                "PYTHONHASHSEED": hash_seed,
                "JAX_PLATFORMS": "cpu",
                "PATH": "/usr/bin:/bin",
            },
            timeout=600,
        )
        assert proc.returncode == 0, proc.stderr
        line = [
            ln for ln in proc.stdout.splitlines()
            if ln.startswith("LEDGER_DIGEST=")
        ][0]
        digests.add(line)
    assert len(digests) == 1, f"hash-seed-dependent ledger: {digests}"
