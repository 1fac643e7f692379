# The reference's tests/test_order_settle.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Two-frontier commit split tests (Config.order_then_settle).

Covers the acceptance matrix:

- equivalence: the split arm's SETTLED plaintext log is byte-identical
  to the coupled arm's committed log for the same seed, on the channel
  transport and over real gRPC;
- crash/restart over the ordered-ahead window: a WAL torn between
  ``COrd`` and ``CLOG`` restarts into the settler and recovers with no
  loss, no duplicate and NO re-ordering — via the re-issued dec-share
  exchange when the whole roster tore, via CLOG catch-up when peers
  settled first;
- backpressure: the ordered frontier never runs more than
  ``decrypt_lag_max`` epochs past settlement, and progress still
  completes at the tightest bound;
- ordered CATCHUP: ``COrd`` bodies serve/adopt on f+1 byte-identical
  quorums, advancing a laggard's ordered frontier into a settle-only
  state;
- the settle-stall SLO watchdog and the wire codec for the new
  CatchupOrd payload (TLV + reference-pb framing).
"""

from __future__ import annotations

import hashlib
import os
import struct
import threading
import time

import pytest

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.ledger import (
    BatchLog,
    decode_ordered_body,
    encode_batch_body,
    encode_ordered_body,
)
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster
from cleisthenes_tpu_torch.protocol.honeybadger import HoneyBadger, setup_keys
from cleisthenes_tpu_torch.transport.broadcast import ChannelBroadcaster
from cleisthenes_tpu_torch.transport.channel import ChannelNetwork


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _ledger_digest(cluster: SimulatedCluster) -> str:
    h = hashlib.sha256()
    for nid in cluster.ids:
        for epoch, batch in enumerate(
            cluster.nodes[nid].committed_batches
        ):
            h.update(encode_batch_body(epoch, batch))
    return h.hexdigest()


def _run_cluster(order_then_settle: bool, txs: int = 48) -> tuple:
    cluster = SimulatedCluster(
        config=Config(
            n=4,
            batch_size=16,
            seed=5,
            order_then_settle=order_then_settle, crypto_backend="cpu",
        ),
        seed=5,
        key_seed=3,
    )
    for i in range(txs):
        cluster.submit(b"os-tx-%04d" % i)
    cluster.run_epochs()
    depth = cluster.assert_agreement()
    return _ledger_digest(cluster), depth, cluster


def _tear_last_clog(path: str) -> None:
    """Drop the newest CLOG record from a WAL, leaving its epoch's
    COrd in place — the crash-between-order-and-settle window."""
    data = open(path, "rb").read()
    recs = []
    off = 0
    while off + 8 <= len(data):
        (ln,) = struct.unpack_from(">I", data, off + 4)
        end = off + 8 + ln + 4
        recs.append((data[off : off + 4], data[off:end]))
        off = end
    for i in range(len(recs) - 1, -1, -1):
        if recs[i][0] == b"CLOG":
            del recs[i]
            break
    else:
        raise AssertionError(f"no CLOG record in {path}")
    with open(path, "wb") as fh:
        fh.write(b"".join(rec for _, rec in recs))


def _build_wal_cluster(cfg, ids, keys, logdir, net):
    nodes = {}
    for nid in ids:
        nodes[nid] = HoneyBadger(
            config=cfg,
            node_id=nid,
            member_ids=ids,
            keys=keys[nid],
            out=ChannelBroadcaster(net, nid, ids),
            batch_log=BatchLog(os.path.join(logdir, nid + ".log")),
        )
        net.join(nid, nodes[nid], None)
    return nodes


# ---------------------------------------------------------------------------
# equivalence: split vs coupled commit identical plaintext
# ---------------------------------------------------------------------------


def test_split_vs_coupled_identical_settled_ledgers_channel():
    split, split_depth, c1 = _run_cluster(order_then_settle=True)
    coupled, coupled_depth, c2 = _run_cluster(order_then_settle=False)
    assert split_depth >= 2 and split_depth == coupled_depth
    assert split == coupled, (
        "two-frontier settled log diverged from the coupled arm"
    )
    n0 = c1.nodes[c1.ids[0]]
    # the split actually ran: every settled epoch was ordered first,
    # with a durable canonical COrd body
    assert n0.metrics.epochs_ordered.value == len(n0.committed_batches)
    for e in range(split_depth):
        body = n0.ordered_record(e)
        assert body is not None
        oe, output = decode_ordered_body(body)
        assert oe == e
        assert set(n0.committed_batches[e].contributions) <= set(output)
    # the coupled arm never ordered
    m2 = c2.nodes[c2.ids[0]].metrics
    assert m2.epochs_ordered.value == 0


def test_ordered_logs_byte_identical_across_nodes():
    _, depth, cluster = _run_cluster(order_then_settle=True)
    for e in range(depth):
        bodies = {
            cluster.nodes[nid].ordered_record(e) for nid in cluster.ids
        }
        assert len(bodies) == 1 and None not in bodies, (
            f"ordered logs fork at epoch {e}"
        )




# ---------------------------------------------------------------------------
# crash/restart across the ordered-ahead window (channel transport)
# ---------------------------------------------------------------------------


def test_whole_roster_crash_between_order_and_settle(tmp_path):
    """Every WAL torn between COrd and CLOG: the restarted roster
    re-enters the epoch into its settlers, re-issues its own dec
    shares at the first idle boundary, and settles the SAME batch —
    no loss, no duplicate, no consensus re-run."""
    logdir = str(tmp_path / "wals")
    os.makedirs(logdir)
    cfg = Config(n=4, batch_size=8, seed=11, crypto_backend="cpu")
    ids = [f"node{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=66)

    net = ChannelNetwork(seed=11)
    nodes = _build_wal_cluster(cfg, ids, keys, logdir, net)
    for i in range(16):
        nodes[ids[i % 4]].add_transaction(b"tear-%03d" % i)
    for _ in range(6):
        for hb in nodes.values():
            hb.start_epoch()
        net.run()
        if all(hb.pending_tx_count() == 0 for hb in nodes.values()):
            break
    committed = [
        b.tx_list() for b in nodes[ids[0]].committed_batches
    ]
    assert len(committed) >= 2
    for hb in nodes.values():
        hb.batch_log.close()
    for nid in ids:
        _tear_last_clog(os.path.join(logdir, nid + ".log"))

    net2 = ChannelNetwork(seed=12)
    nodes2 = _build_wal_cluster(cfg, ids, keys, logdir, net2)
    for hb in nodes2.values():
        # ordered-ahead: the torn epoch re-entered as a settle-only
        # state, the ordered frontier is PAST it, settlement is not
        assert hb.epoch == len(committed)
        assert hb.settled_epoch == len(committed) - 1
        es = hb._epochs[len(committed) - 1]
        assert es.ordered and es.acs is None and not es.shares_issued
    net2.run()  # idle phase drives the settlers: shares re-issue
    for hb in nodes2.values():
        assert hb.settled_epoch == len(committed)
        got = [b.tx_list() for b in hb.committed_batches]
        assert got == committed  # same batch, once, in order
        hb.batch_log.close()


def test_single_node_torn_window_recovers_via_clog_catchup(tmp_path):
    """Only one node tore between COrd and CLOG; its peers settled and
    GC'd the epoch, so its own re-issued share can never reach the
    threshold — the plaintext must arrive via CLOG catch-up, settling
    the ordered-ahead epoch without re-ordering."""
    logdir = str(tmp_path / "wals")
    os.makedirs(logdir)
    cfg = Config(n=4, batch_size=8, seed=11, crypto_backend="cpu")
    ids = [f"node{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=66)

    net = ChannelNetwork(seed=11)
    nodes = _build_wal_cluster(cfg, ids, keys, logdir, net)
    for i in range(16):
        nodes[ids[i % 4]].add_transaction(b"solo-%03d" % i)
    for _ in range(6):
        for hb in nodes.values():
            hb.start_epoch()
        net.run()
        if all(hb.pending_tx_count() == 0 for hb in nodes.values()):
            break
    committed = [b.tx_list() for b in nodes[ids[0]].committed_batches]
    for hb in nodes.values():
        hb.batch_log.close()
    _tear_last_clog(os.path.join(logdir, "node0.log"))

    net2 = ChannelNetwork(seed=12)
    nodes2 = _build_wal_cluster(cfg, ids, keys, logdir, net2)
    n0 = nodes2["node0"]
    assert n0.settled_epoch == len(committed) - 1
    assert n0.epoch == len(committed)
    n0.request_catchup()
    net2.run()
    assert n0.settled_epoch == len(committed)
    assert [b.tx_list() for b in n0.committed_batches] == committed
    for hb in nodes2.values():
        hb.batch_log.close()




# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------


def test_backpressure_bounds_ordered_frontier():
    """decrypt_lag_max=1 — the tightest legal bound: ordering may run
    at most ONE epoch past settlement at every quiescence point, and
    the run still drains completely."""
    cfg = Config(n=4, batch_size=16, seed=9, decrypt_lag_max=1, crypto_backend="cpu")
    cluster = SimulatedCluster(config=cfg, seed=9, key_seed=3)
    for i in range(64):
        cluster.submit(b"bp-tx-%04d" % i)

    def check_bound(_r: int) -> None:
        for hb in cluster.nodes.values():
            lag = hb.epoch - hb.settled_epoch
            assert 0 <= lag <= 1, (hb.node_id, hb.epoch, hb.settled_epoch)

    cluster.run_epochs(on_quiescence=check_bound)
    depth = cluster.assert_agreement()
    assert depth >= 3
    n0 = cluster.nodes[cluster.ids[0]]
    assert n0.epoch == n0.settled_epoch  # fully settled at the end


def test_decrypt_lag_max_validation():
    with pytest.raises(ValueError):
        Config(n=4, decrypt_lag_max=0, crypto_backend="cpu")


# ---------------------------------------------------------------------------
# ordered CATCHUP (COrd serve/adopt)
# ---------------------------------------------------------------------------


def test_ordered_catchup_adopts_on_quorum(tmp_path):
    """f+1 byte-identical COrd bodies advance a laggard's ordered
    frontier into a settle-only state with a durable COrd record; a
    sub-quorum (or a forged body) adopts nothing."""
    from cleisthenes_tpu_torch.transport.message import CatchupOrdPayload

    cfg = Config(n=4, batch_size=8, seed=21, crypto_backend="cpu")
    ids = [f"node{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=44)
    # a real agreed output -> canonical COrd body for epoch 0
    output = {ids[0]: b"ct-a", ids[1]: b"ct-b"}
    body = encode_ordered_body(0, output)

    net = ChannelNetwork()
    hb = HoneyBadger(
        config=cfg,
        node_id=ids[0],
        member_ids=ids,
        keys=keys[ids[0]],
        out=ChannelBroadcaster(net, ids[0], ids),
        batch_log=BatchLog(str(tmp_path / "lag.log")),
    )
    net.join(ids[0], hb, None)
    # one vote: below the f+1=2 quorum — nothing adopts
    hb._handle_catchup_ord(ids[1], CatchupOrdPayload(epoch=0, body=body))
    assert hb.epoch == 0 and hb.ordered_record(0) is None
    # a second, FORGED body from another peer must not help the quorum
    forged = encode_ordered_body(0, {ids[0]: b"ct-x"})
    hb._handle_catchup_ord(
        ids[2], CatchupOrdPayload(epoch=0, body=forged)
    )
    assert hb.epoch == 0
    # the honest second vote completes the quorum
    hb._handle_catchup_ord(ids[2], CatchupOrdPayload(epoch=0, body=body))
    assert hb.epoch == 1  # ordered frontier advanced
    assert hb.settled_epoch == 0  # nothing settled yet
    assert hb.ordered_record(0) == body
    es = hb._epochs[0]
    assert es.ordered and es.acs is None and es.output == output
    # durable: a restart replays the adopted ordering into the settler
    hb.batch_log.close()
    log2 = BatchLog(str(tmp_path / "lag.log"))
    assert log2.last_ordered_epoch == 0
    replayed = list(log2.replay_ordered())
    assert replayed == [(0, body)]
    log2.close()


def test_settlement_release_redrives_parked_ordered_catchup(tmp_path):
    """A laggard parked at decrypt_lag_max with a full f+1 COrd tally
    buffered must resume adopting the moment settlement advances (here
    via CLOG catch-up) — backpressure release re-drives BOTH ordering
    paths, the local buffered-ACS one and the catch-up tally one, or
    the node wedges behind the roster in a quiescent cluster."""
    from cleisthenes_tpu_torch.core.batch import Batch
    from cleisthenes_tpu_torch.core.ledger import encode_batch_body
    from cleisthenes_tpu_torch.transport.message import (
        CatchupOrdPayload,
        CatchupRespPayload,
    )

    cfg = Config(n=4, batch_size=8, seed=23, decrypt_lag_max=1, crypto_backend="cpu")
    ids = [f"node{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=55)
    net = ChannelNetwork()
    hb = HoneyBadger(
        config=cfg,
        node_id=ids[0],
        member_ids=ids,
        keys=keys[ids[0]],
        out=ChannelBroadcaster(net, ids[0], ids),
        batch_log=BatchLog(str(tmp_path / "lag.log")),
    )
    net.join(ids[0], hb, None)

    body0 = encode_ordered_body(0, {ids[1]: b"ct-0"})
    body1 = encode_ordered_body(1, {ids[1]: b"ct-1"})
    # f+1 votes adopt epoch 0's ordering; the ordered frontier now
    # leads settlement by decrypt_lag_max=1
    for s in (ids[1], ids[2]):
        hb._handle_catchup_ord(
            s, CatchupOrdPayload(epoch=0, body=body0)
        )
    assert hb.epoch == 1
    # epoch 1's full quorum arrives but parks at the bound
    for s in (ids[1], ids[2]):
        hb._handle_catchup_ord(
            s, CatchupOrdPayload(epoch=1, body=body1)
        )
    assert hb.epoch == 1, "ordering must park at decrypt_lag_max"

    # peers settle epoch 0 for us: f+1 identical CLOG bodies
    clog0 = encode_batch_body(0, Batch({ids[1]: [b"tx-a"]}))
    for s in (ids[1], ids[2]):
        hb._handle_catchup_resp(
            s, CatchupRespPayload(epoch=0, body=clog0)
        )
    assert hb.settled_epoch == 1  # the settled frontier: epoch 0 done
    # ...and the parked tally must adopt without any further traffic
    assert hb.epoch == 2, "parked COrd tally wedged after settlement"
    assert hb.ordered_record(1) == body1
    hb.batch_log.close()


def test_catchup_serves_cord_for_unsettled_epochs(tmp_path):
    """A server that ordered-but-not-settled an epoch answers a
    CatchupReq with the COrd body for it (it has no plaintext yet)."""
    from cleisthenes_tpu_torch.transport.message import (
        CatchupOrdPayload,
        CatchupReqPayload,
    )

    logdir = str(tmp_path / "wals")
    os.makedirs(logdir)
    cfg = Config(n=4, batch_size=8, seed=11, crypto_backend="cpu")
    ids = [f"node{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=66)
    net = ChannelNetwork(seed=11)
    nodes = _build_wal_cluster(cfg, ids, keys, logdir, net)
    for i in range(16):
        nodes[ids[i % 4]].add_transaction(b"serve-%03d" % i)
    for _ in range(6):
        for hb in nodes.values():
            hb.start_epoch()
        net.run()
        if all(hb.pending_tx_count() == 0 for hb in nodes.values()):
            break
    depth = len(nodes[ids[0]].committed_batches)
    for hb in nodes.values():
        hb.batch_log.close()
    _tear_last_clog(os.path.join(logdir, "node0.log"))

    # restart node0 alone: ordered-ahead of its settled frontier
    net2 = ChannelNetwork(seed=13)
    nodes2 = _build_wal_cluster(cfg, ids, keys, logdir, net2)
    n0 = nodes2["node0"]
    assert n0.settled_epoch == depth - 1 and n0.epoch == depth

    served = []
    orig = n0.out.send_to

    def spy(member_id, payload):
        served.append(payload)
        orig(member_id, payload)

    n0.out.send_to = spy
    n0._handle_catchup_req(
        "node1", CatchupReqPayload(from_epoch=depth - 1)
    )
    ords = [p for p in served if isinstance(p, CatchupOrdPayload)]
    assert [p.epoch for p in ords] == [depth - 1]
    assert ords[0].body == n0.ordered_record(depth - 1)
    for hb in nodes2.values():
        hb.batch_log.close()


def test_settled_plaintext_pushed_after_cord_only_serve(tmp_path):
    """A server that answered a catch-up window with COrd bodies only
    (epochs ordered but unsettled) owes the requester those epochs'
    plaintext: the CLOG bodies push as the server settles.  Without
    the push the requester's repeat budget is spent, budgets re-arm
    only on ordering advances, and a quiescent cluster wedges."""
    from cleisthenes_tpu_torch.core.batch import Batch
    from cleisthenes_tpu_torch.core.ledger import encode_batch_body
    from cleisthenes_tpu_torch.transport.message import (
        CatchupOrdPayload,
        CatchupReqPayload,
        CatchupRespPayload,
    )

    cfg = Config(n=4, batch_size=8, seed=31, crypto_backend="cpu")
    ids = [f"node{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=77)
    net = ChannelNetwork()
    hb = HoneyBadger(
        config=cfg,
        node_id=ids[0],
        member_ids=ids,
        keys=keys[ids[0]],
        out=ChannelBroadcaster(net, ids[0], ids),
        batch_log=BatchLog(str(tmp_path / "srv.log")),
    )
    net.join(ids[0], hb, None)
    # ordered-ahead server state: adopt orderings for epochs 0 and 1
    for e in (0, 1):
        body = encode_ordered_body(e, {ids[1]: b"ct-%d" % e})
        for s in (ids[1], ids[2]):
            hb._handle_catchup_ord(
                s, CatchupOrdPayload(epoch=e, body=body)
            )
    assert hb.epoch == 2 and hb.settled_epoch == 0

    sent = []
    orig = hb.out.send_to
    hb.out.send_to = lambda m, p: (sent.append((m, p)), orig(m, p))

    # node3 asks; only COrd bodies are servable (no plaintext yet)...
    hb._handle_catchup_req(ids[3], CatchupReqPayload(from_epoch=0))
    assert [
        p.epoch for _m, p in sent if isinstance(p, CatchupOrdPayload)
    ] == [0, 1]
    assert not [
        p for _m, p in sent if isinstance(p, CatchupRespPayload)
    ]
    # ...and the requester burns its repeat budget on retries
    for _ in range(3):
        hb._handle_catchup_req(ids[3], CatchupReqPayload(from_epoch=0))
    del sent[:]

    # peers settle epoch 0 for us (f+1 CLOG bodies): the owed epoch-0
    # plaintext must push to node3 with NO further request from it
    clog0 = encode_batch_body(0, Batch({ids[1]: [b"tx-0"]}))
    for s in (ids[1], ids[2]):
        hb._handle_catchup_resp(
            s, CatchupRespPayload(epoch=0, body=clog0)
        )
    got = [
        p
        for m, p in sent
        if m == ids[3] and isinstance(p, CatchupRespPayload)
    ]
    assert [p.epoch for p in got] == [0]
    del sent[:]
    clog1 = encode_batch_body(1, Batch({ids[1]: [b"tx-1"]}))
    for s in (ids[1], ids[2]):
        hb._handle_catchup_resp(
            s, CatchupRespPayload(epoch=1, body=clog1)
        )
    got = [
        p
        for m, p in sent
        if m == ids[3] and isinstance(p, CatchupRespPayload)
    ]
    assert [p.epoch for p in got] == [1]
    # the debt is limit-bounded: fully repaid, no standing stream
    assert not hb._catchup_plain_owed
    hb.batch_log.close()


# ---------------------------------------------------------------------------
# settle-stall SLO watchdog
# ---------------------------------------------------------------------------


def test_settle_stall_watchdog_flips_degraded():
    from cleisthenes_tpu_torch.utils.metrics import Metrics
    from cleisthenes_tpu_torch.utils.watchdog import (
        DEGRADED,
        SETTLE_STALL,
        UP,
        SloWatchdog,
    )

    m = Metrics()
    frontiers = {"ordered": 0, "settled": 0}
    m.set_frontiers(lambda: (frontiers["ordered"], frontiers["settled"]))
    wd = SloWatchdog(
        metrics=m, pending_fn=lambda: 0, decrypt_lag_budget=4
    )
    assert wd.check(now=m._t0 + 1.0) == UP
    frontiers["ordered"] = 4  # lag == budget: ordering parked...
    # ...but settlement is still streaming (a settle just landed):
    # steady-state backpressure of a decrypt-bound node must NOT page
    # — the alert means settlement STOPPED trailing, not "busy"
    m.epoch_committed(0, 1)
    last = m._last_commit_t
    assert wd.check(now=last + 1.0) == UP
    # parked at the bound with no settle for > the stall budget
    assert wd.check(now=last + 1000.0) == DEGRADED
    block = wd.alerts_block()[SETTLE_STALL]
    assert block["active"] and block["count"] == 1
    assert "backpressure" in block["reason"]
    frontiers["settled"] = 2  # settler caught up below the budget
    assert wd.check(now=last + 1001.0) == UP
    assert not wd.alerts_block()[SETTLE_STALL]["active"]
    assert wd.alerts_block()[SETTLE_STALL]["count"] == 1  # edge-counted


# ---------------------------------------------------------------------------
# wire codec: CatchupOrdPayload (TLV + reference-pb extension slot)
# ---------------------------------------------------------------------------




def test_ordered_wal_record_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "cord.log")
    log = BatchLog(path)
    out0 = {"a": b"ct-1"}
    out1 = {"a": b"ct-2", "b": b"ct-3"}
    body0 = log.append_ordered(0, out0)
    body1 = log.append_ordered(1, out1)
    assert decode_ordered_body(body0) == (0, out0)
    log.close()

    log2 = BatchLog(path)
    assert log2.last_ordered_epoch == 1
    assert log2.last_epoch is None  # no plaintext records at all
    assert list(log2.replay_ordered()) == [(0, body0), (1, body1)]
    log2.close()

    # torn mid-append COrd record: truncated away on open, like CLOG
    with open(path, "ab") as fh:
        from cleisthenes_tpu_torch.core.ledger import (
            _frame_record,
            _MAGIC_ORD,
        )

        rec = _frame_record(_MAGIC_ORD, encode_ordered_body(2, out0))
        fh.write(rec[: len(rec) // 2])
    log3 = BatchLog(path)
    assert log3.last_ordered_epoch == 1
    log3.close()


def test_split_vs_coupled_identical_epoch0_grpc():
    """Same roster, same submissions, real sockets: the split and
    coupled arms commit byte-identical epoch-0 batches."""
    from cleisthenes_tpu_torch.transport.host import ValidatorHost

    def epoch0(order_then_settle: bool) -> list:
        n = 4
        cfg = Config(crypto_backend="cpu",
            n=n,
            batch_size=8,
            seed=77,
            order_then_settle=order_then_settle,
        )
        ids = [f"node{i}" for i in range(n)]
        keys = setup_keys(cfg, ids, seed=55)
        hosts = {i: ValidatorHost(cfg, i, ids, keys[i]) for i in ids}
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
            for i in range(8):
                hosts[ids[i % n]].submit(b"grpc-os-%02d" % i)
            for h in hosts.values():
                h.propose()
            first = {
                i: h.wait_commit(timeout=60) for i, h in hosts.items()
            }
            assert {e for e, _ in first.values()} == {0}
            return [encode_batch_body(0, b) for _, b in first.values()]
        finally:
            for h in hosts.values():
                h.stop()

    split = epoch0(True)
    coupled = epoch0(False)
    assert all(b == split[0] for b in split)
    assert all(b == coupled[0] for b in coupled)
    assert split[0] == coupled[0]


@pytest.mark.faults
def test_grpc_torn_window_restart_settles_from_wal(tmp_path):
    """The ordered-ahead crash window over real sockets: every host
    keeps a WAL, epoch 0 commits, the roster stops, ONE WAL is torn
    between COrd and CLOG.  The restarted victim comes back ordered-
    ahead (epoch 1, settled 0), ``connect`` fires catch-up from its
    SETTLED frontier, and the epoch settles from the peers' CLOG
    bodies — the same batch, once, with no consensus re-run."""
    from cleisthenes_tpu_torch.transport.host import ValidatorHost

    n = 4
    cfg = Config(crypto_backend="cpu", n=n, batch_size=8, seed=21)
    ids = [f"node{i}" for i in range(n)]
    keys = setup_keys(cfg, ids, seed=42)
    wals = {i: str(tmp_path / (i + ".log")) for i in ids}

    def boot():
        hosts = {
            i: ValidatorHost(
                cfg, i, ids, keys[i], batch_log_path=wals[i]
            )
            for i in ids
        }
        addrs = {i: h.listen() for i, h in hosts.items()}
        threads = [
            threading.Thread(target=h.connect, args=(addrs,))
            for h in hosts.values()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        return hosts

    hosts = boot()
    try:
        for i in range(8):
            hosts[ids[i % n]].submit(b"grpc-tear-%02d" % i)
        for h in hosts.values():
            h.propose()
        commits = {i: h.wait_commit(timeout=60) for i, h in hosts.items()}
        assert {e for e, _ in commits.values()} == {0}
        want = commits[ids[0]][1].tx_list()
    finally:
        for h in hosts.values():
            h.stop()
    _tear_last_clog(wals["node0"])

    # ordered-ahead out of WAL replay: the COrd survived the tear.
    # Asserted on a standalone construction BEFORE any connect —
    # catch-up fires inside connect() and can settle the epoch within
    # milliseconds of the dial completing, so asserting after boot()
    # races the very recovery this test exists to prove.
    probe = ValidatorHost(cfg, "node0", ids, keys["node0"],
                          batch_log_path=wals["node0"])
    assert probe.node.epoch == 1
    assert probe.node.settled_epoch == 0
    probe.stop()

    hosts2 = boot()
    try:
        victim = hosts2["node0"]
        assert victim.node.epoch == 1
        deadline = time.monotonic() + 30
        got = None
        while time.monotonic() < deadline:
            got = victim.committed_batches()
            if len(got) >= 1:
                break
            time.sleep(0.25)
        assert got is not None and len(got) == 1
        assert got[0].tx_list() == want
        assert victim.node.settled_epoch == 1
    finally:
        for h in hosts2.values():
            h.stop()


def test_catchup_ord_payload_roundtrips():
    from cleisthenes_tpu_torch.transport.message import (
        CatchupOrdPayload,
        Message,
        decode_frame,
        encode_message,
    )
    from cleisthenes_tpu_torch.transport.pb_adapter import (
        decode_pb_message,
        encode_pb_message,
    )

    body = encode_ordered_body(7, {"a": b"ct-1", "b": b"ct-2"})
    msg = Message(
        sender_id="node1",
        timestamp=55.25,
        payload=CatchupOrdPayload(epoch=7, body=body),
    )
    decoded, _prefix = decode_frame(encode_message(msg))
    assert decoded.payload == msg.payload
    pb = encode_pb_message(msg)
    back = decode_pb_message(pb)
    assert back.payload == msg.payload
