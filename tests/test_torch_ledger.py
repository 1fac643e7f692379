# The reference's tests/test_ledger.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Committed-batch log tests: durability, torn-write recovery, and
validator restart/rejoin (SURVEY.md §5.4 checkpoint/resume)."""

import os

from cleisthenes_tpu_torch.core.batch import Batch
from cleisthenes_tpu_torch.core.ledger import BatchLog, _encode_record
from tests.test_torch_honeybadger import (
    assert_identical_batches,
    make_hb_network,
    push_txs,
)


def _batch(*pairs):
    return Batch(contributions={p: list(txs) for p, txs in pairs})


def test_log_roundtrip(tmp_path):
    path = str(tmp_path / "batches.log")
    log = BatchLog(path)
    b0 = _batch(("a", [b"t1", b"t2"]), ("b", [b"t3"]))
    b1 = _batch(("c", [b""]))  # empty tx allowed
    log.append(0, b0)
    log.append(1, b1)
    log.close()

    log2 = BatchLog(path)
    got = list(log2.replay())
    assert [e for e, _ in got] == [0, 1]
    assert got[0][1].contributions == b0.contributions
    assert got[1][1].contributions == b1.contributions
    assert log2.last_epoch == 1
    log2.close()


def test_log_truncates_torn_tail(tmp_path):
    path = str(tmp_path / "batches.log")
    log = BatchLog(path)
    log.append(0, _batch(("a", [b"x"])))
    log.close()
    # simulate a crash mid-append: write half a record
    rec = _encode_record(1, _batch(("a", [b"y"])))
    with open(path, "ab") as fh:
        fh.write(rec[: len(rec) // 2])
    log2 = BatchLog(path)
    assert log2.last_epoch == 0
    assert len(list(log2.replay())) == 1
    # and the log accepts new appends cleanly after truncation
    log2.append(1, _batch(("a", [b"z"])))
    log2.close()
    log3 = BatchLog(path)
    assert log3.last_epoch == 1
    assert len(list(log3.replay())) == 2
    log3.close()


def test_log_rejects_corrupt_crc(tmp_path):
    path = str(tmp_path / "batches.log")
    log = BatchLog(path)
    log.append(0, _batch(("a", [b"x"])))
    log.append(1, _batch(("a", [b"y"])))
    log.close()
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0xFF  # corrupt inside the second record
    open(path, "wb").write(bytes(data))
    log2 = BatchLog(path)
    assert log2.last_epoch == 0  # second record dropped
    log2.close()


def test_checkpoint_roundtrip_and_replay_skips_it(tmp_path):
    path = str(tmp_path / "batches.log")
    log = BatchLog(path)
    log.append(0, _batch(("a", [b"t1"])))
    log.append(1, _batch(("b", [b"t2", b"t3"])))
    log.append_checkpoint(1, [{b"t1"}, {b"t2", b"t3"}])
    log.append(2, _batch(("a", [b"t4"])))
    log.close()

    log2 = BatchLog(path)
    # batch replay is unchanged by the interleaved checkpoint
    assert [e for e, _ in log2.replay()] == [0, 1, 2]
    assert log2.last_epoch == 2
    epoch, history = log2.last_checkpoint
    assert epoch == 1
    assert history == [{b"t1"}, {b"t2", b"t3"}]
    log2.close()


def test_torn_checkpoint_truncated_like_torn_batch(tmp_path):
    from cleisthenes_tpu_torch.core.ledger import (
        _encode_checkpoint_body,
        _frame_record,
        _MAGIC_CKPT,
    )

    path = str(tmp_path / "batches.log")
    log = BatchLog(path)
    log.append(0, _batch(("a", [b"x"])))
    log.append_checkpoint(0, [{b"x"}])
    log.close()
    rec = _frame_record(_MAGIC_CKPT, _encode_checkpoint_body(1, [{b"y"}]))
    with open(path, "ab") as fh:
        fh.write(rec[: len(rec) // 2])  # crash mid-checkpoint
    log2 = BatchLog(path)
    assert log2.last_epoch == 0
    assert log2.last_checkpoint == (0, [{b"x"}])
    log2.close()


def test_restart_seeds_filter_from_checkpoint(tmp_path):
    """A restarted node whose log carries a checkpoint must restore
    the SAME duplicate filter the pre-crash node held — without
    re-deriving tx sets from the batches the checkpoint covers."""
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.protocol.honeybadger import HoneyBadger, setup_keys
    from cleisthenes_tpu_torch.transport.broadcast import ChannelBroadcaster
    from cleisthenes_tpu_torch.transport.channel import ChannelNetwork

    cfg = Config(n=4, batch_size=8, ledger_checkpoint_every=2, crypto_backend="cpu")
    ids = [f"node{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=77)
    logdir = tmp_path / "ckpt-logs"
    os.makedirs(logdir)

    def build(net):
        nodes = {}
        for node_id in ids:
            nodes[node_id] = HoneyBadger(
                config=cfg,
                node_id=node_id,
                member_ids=ids,
                keys=keys[node_id],
                out=ChannelBroadcaster(net, node_id, ids),
                batch_log=BatchLog(str(logdir / f"{node_id}.log")),
            )
            net.join(node_id, nodes[node_id], None)
        return nodes

    net = ChannelNetwork()
    nodes = build(net)
    push_txs(nodes, 24, prefix=b"ck")
    for _ in range(10):
        for hb in nodes.values():
            hb.start_epoch()
        net.run()
        if all(hb.pending_tx_count() == 0 for hb in nodes.values()):
            break
    depth = assert_identical_batches(nodes)
    assert depth >= 2
    # every-2-commits policy actually wrote checkpoints
    assert nodes["node0"].batch_log.last_checkpoint is not None
    filters = {nid: set(hb._committed_filter) for nid, hb in nodes.items()}
    for hb in nodes.values():
        hb.batch_log.close()

    net2 = ChannelNetwork()
    nodes2 = build(net2)
    for nid, hb in nodes2.items():
        assert hb.epoch == len(hb.committed_batches)
        assert set(hb._committed_filter) == filters[nid]


def test_node_restart_resumes_epoch_and_filter(tmp_path):
    """A validator restarted from its log continues at last_epoch+1
    with its committed history and duplicate filter restored."""
    from cleisthenes_tpu_torch.protocol.honeybadger import HoneyBadger, setup_keys
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.transport.broadcast import ChannelBroadcaster
    from cleisthenes_tpu_torch.transport.channel import ChannelNetwork

    logdir = tmp_path / "logs"
    os.makedirs(logdir)

    cfg = Config(n=4, batch_size=8, crypto_backend="cpu")
    ids = [f"node{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=66)

    def build(net):
        nodes = {}
        for node_id in ids:
            nodes[node_id] = HoneyBadger(
                config=cfg,
                node_id=node_id,
                member_ids=ids,
                keys=keys[node_id],
                out=ChannelBroadcaster(net, node_id, ids),
                batch_log=BatchLog(str(logdir / f"{node_id}.log")),
            )
            net.join(node_id, nodes[node_id], None)
        return nodes

    net = ChannelNetwork()
    nodes = build(net)
    txs1 = push_txs(nodes, 8, prefix=b"run1")
    for hb in nodes.values():
        hb.start_epoch()
    net.run()
    depth1 = assert_identical_batches(nodes)
    committed1 = [
        b.tx_list() for b in nodes["node0"].committed_batches[:depth1]
    ]
    for hb in nodes.values():
        hb.batch_log.close()

    # "restart" the whole cluster from logs on a fresh network
    net2 = ChannelNetwork()
    nodes2 = build(net2)
    for hb in nodes2.values():
        assert hb.epoch == depth1  # resumed after the last commit
        assert len(hb.committed_batches) >= depth1
    # replaying an already-committed tx is filtered as a duplicate
    nodes2["node0"].add_transaction(txs1[0])
    assert nodes2["node0"]._create_batch() == []

    txs2 = push_txs(nodes2, 8, prefix=b"run2")
    for hb in nodes2.values():
        hb.start_epoch()
    net2.run()
    depth2 = assert_identical_batches(nodes2)
    assert depth2 > depth1
    # history preserved across the restart
    for e in range(depth1):
        assert nodes2["node0"].committed_batches[e].tx_list() == committed1[e]
    new_txs = {
        tx
        for b in nodes2["node0"].committed_batches[depth1:depth2]
        for tx in b.tx_list()
    }
    assert new_txs <= set(txs2)
    assert new_txs  # run2 actually committed something


def test_lagging_restart_catches_up_via_catchup(tmp_path):
    """A node restarted with a stale log (missing epochs the cluster
    already committed) must adopt the missing batches via f+1 matching
    CATCHUP responses, not stall or fork — and recover the whole
    outage window from ONE request round (range serving), not one
    request per epoch."""
    from cleisthenes_tpu_torch.protocol.honeybadger import HoneyBadger, setup_keys
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.transport.broadcast import ChannelBroadcaster
    from cleisthenes_tpu_torch.transport.channel import ChannelNetwork

    cfg = Config(n=4, batch_size=8, crypto_backend="cpu")
    ids = [f"node{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=91)

    def build(net, node_id, log=None):
        hb = HoneyBadger(
            config=cfg,
            node_id=node_id,
            member_ids=ids,
            keys=keys[node_id],
            out=ChannelBroadcaster(net, node_id, ids),
            batch_log=log,
        )
        net.join(node_id, hb, None)
        return hb

    # phase 1: run the full cluster a few epochs (no logs needed for
    # the up-to-date nodes; the laggard's state is simulated below)
    net = ChannelNetwork()
    nodes = {i: build(net, i) for i in ids}
    push_txs(nodes, 24, prefix=b"sync")
    for _ in range(10):
        for hb in nodes.values():
            hb.start_epoch()
        net.run()
        if all(hb.pending_tx_count() == 0 for hb in nodes.values()):
            break
    depth = assert_identical_batches(nodes)
    assert depth >= 2

    # phase 2: node3 "restarts" empty (lost everything) on a fresh
    # network with the same up-to-date peers
    net2 = ChannelNetwork()
    for i in ids[:3]:
        net2.join(i, nodes[i], None)
        # re-point the node's transport-level broadcaster (walk the
        # counting + coalescing wrappers down to the ChannelBroadcaster)
        inner = nodes[i].out
        while not hasattr(inner, "_network"):
            inner = inner._inner
        inner._network = net2
    fresh = build(net2, "node3")
    assert fresh.epoch == 0
    fresh.request_catchup()
    net2.run()
    assert fresh.epoch >= depth  # caught up past the common depth
    for e in range(depth):
        assert (
            fresh.committed_batches[e].tx_list()
            == nodes["node0"].committed_batches[e].tx_list()
        )


def test_catchup_rejects_forged_minority(tmp_path):
    """f forged catch-up responses must not fool a syncing node:
    adoption needs f+1 identical bodies."""
    from cleisthenes_tpu_torch.core.ledger import encode_batch_body
    from cleisthenes_tpu_torch.core.batch import Batch
    from cleisthenes_tpu_torch.protocol.honeybadger import HoneyBadger, setup_keys
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.transport.broadcast import ChannelBroadcaster
    from cleisthenes_tpu_torch.transport.channel import ChannelNetwork
    from cleisthenes_tpu_torch.transport.message import CatchupRespPayload

    cfg = Config(n=4, batch_size=8, crypto_backend="cpu")
    ids = [f"node{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=92)
    net = ChannelNetwork()
    hb = HoneyBadger(
        config=cfg,
        node_id="node3",
        member_ids=ids,
        keys=keys["node3"],
        out=ChannelBroadcaster(net, "node3", ids),
    )
    net.join("node3", hb, None)

    forged = encode_batch_body(
        0, Batch(contributions={"node0": [b"EVIL-TX"]})
    )
    # one Byzantine response (f=1): must NOT be adopted
    hb._handle_catchup_resp("node0", CatchupRespPayload(0, forged))
    assert hb.epoch == 0 and not hb.committed_batches
    # a second matching response crosses f+1 and is adopted (by design:
    # two senders => at least one honest in the threat model)
    hb._handle_catchup_resp("node1", CatchupRespPayload(0, forged))
    assert hb.epoch == 1
    # duplicate/overwrite from the same sender never double-counts
    hb2 = HoneyBadger(
        config=cfg,
        node_id="node2",
        member_ids=ids,
        keys=keys["node2"],
        out=ChannelBroadcaster(net, "node2", ids),
    )
    net.join("node2", hb2, None)
    hb2._handle_catchup_resp("node0", CatchupRespPayload(0, forged))
    hb2._handle_catchup_resp("node0", CatchupRespPayload(0, forged))
    assert hb2.epoch == 0 and not hb2.committed_batches


def _bare_hb(node_id="node3", seed=93):
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.protocol.honeybadger import HoneyBadger, setup_keys
    from cleisthenes_tpu_torch.transport.broadcast import ChannelBroadcaster
    from cleisthenes_tpu_torch.transport.channel import ChannelNetwork

    cfg = Config(n=4, batch_size=8, crypto_backend="cpu")
    ids = [f"node{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=seed)
    net = ChannelNetwork()
    hb = HoneyBadger(
        config=cfg,
        node_id=node_id,
        member_ids=ids,
        keys=keys[node_id],
        out=ChannelBroadcaster(net, node_id, ids),
    )
    net.join(node_id, hb, None)
    return hb


def test_catchup_chase_not_suppressed_by_subquorum_tally():
    """Liveness regression: after adopting a window, a SUB-quorum (or
    Byzantine) tally already sitting at the new frontier must not
    suppress the follow-up CatchupReq — one dropped response would
    otherwise wedge the catch-up forever in a quiescent cluster."""
    from cleisthenes_tpu_torch.core.ledger import encode_batch_body
    from cleisthenes_tpu_torch.core.batch import Batch
    from cleisthenes_tpu_torch.transport.message import CatchupRespPayload

    hb = _bare_hb()
    body0 = encode_batch_body(0, Batch(contributions={"node0": [b"a"]}))
    body1 = encode_batch_body(1, Batch(contributions={"node0": [b"b"]}))
    # a lone epoch-1 response arrives first (sub-quorum at the future
    # frontier), then epoch 0 reaches its f+1 quorum
    hb._handle_catchup_resp("node0", CatchupRespPayload(1, body1))
    hb._handle_catchup_resp("node0", CatchupRespPayload(0, body0))
    hb._handle_catchup_resp("node1", CatchupRespPayload(0, body0))
    assert hb.epoch == 1  # epoch 0 adopted
    # the chase fired at the new frontier despite the epoch-1 tally
    assert hb._last_catchup_request == 1


def test_catchup_serving_rate_limited_and_reserved_on_heal():
    """Amplification guard: a request whose from_epoch does not
    advance past the window already served draws from a small repeat
    budget (counted, never clocked — seeded runs replay exactly), so
    an 8-byte CatchupReq cannot buy unlimited 32-batch response
    windows; a link-heal event (peer_reconnected) re-arms the budget
    and re-serves the sender's last window."""
    from cleisthenes_tpu_torch.core.batch import Batch
    from cleisthenes_tpu_torch.protocol.honeybadger import CATCHUP_REPEAT_BUDGET
    from cleisthenes_tpu_torch.transport.message import CatchupReqPayload

    hb = _bare_hb()
    hb.committed_batches.extend(
        [Batch(contributions={"node0": [b"e%d" % e]}) for e in range(2)]
    )
    out0 = hb.metrics.msgs_out.value
    hb._handle_catchup_req("node0", CatchupReqPayload(0))
    served = hb.metrics.msgs_out.value - out0
    assert served == 2  # both epochs served in one window
    # non-advancing replays drain the repeat budget, then are refused
    for i in range(CATCHUP_REPEAT_BUDGET):
        hb._handle_catchup_req("node0", CatchupReqPayload(0))
        assert hb.metrics.msgs_out.value - out0 == (i + 2) * served
    hb._handle_catchup_req("node0", CatchupReqPayload(0))
    hb._handle_catchup_req("node0", CatchupReqPayload(0))
    assert (
        hb.metrics.msgs_out.value - out0
        == (CATCHUP_REPEAT_BUDGET + 1) * served
    )
    # other senders have their own budget
    out1 = hb.metrics.msgs_out.value
    hb._handle_catchup_req("node1", CatchupReqPayload(0))
    assert hb.metrics.msgs_out.value - out1 == served
    # the transport's link-heal event re-arms node0 and re-serves its
    # last requested window (responses sent into a dead link are gone)
    out2 = hb.metrics.msgs_out.value
    hb.peer_reconnected("node0")
    assert hb.metrics.msgs_out.value - out2 == served
    # a non-member heal event is ignored
    out3 = hb.metrics.msgs_out.value
    hb.peer_reconnected("intruder")
    assert hb.metrics.msgs_out.value == out3
