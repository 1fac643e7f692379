# The reference's tests/test_grpc.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default.
"""gRPC transport tests: real-network loopback round-trips (the
reference's comm_test.go:27-96 pattern) and full HBBFT over localhost
gRPC with MAC-authenticated envelopes."""

import queue
import threading
import time

import pytest

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.protocol.honeybadger import setup_keys
from cleisthenes_tpu_torch.transport.base import HmacAuthenticator
from cleisthenes_tpu_torch.transport.grpc_net import (
    DialOpts,
    GrpcClient,
    GrpcServer,
)
from cleisthenes_tpu_torch.transport.host import ValidatorHost
from cleisthenes_tpu_torch.transport.message import (
    Message,
    RbcPayload,
    RbcType,
)


class CollectingHandler:
    def __init__(self):
        self.inbox = queue.Queue()

    def serve_request(self, msg):
        self.inbox.put(msg)


def _val_msg(sender, note=b"shard"):
    return Message(
        sender_id=sender,
        timestamp=time.time(),
        payload=RbcPayload(
            type=RbcType.VAL,
            proposer=sender,
            epoch=0,
            root_hash=b"\x07" * 32,
            branch=(b"\x01" * 32,),
            shard=note,
            shard_index=0,
        ),
    )


def test_grpc_loopback_roundtrip():
    """Server accepts, client sends VAL, handler receives it intact
    (comm_test.go:27-96 without the 1s bootstrap sleep)."""
    handler = CollectingHandler()
    server = GrpcServer("127.0.0.1:0")
    server.on_conn(lambda conn: (conn.handle(handler), conn.start()))
    server.listen()
    try:
        client = GrpcClient()
        conn = client.dial(DialOpts(f"127.0.0.1:{server.port}"))
        conn.start()
        sent = _val_msg("alice")
        acks = []
        conn.send(sent, on_success=lambda m: acks.append(m))
        got = handler.inbox.get(timeout=5)
        assert got.sender_id == "alice"
        assert got.payload == sent.payload
        assert acks == [sent]
        conn.close()
        client.close()
    finally:
        server.stop()


def test_grpc_bidirectional_stream():
    """The server can push frames back down the same stream."""
    handler = CollectingHandler()
    server_conns = []
    server = GrpcServer("127.0.0.1:0")

    def on_conn(conn):
        conn.handle(handler)
        server_conns.append(conn)  # before start(): the reader thread
        conn.start()               # may dispatch immediately

    server.on_conn(on_conn)
    server.listen()
    try:
        client_handler = CollectingHandler()
        client = GrpcClient()
        conn = client.dial(DialOpts(f"127.0.0.1:{server.port}"))
        conn.handle(client_handler)
        conn.start()
        conn.send(_val_msg("alice", b"ping"))
        handler.inbox.get(timeout=5)
        server_conns[0].send(_val_msg("server", b"pong"))
        got = client_handler.inbox.get(timeout=5)
        assert got.payload.shard == b"pong"
        conn.close()
        client.close()
    finally:
        server.stop()


def test_grpc_mac_rejects_forged_sender():
    """A frame MAC'd with the wrong key must be dropped (the
    implemented conn.go:134-137)."""
    master = b"grpc-test-master"
    roster = ["server", "bob", "eve"]
    handler = CollectingHandler()
    server = GrpcServer(
        "127.0.0.1:0", HmacAuthenticator.derive(master, "server", roster)
    )
    conns = []
    server.on_conn(lambda c: (c.handle(handler), c.start(), conns.append(c)))
    server.listen()
    try:
        # eve signs with a key derived from a DIFFERENT master secret
        eve = GrpcClient(HmacAuthenticator.derive(b"wrong-master", "eve", roster))
        conn = eve.dial(DialOpts(f"127.0.0.1:{server.port}", conn_id="server"))
        conn.start()
        conn.send(_val_msg("eve"))
        # honest bob gets through on the same server
        bob = GrpcClient(HmacAuthenticator.derive(master, "bob", roster))
        bconn = bob.dial(DialOpts(f"127.0.0.1:{server.port}", conn_id="server"))
        bconn.start()
        bconn.send(_val_msg("bob"))
        got = handler.inbox.get(timeout=5)
        assert got.sender_id == "bob"
        assert handler.inbox.empty()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if sum(c.rejected for c in conns) >= 1:
                break
            time.sleep(0.02)
        assert sum(c.rejected for c in conns) >= 1
        conn.close()
        bconn.close()
        eve.close()
        bob.close()
    finally:
        server.stop()


def test_grpc_dial_timeout():
    client = GrpcClient()
    with pytest.raises(Exception):
        # RFC 5737 TEST-NET address: unroutable
        client.dial(DialOpts("192.0.2.1:1", timeout_s=0.3))


@pytest.mark.parametrize("n_epochs_min", [1])
def test_hbbft_over_real_grpc_network(n_epochs_min):
    """BASELINE config 1 over real sockets: 4 validators on localhost
    gRPC commit identical batches."""
    n = 4
    cfg = Config(crypto_backend="cpu", n=n, batch_size=8)
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
        txs = [b"grpc-tx-%02d" % i for i in range(8)]
        for i, tx in enumerate(txs):
            hosts[ids[i % n]].submit(tx)
        for h in hosts.values():
            h.propose()
        # wait for every node's first commit
        first = {i: h.wait_commit(timeout=60) for i, h in hosts.items()}
        epochs = {e for e, _ in first.values()}
        assert epochs == {0}
        lists = [b.tx_list() for _, b in first.values()]
        assert all(l == lists[0] for l in lists)
        assert set(lists[0]) <= set(txs)
        assert len(lists[0]) > 0
    finally:
        for h in hosts.values():
            h.stop()


def test_broadcaster_buffers_until_ready():
    """Outbound traffic before connect() completes must be parked and
    flushed, not dropped (peers boot concurrently)."""
    from cleisthenes_tpu_torch.transport.base import (
        ConnectionPool,
        NullAuthenticator,
    )
    from cleisthenes_tpu_torch.transport.host import (
        GrpcPayloadBroadcaster,
        SerialDispatcher,
    )

    sent = []

    class FakeConn:
        def __init__(self, cid):
            self._cid = cid

        def id(self):
            return self._cid

        def send_wire(self, wire):
            sent.append(("wire", self._cid))
            return True

        def send(self, msg, on_success=None, on_err=None):
            sent.append(("msg", self._cid))

    disp = SerialDispatcher()
    pool = ConnectionPool()
    out = GrpcPayloadBroadcaster("a", pool, disp, NullAuthenticator())

    msg_payload = _val_msg("a").payload
    out.broadcast(msg_payload)  # pool still empty, not ready
    out.send_to("b", msg_payload)
    assert sent == []  # nothing dropped into the void

    pool.add(FakeConn("b"))
    pool.add(FakeConn("c"))
    out.mark_ready()
    kinds = sorted(sent)
    assert ("msg", "b") in kinds  # the queued send_to flushed
    assert kinds.count(("wire", "b")) == 1 and kinds.count(("wire", "c")) == 1
    sent.clear()
    out.broadcast(msg_payload)  # post-ready goes straight through
    assert len(sent) == 2
    disp.stop()


@pytest.mark.faults
def test_host_crash_restart_catchup_with_backoff(tmp_path):
    """Crash recovery over real sockets: a host with a durable batch
    log stops mid-roster, the survivors commit an epoch without it,
    and a FRESH host restarted from the WAL on the same address
    rejoins, catches up via CATCHUP, and converges to the survivors'
    batches.  Meanwhile the survivors' redial loops must back off
    exponentially — growing delays in the health tracker's reconnect
    counters, not fixed-interval spinning."""
    n = 4
    cfg = Config(crypto_backend="cpu",
        n=n,
        batch_size=8,
        seed=7,  # seeds the dial-jitter rng: replayable schedule
        dial_timeout_s=0.25,
        dial_retry_base_s=0.05,
        dial_retry_max_s=1.0,
    )
    ids = [f"node{i}" for i in range(n)]
    keys = setup_keys(cfg, ids, seed=77)
    victim = "node3"
    wal = str(tmp_path / "node3.log")
    hosts = {
        i: ValidatorHost(
            cfg, i, ids, keys[i],
            batch_log_path=wal if i == victim else None,
        )
        for i in ids
    }
    restarted = None
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
        # epoch 0 commits everywhere (the victim logs it durably)
        for i, tx in enumerate([b"pre-%02d" % i for i in range(8)]):
            hosts[ids[i % n]].submit(tx)
        for h in hosts.values():
            h.propose()
        for h in hosts.values():
            h.wait_commit(timeout=60)
        # fail-stop the victim; survivors' redial loops start backing off
        hosts[victim].stop()
        survivors = {i: h for i, h in hosts.items() if i != victim}
        # n=4 tolerates the single crash: epoch 1 commits without it
        for i, tx in enumerate([b"down-%02d" % i for i in range(9)]):
            survivors[ids[i % 3]].submit(tx)
        for h in survivors.values():
            h.propose()
        commits = {i: h.wait_commit(timeout=60) for i, h in survivors.items()}
        lists = [b.tx_list() for _, b in commits.values()]
        assert all(l == lists[0] for l in lists) and lists[0]
        time.sleep(1.0)  # let several redial attempts record their delays
        # restart from the WAL: same identity, same address, new process
        restarted = ValidatorHost(
            cfg, victim, ids, keys[victim],
            listen_addr=addrs[victim],
            batch_log_path=wal,
        )
        assert restarted.node.epoch == 1  # epoch 0 replayed from the WAL
        got = restarted.listen()
        assert got == addrs[victim]
        restarted.connect(addrs)  # fires the CATCHUP request
        # NO manual re-kicking: if a survivor's redial to us had not
        # healed when our CatchupReq arrived, its responses went into
        # the void — the heal event (peer_reconnected) must re-serve
        # our window on its own
        want = survivors[ids[0]].committed_batches()
        deadline = time.monotonic() + 30
        caught_up = None
        while time.monotonic() < deadline:
            caught_up = restarted.committed_batches()
            if len(caught_up) >= len(want):
                break
            time.sleep(0.25)
        assert caught_up is not None and len(caught_up) >= len(want)
        for e, batch in enumerate(want):
            assert caught_up[e].tx_list() == batch.tx_list()
        # backoff evidence: a survivor reconnected to the victim, and
        # its scheduled redial delays GREW (factor 2, jitter +/-25%:
        # each pre-cap delay strictly exceeds the previous one)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            snap = survivors[ids[0]].health.snapshot()[victim]
            if snap["state"] == "up" and snap["reconnects"] >= 1:
                break
            time.sleep(0.05)
        assert snap["reconnects"] >= 1, snap
        delays = snap["recent_delays_s"]
        assert len(delays) >= 2, snap
        pre_cap = [d for d in delays if d < cfg.dial_retry_max_s * 0.75]
        assert all(b > a for a, b in zip(pre_cap, pre_cap[1:])), delays
        assert max(delays) > cfg.dial_retry_base_s * 1.25, delays
    finally:
        for h in hosts.values():
            h.stop()  # double-stop of the victim is a no-op
        if restarted is not None:
            restarted.stop()


@pytest.mark.faults
def test_host_redials_lost_peer_stream():
    """A severed peer stream re-establishes via the host's backoff
    redial loop, and the protocol commits a later epoch through the
    healed connection (the reference leaves a dropped stream dropped
    until process restart)."""
    n = 4
    cfg = Config(crypto_backend="cpu", n=n, batch_size=8)
    ids = [f"node{i}" for i in range(n)]
    keys = setup_keys(cfg, ids, seed=66)
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
        # epoch 0 commits everywhere
        for i, tx in enumerate([b"pre-%02d" % i for i in range(8)]):
            hosts[ids[i % n]].submit(tx)
        for h in hosts.values():
            h.propose()
        for h in hosts.values():
            h.wait_commit(timeout=60)
        # sever node0 -> node1 and wait for the redial loop to heal it
        victim = hosts[ids[0]]
        conn = victim.pool.get(ids[1])
        assert conn is not None
        conn.close()  # fires _on_conn_lost -> background redial
        deadline = time.monotonic() + 10
        healed = None
        while time.monotonic() < deadline:
            healed = victim.pool.get(ids[1])
            if healed is not None and healed is not conn:
                break
            time.sleep(0.05)
        assert healed is not None and healed is not conn, "no redial"
        # the healed pool carries a later epoch to commitment
        for i, tx in enumerate([b"post-%02d" % i for i in range(8)]):
            hosts[ids[i % n]].submit(tx)
        for h in hosts.values():
            h.propose()
        commits = {i: h.wait_commit(timeout=60) for i, h in hosts.items()}
        lists = [b.tx_list() for _, b in commits.values()]
        assert all(l == lists[0] for l in lists) and len(lists[0]) > 0
    finally:
        for h in hosts.values():
            h.stop()
