# The reference's tests/test_pipeline_depth.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""K-deep pipelined epoch frontiers (Config.pipeline_depth).

Covers the acceptance matrix:

- equivalence: the depth-1 (lockstep) arm and depth-K windows commit
  byte-identical settled ledgers on the same seed — on the channel
  transport, over real gRPC, and across PYTHONHASHSEED values — while
  depth > 1 demonstrably runs the K-deep machinery (eager dec-share
  waves nonzero, fewer hub flushes for the same epochs);
- crash/WAL-restart with >= 2 ordered-but-unsettled epochs in the
  window: every torn epoch re-enters the settler as a settle-only
  state and settles with no loss, duplicate, or consensus re-run;
- backpressure: ordering still parks at ``decrypt_lag_max`` exactly
  as at depth 1, however wide the in-flight window;
- reconfig boundary under depth 4: a joiner ceremony completes across
  the widened window (``reconfig_lead > pipeline_depth +
  decrypt_lag_max`` keeps every in-flight epoch under one roster);
- Config.validate: depth >= 1, depth <= MAX_PIPELINE_DEPTH, and the
  widened reconfig_lead bound.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import struct
import subprocess
import sys
import threading
import time

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from cleisthenes_tpu_torch.config import (  # noqa: E402
    MAX_PIPELINE_DEPTH,
    Config,
)
from cleisthenes_tpu_torch.core.ledger import (  # noqa: E402
    BatchLog,
    encode_batch_body,
)
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster  # noqa: E402
from cleisthenes_tpu_torch.protocol.honeybadger import (  # noqa: E402
    EPOCH_HORIZON,
    HoneyBadger,
    setup_keys,
)
from cleisthenes_tpu_torch.transport.broadcast import (  # noqa: E402
    ChannelBroadcaster,
)
from cleisthenes_tpu_torch.transport.channel import ChannelNetwork  # noqa: E402


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _depth_cfg(depth: int, **kw) -> Config:
    """A Config at the given window depth whose reconfig_lead always
    clears the widened validation bound."""
    lag = kw.pop("decrypt_lag_max", 4)
    return Config(
        n=4,
        batch_size=16,
        seed=5,
        pipeline_depth=depth,
        decrypt_lag_max=lag,
        reconfig_lead=max(8, depth + lag + 1),
        **kw, crypto_backend="cpu",
    )


def _ledger_digest(cluster: SimulatedCluster) -> str:
    h = hashlib.sha256()
    for nid in cluster.ids:
        for epoch, batch in enumerate(
            cluster.nodes[nid].committed_batches
        ):
            h.update(encode_batch_body(epoch, batch))
    return h.hexdigest()


def _run_depth(depth: int, txs: int = 64) -> tuple:
    cluster = SimulatedCluster(
        config=_depth_cfg(depth), seed=5, key_seed=3
    )
    for i in range(txs):
        cluster.submit(b"kd-tx-%04d" % i)
    cluster.run_epochs()
    depth_committed = cluster.assert_agreement()
    return _ledger_digest(cluster), depth_committed, cluster


def _tear_last_clog(path: str) -> None:
    """Drop the newest CLOG record from a WAL, leaving its epoch's
    COrd in place (the crash-between-order-and-settle window; same
    framing walk as tests/test_order_settle.py)."""
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


# ---------------------------------------------------------------------------
# Config.validate (satellite)
# ---------------------------------------------------------------------------


def test_pipeline_depth_validation():
    with pytest.raises(ValueError):
        Config(n=4, pipeline_depth=0, crypto_backend="cpu")
    with pytest.raises(ValueError):
        Config(n=4, pipeline_depth=MAX_PIPELINE_DEPTH + 1, crypto_backend="cpu")
    # the widened reconfig_lead bound: lead must clear depth + lag
    with pytest.raises(ValueError):
        Config(
            n=4, pipeline_depth=4, decrypt_lag_max=4, reconfig_lead=8, crypto_backend="cpu"
        )
    Config(n=4, pipeline_depth=4, decrypt_lag_max=4, reconfig_lead=9, crypto_backend="cpu")
    # the window cap is pinned to the demux horizon
    assert MAX_PIPELINE_DEPTH <= EPOCH_HORIZON


# ---------------------------------------------------------------------------
# equivalence: depth-1 (lockstep arm) vs depth-K settled ledgers
# ---------------------------------------------------------------------------


def test_depth1_vs_depth4_byte_identical_settled_ledgers_channel():
    """The pinned depth-1 arm (pipeline_depth=1 — pre-K lockstep,
    byte-identical to the historical behavior) and the K-deep windows
    settle byte-identical ledgers on the same seed, while depth > 1
    demonstrably ran the widened machinery."""
    dig1, depth1, c1 = _run_depth(1)
    dig2, depth2, c2 = _run_depth(2)
    dig4, depth4, c4 = _run_depth(4)
    assert depth1 >= 3 and depth1 == depth2 == depth4
    assert dig1 == dig2 == dig4, (
        "K-deep settled ledgers diverged from the lockstep arm"
    )
    # the lockstep arm never takes the eager path...
    eager1 = sum(
        hb.metrics.eager_share_waves.value for hb in c1.nodes.values()
    )
    assert eager1 == 0
    assert c1.nodes[c1.ids[0]].hub.stats()["dec_issue_batches"] == 0
    # ...and the K-deep arms did: eager dec shares piggybacked on
    # waves, through the hub's pooled dec-share column
    for c in (c2, c4):
        eager = sum(
            hb.metrics.eager_share_waves.value
            for hb in c.nodes.values()
        )
        assert eager > 0, "depth > 1 never piggybacked a dec share"
        assert c.nodes[c.ids[0]].hub.stats()["dec_issue_batches"] > 0
    # K concurrent epochs share waves: same committed epochs, fewer
    # hub flushes (the zero-noise dispatch-amortization evidence)
    flushes = {
        d: c.nodes[c.ids[0]].hub.stats()["flushes"]
        for d, c in ((1, c1), (2, c2), (4, c4))
    }
    assert flushes[4] < flushes[2] < flushes[1]


def test_pipeline_snapshot_block_reports_eager_waves():
    """snapshot()["pipeline"] carries the always-present gauge +
    counter (the schema rule), nonzero after a depth-4 run."""
    _dig, _depth, cluster = _run_depth(4)
    snaps = [
        hb.metrics.snapshot()["pipeline"]
        for hb in cluster.nodes.values()
    ]
    for snap in snaps:
        assert set(snap) == {"epochs_in_flight", "eager_share_waves"}
        assert snap["epochs_in_flight"] == 0  # quiesced: nothing live
    assert sum(s["eager_share_waves"] for s in snaps) > 0




# Prints one line digesting BOTH arms' settled ledger bytes plus the
# deterministic K-deep counters.  Two PYTHONHASHSEED values must
# produce identical lines — hash-order iteration anywhere in the
# pipeline drive / eager dec-share column would show up as different
# counters or ledger bytes (staticcheck DET002's dynamic twin).
_DEPTH_DRIVER = r"""
import hashlib
from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.ledger import encode_batch_body
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster

def run(depth):
    cluster = SimulatedCluster(
        config=Config(
            n=4, batch_size=8, seed=909, pipeline_depth=depth,
            reconfig_lead=max(8, depth + 4 + 1), crypto_backend="cpu",
        ),
        seed=909,
        key_seed=4,
    )
    for i in range(24):
        cluster.submit(b"kd-hs-%04d" % i)
    cluster.run_epochs()
    depth_committed = cluster.assert_agreement()
    assert depth_committed >= 2
    h = hashlib.sha256()
    for nid in cluster.ids:
        for e, b in enumerate(cluster.nodes[nid].committed_batches):
            h.update(encode_batch_body(e, b))
    eager = sum(
        hb.metrics.eager_share_waves.value
        for hb in cluster.nodes.values()
    )
    hub = cluster.nodes[cluster.ids[0]].hub.stats()
    return h.hexdigest(), eager, hub

d1, e1, hub1 = run(1)
d4, e4, hub4 = run(4)
assert d1 == d4, "depth-4 settled ledger diverged from depth-1"
assert e1 == 0 and e4 > 0
print(
    "DEPTH_DIGEST=%s eager=%d dec_batches=%d dec_items=%d "
    "flushes1=%d flushes4=%d"
    % (
        d4, e4, hub4["dec_issue_batches"], hub4["dec_issue_items"],
        hub1["flushes"], hub4["flushes"],
    )
)
"""


def _run_depth_driver(hashseed: str) -> str:
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = hashseed
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _DEPTH_DRIVER],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, (
        f"PYTHONHASHSEED={hashseed} depth run failed:\n"
        f"{proc.stdout}\n{proc.stderr}"
    )
    for line in proc.stdout.splitlines():
        if line.startswith("DEPTH_DIGEST="):
            return line
    raise AssertionError(f"no depth digest line:\n{proc.stdout}")


def test_depth_equivalence_across_hash_seeds():
    a = _run_depth_driver("1")
    b = _run_depth_driver("2")
    assert a == b, (
        "K-deep pipelining diverged across PYTHONHASHSEED values:\n"
        f"  {a}\n  {b}\n-> hash-order iteration is leaking into the "
        "pipeline drive or the hub's dec-share column"
    )


# ---------------------------------------------------------------------------
# crash/WAL-restart with >= 2 ordered-but-unsettled epochs (satellite)
# ---------------------------------------------------------------------------


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


def test_wal_restart_with_two_ordered_unsettled_epochs(tmp_path):
    """Every WAL torn between COrd and CLOG for the LAST TWO epochs:
    the restarted roster re-enters BOTH epochs of the window into its
    settlers (the multi-epoch re-entry the K-deep window requires),
    re-issues its own dec shares at the first idle boundary, and
    settles the same batches — no loss, no duplicate, no re-run."""
    logdir = str(tmp_path / "wals")
    os.makedirs(logdir)
    cfg = Config(
        n=4, batch_size=8, seed=11, pipeline_depth=4, reconfig_lead=9, crypto_backend="cpu"
    )
    ids = [f"node{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=66)

    net = ChannelNetwork(seed=11)
    nodes = _build_wal_cluster(cfg, ids, keys, logdir, net)
    for i in range(24):
        nodes[ids[i % 4]].add_transaction(b"kd-tear-%03d" % i)
    for _ in range(8):
        for hb in nodes.values():
            hb.start_epoch()
        net.run()
        if all(hb.pending_tx_count() == 0 for hb in nodes.values()):
            break
    committed = [b.tx_list() for b in nodes[ids[0]].committed_batches]
    assert len(committed) >= 3
    for hb in nodes.values():
        hb.batch_log.close()
    for nid in ids:
        path = os.path.join(logdir, nid + ".log")
        _tear_last_clog(path)
        _tear_last_clog(path)

    net2 = ChannelNetwork(seed=12)
    nodes2 = _build_wal_cluster(cfg, ids, keys, logdir, net2)
    for hb in nodes2.values():
        # BOTH torn epochs re-entered as settle-only states: the
        # ordered frontier is past them, settlement two behind
        assert hb.epoch == len(committed)
        assert hb.settled_epoch == len(committed) - 2
        for e in (len(committed) - 2, len(committed) - 1):
            es = hb._epochs[e]
            assert es.ordered and es.acs is None
            assert not es.shares_issued
    net2.run()  # idle phase drives the settlers: shares re-issue
    for hb in nodes2.values():
        assert hb.settled_epoch == len(committed)
        got = [b.tx_list() for b in hb.committed_batches]
        assert got == committed  # same batches, once, in order
        hb.batch_log.close()


# ---------------------------------------------------------------------------
# backpressure parks at the bound under a wide window (satellite)
# ---------------------------------------------------------------------------


def test_backpressure_parks_at_bound_under_depth4():
    """decrypt_lag_max=2 under a depth-4 window: however many epochs
    run RBC/BBA concurrently, the ORDERED frontier never runs more
    than 2 epochs past settlement at any quiescence point, and the
    run still drains completely."""
    cfg = _depth_cfg(4, decrypt_lag_max=2)
    cluster = SimulatedCluster(config=cfg, seed=9, key_seed=3)
    for i in range(96):
        cluster.submit(b"kd-bp-%04d" % i)

    def check_bound(_r: int) -> None:
        for hb in cluster.nodes.values():
            lag = hb.epoch - hb.settled_epoch
            assert 0 <= lag <= 2, (
                hb.node_id, hb.epoch, hb.settled_epoch
            )

    cluster.run_epochs(on_quiescence=check_bound)
    depth = cluster.assert_agreement()
    assert depth >= 4
    n0 = cluster.nodes[cluster.ids[0]]
    assert n0.epoch == n0.settled_epoch  # fully settled at the end


# ---------------------------------------------------------------------------
# reconfig boundary under depth 4 (satellite)
# ---------------------------------------------------------------------------


@pytest.mark.faults
def test_reconfig_boundary_under_depth4():
    """A joiner ceremony under a depth-4 window: the validated
    ``reconfig_lead > pipeline_depth + decrypt_lag_max`` bound keeps
    every in-flight epoch on the correct side of the activation
    boundary — the switch converges, ledgers stay byte-identical, and
    the joiner participates under the new roster."""
    cfg = Config(
        n=4,
        batch_size=8,
        seed=7,
        pipeline_depth=4,
        decrypt_lag_max=2,
        reconfig_lead=8, crypto_backend="cpu",
    )
    c = SimulatedCluster(config=cfg, seed=7, key_seed=33)
    for i in range(12):
        c.submit(b"kd-pre-%03d" % i)
    c.run_until_drained(max_rounds=30)
    v = c.begin_reconfig(join=["node100"])
    assert v == 1
    c.run_until_drained(max_rounds=80)
    assert set(c.roster_versions().values()) == {1}
    for i in range(20):
        c.submit(b"kd-post-%03d" % i)
    c.run_until_drained(max_rounds=60)
    nids = list(c.nodes)
    depth = min(
        len(c.nodes[nid].committed_batches) for nid in nids
    )
    assert depth > 0
    for e in range(depth):
        bodies = {
            encode_batch_body(e, c.nodes[nid].committed_batches[e])
            for nid in nids
        }
        assert len(bodies) == 1, f"fork at epoch {e}"
    jn = c.nodes["node100"]
    assert jn.roster_version == 1
    assert any(
        "node100" in b.contributions and b.contributions["node100"]
        for b in jn.committed_batches
    ), "joiner never contributed a committed proposal"


@pytest.mark.faults
def test_depth1_vs_depth4_identical_ledgers_grpc():
    """Same roster, same submissions, real sockets: the depth-1 and
    depth-4 arms settle byte-identical multi-epoch ledgers."""
    from cleisthenes_tpu_torch.transport.host import ValidatorHost

    def run(depth: int) -> list:
        n = 4
        cfg = Config(crypto_backend="cpu",
            n=n,
            batch_size=8,
            seed=77,
            pipeline_depth=depth,
            reconfig_lead=max(8, depth + 4 + 1),
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
            # two epochs' worth of work (b//n = 2 per node per epoch)
            for i in range(16):
                hosts[ids[i % n]].submit(b"grpc-kd-%02d" % i)
            for h in hosts.values():
                h.propose()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if all(
                    len(h.committed_batches()) >= 2
                    for h in hosts.values()
                ):
                    break
                time.sleep(0.25)
            ledgers = {
                i: [
                    encode_batch_body(e, b)
                    for e, b in enumerate(h.committed_batches()[:2])
                ]
                for i, h in hosts.items()
            }
            assert all(len(l) == 2 for l in ledgers.values())
            first = ledgers[ids[0]]
            assert all(l == first for l in ledgers.values())
            return first
        finally:
            for h in hosts.values():
                h.stop()

    assert run(1) == run(4)
