# The reference's tests/test_byzantine.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
# test_byzantine_big_roster_prefix_consistency (~100 s on one CPU core) is in
# tests/test_torch_byzantine_roster.py, alone, so that one worker runs it.
"""Byzantine-coalition HBBFT tests: f fully-adversarial nodes whose
traffic is dropped, tampered, duplicated and replayed must never break
agreement or (with reliable honest channels) liveness.

These are the adversarial-scheduler + fault-injection tests SURVEY.md
§4/§5.3 calls for, at network scale.

The whole module carries the ``faults`` marker: ci.sh's fault-
regression stage replays it (plus the marked gRPC/transport fault
tests) over a fixed seed matrix, with ``FAULT_SEED`` selecting the
scheduler/coalition seed for the seed-parametrized scenarios."""

import os

import pytest

from cleisthenes_tpu_torch.protocol.cluster import run_until_drained
from cleisthenes_tpu_torch.utils.adversary import Coalition
from tests.test_torch_honeybadger import (
    assert_identical_batches,
    make_hb_network,
    push_txs,
)

pytestmark = pytest.mark.faults

# the ci.sh fault gate exports one seed per stage run; a plain pytest
# run uses the default
FAULT_SEEDS = tuple(
    int(s)
    for s in os.environ.get("FAULT_SEED", "11").replace(",", " ").split()
)


def run_epochs(net, nodes, skip=(), max_rounds=40):
    """The shared propose-and-drain loop (protocol.cluster
    run_until_drained) under this module's historical name."""
    run_until_drained(net, nodes, skip=skip, max_rounds=max_rounds)


@pytest.mark.parametrize("seed", [1, 7])
def test_byzantine_node_dropping_own_traffic(seed):
    """A faulty node that loses half its messages is just a slow/faulty
    node: the other n-f must still commit identically."""
    cfg, net, nodes = make_hb_network(4, batch_size=8, seed=seed)
    bad = "node3"
    net.fault_filter = Coalition([bad], seed=seed).drop(0.5).filter
    push_txs(nodes, 12)
    run_epochs(net, nodes)
    assert_identical_batches(nodes)


@pytest.mark.parametrize("seed", [2, 9])
def test_byzantine_tampering_caught_by_macs(seed):
    """Tampered frames from the coalition fail MAC verification and
    count as rejected, never as protocol votes."""
    cfg, net, nodes = make_hb_network(4, batch_size=8, seed=seed, auth=True)
    bad = "node1"
    net.fault_filter = Coalition([bad], seed=seed).tamper(0.7).filter
    push_txs(nodes, 12)
    run_epochs(net, nodes)
    assert_identical_batches(nodes)
    rejected = sum(
        net.endpoint_stats(nid)["rejected"] for nid in net.node_ids()
    )
    assert rejected > 0  # the tampering actually happened and was caught


@pytest.mark.parametrize("seed", [3, 11])
def test_byzantine_duplication_and_replay(seed):
    """Duplicated and replayed (valid-MAC) frames must be absorbed by
    per-sender dedup: same committed batches, no double counting."""
    cfg, net, nodes = make_hb_network(4, batch_size=8, seed=seed, auth=True)
    bad = "node2"
    net.fault_filter = (
        Coalition([bad], seed=seed).duplicate(0.5, copies=3).replay(0.5).filter
    )
    push_txs(nodes, 12)
    run_epochs(net, nodes)
    depth = assert_identical_batches(nodes)
    all_txs = [
        tx
        for b in nodes["node0"].committed_batches[:depth]
        for tx in b.tx_list()
    ]
    assert len(all_txs) == len(set(all_txs))  # replay never double-commits


def test_byzantine_full_coalition_n7():
    """n=7, f=2: two colluding nodes drop+tamper+duplicate while the
    scheduler is adversarial; five honest nodes commit identically."""
    cfg, net, nodes = make_hb_network(7, batch_size=8, seed=5, auth=True)
    coalition = ["node5", "node6"]
    net.fault_filter = (
        Coalition(coalition, seed=5)
        .drop(0.3)
        .tamper(0.3)
        .duplicate(0.3)
        .replay(0.3)
        .filter
    )
    push_txs(nodes, 14)
    run_epochs(net, nodes)
    assert_identical_batches(nodes)


def test_byzantine_silent_coalition_liveness():
    """f completely silent nodes (drop everything): the protocol's
    worst-case crash pattern at full fault budget."""
    cfg, net, nodes = make_hb_network(7, batch_size=8, seed=13)
    coalition = ["node0", "node1"]  # includes the lowest-id proposer
    net.fault_filter = Coalition(coalition, seed=13).drop(1.0).filter
    push_txs(nodes, 14, prefix=b"live")
    run_epochs(net, nodes, skip=coalition)
    depth = assert_identical_batches(nodes, skip=coalition)
    assert depth >= 1


def test_byzantine_poisoned_ciphertext_excluded():
    """ADVICE.md high finding: a proposer whose RBC'd
    "ciphertext" carries c1 = P-1 (the order-2 element, outside the
    prime-order subgroup) used to make every honest node's decryption
    share fail verification forever, burning all honest senders and
    halting consensus.  With subgroup validation at deserialization the
    proposer is deterministically excluded and the epoch commits."""
    import struct

    from cleisthenes_tpu_torch.ops.modmath import P

    cfg, net, nodes = make_hb_network(4, batch_size=8, seed=17)
    bad = "node3"
    c2 = b"\x00" * 16
    poisoned = (
        (P - 1).to_bytes(32, "big")
        + struct.pack(">I", len(c2))
        + c2
        + b"\x11" * 32
    )
    hb_bad = nodes[bad]

    def poisoned_start():
        es = hb_bad._epoch_state(hb_bad.epoch)
        if es is None or es.proposed:
            return
        es.proposed = True
        es.my_txs = []
        es.acs.input(poisoned)

    hb_bad.start_epoch = poisoned_start
    # txs go to honest nodes only: anything queued at the poisoned
    # proposer can never commit, and its non-empty queue would keep
    # auto-proposing fresh (excluded) epochs forever — a livelock of
    # the TEST setup, not the protocol
    push_txs({k: v for k, v in nodes.items() if k != bad}, 12)
    run_epochs(net, nodes, skip=(bad,))
    depth = assert_identical_batches(nodes)
    assert depth >= 1
    # the poisoned proposal contributed no transactions anywhere
    for hb in nodes.values():
        for b in hb.committed_batches:
            assert all(tx.startswith(b"tx-") for tx in b.tx_list())


def test_byzantine_invalid_dec_share_falls_back_to_verified_path():
    """A Byzantine member broadcasting junk decryption shares must not
    poison the optimistic (unverified-subset) TPKE combine: the bad tag
    flips the proposer onto the CP-verified path, the junk share burns,
    and every honest node still commits identically."""
    from cleisthenes_tpu_torch.ops.tpke import DhShare

    cfg, net, nodes = make_hb_network(4, batch_size=8)  # FIFO scheduler
    bad = "node0"  # sorts first: its junk share lands in the subset
    hb_bad = nodes[bad]
    real_batch = hb_bad.tpke.dec_share_batch

    def junk_dec_share_batch(share, cts):
        return [
            DhShare(index=good.index, d=12345, e=good.e, z=good.z)
            for good in real_batch(share, cts)
        ]

    hb_bad.tpke.dec_share_batch = junk_dec_share_batch
    # the K-deep eager path (Config.pipeline_depth > 1) issues
    # through the hub's dec-share column instead of tpke — tamper
    # that seam identically so the junk rides either issue path
    real_take = hb_bad.hub.take_dec_issues

    def junk_take(owner):
        rows = real_take(owner)
        if owner is hb_bad:
            rows = [
                (meta, DhShare(index=s.index, d=12345, e=s.e, z=s.z))
                for meta, s in rows
            ]
        return rows

    hb_bad.hub.take_dec_issues = junk_take
    push_txs(nodes, 12)
    run_epochs(net, nodes)
    assert_identical_batches(nodes)
    # the fallback actually exercised: some honest node hit a bad tag
    fallbacks = sum(
        len(es.opt_failed)
        for nid, hb in nodes.items()
        if nid != bad
        for es in hb._epochs.values()
    )
    burned = sum(
        bad in pool._burned
        for nid, hb in nodes.items()
        if nid != bad
        for es in hb._epochs.values()
        for pool in es.dec_shares.values()
    )
    assert fallbacks + burned > 0  # junk was seen and survived


def test_byzantine_invalid_coin_share_does_not_stall_reveal():
    """Regression: a Byzantine member broadcasting
    invalid coin shares burns its collected slot, and the REPLACEMENT
    shares already parked in the pool must still be collected — under
    dirty-set flushing nothing else re-offers them (every share may
    already have arrived), so the verdict callback re-marks the BBA.
    Pre-fix, every node's round-0 coin stayed unrevealed forever and
    zero transactions committed."""
    from cleisthenes_tpu_torch.ops import tpke as tpke_mod

    cfg, net, nodes = make_hb_network(4, batch_size=8)  # FIFO scheduler
    bad = "node0"  # sorts first: collected into the f+1 verify subset
    hb_bad = nodes[bad]
    real_issue = tpke_mod.issue_share
    bad_secret_value = hb_bad.keys.coin_share.value

    def junk_issue(share, base, context, group=tpke_mod.DEFAULT_GROUP):
        good = real_issue(share, base, context, group)
        if (
            context.startswith(b"coin|")
            and share.value == bad_secret_value
        ):
            return tpke_mod.DhShare(
                index=good.index, d=12345, e=good.e, z=good.z
            )
        return good

    tpke_mod.issue_share = junk_issue
    try:
        # route the patched module function through the bad node's coin
        hb_bad.coin.share = (
            lambda secret, coin_id: junk_issue(
                secret,
                __import__(
                    "cleisthenes_tpu_torch.ops.coin", fromlist=["coin_base"]
                ).coin_base(coin_id, hb_bad.coin.group),
                b"coin|" + coin_id,
                hb_bad.coin.group,
            )
        )
        push_txs(nodes, 12)
        run_epochs(net, nodes)
    finally:
        tpke_mod.issue_share = real_issue
    assert_identical_batches(nodes)
    committed = sum(
        len(b) for b in nodes["node1"].committed_batches
    )
    assert committed == 12  # liveness: everything still commits


@pytest.mark.skipif(
    __import__("os").environ.get("RUN_SLOW") != "1",
    reason="~5 min seeded adversarial sweep (RUN_SLOW=1 to enable)",
)
def test_byzantine_seeded_sweep():
    """Randomized coalition compositions across many scheduler seeds:
    every combination of drop/tamper/duplicate/replay from a random
    f-sized coalition, under a random adversarial delivery order, must
    preserve agreement among the honest majority — the protocol
    fuzzing pass (the reference has nothing comparable; its tests are
    4 fixed unit scenarios)."""
    import random as _random

    for seed in range(24):
        rng = _random.Random(seed)
        n = rng.choice([4, 5, 7])
        f = (n - 1) // 3
        cfg, net, nodes = make_hb_network(n, batch_size=8, seed=seed)
        bad = rng.sample(sorted(nodes), f)
        coal = Coalition(bad, seed=seed)
        for stage, arg in (
            ("drop", rng.uniform(0.1, 0.6)),
            ("tamper", rng.uniform(0.0, 0.7)),
            ("duplicate", rng.uniform(0.0, 0.5)),
            ("replay", rng.uniform(0.0, 0.5)),
        ):
            if rng.random() < 0.7:
                getattr(coal, stage)(arg)
        net.fault_filter = coal.filter
        push_txs(nodes, 3 * n)
        run_epochs(net, nodes)
        honest = {k: v for k, v in nodes.items() if k not in bad}
        hist = {
            tuple(
                tuple(sorted(b.tx_list())) for b in hb.committed_batches
            )
            for hb in honest.values()
        }
        # strict whole-history equality is SOUND here because these
        # small rosters drain (run_epochs exits on the drained
        # condition, not the round cap) — for rosters that may stop at
        # the cap, the correct assertion is prefix consistency; see
        # test_byzantine_big_roster_prefix_consistency below and the
        # seed-1005 classification (tools/sweep_roster.py)
        assert len(hist) == 1, f"agreement broke at seed {seed} (bad={bad})"
        committed = sum(
            len(b)
            for b in next(iter(honest.values())).committed_batches
        )
        assert committed > 0, f"no progress at seed {seed} (bad={bad})"


@pytest.mark.parametrize("seed", [21, 31])
def test_byzantine_delayed_frames_released_much_later(seed):
    """A coalition that HOLDS its frames and releases them many filter
    calls later (Coalition.delay) must not break agreement: a delayed
    frame is just an adversarial asynchronous schedule, and per-sender
    dedup absorbs stale arrivals."""
    cfg, net, nodes = make_hb_network(4, batch_size=8, seed=seed, auth=True)
    bad = "node2"
    coal = Coalition([bad], seed=seed).delay(0.3, hold=40)
    net.fault_filter = coal.filter
    push_txs(nodes, 12)
    run_epochs(net, nodes)
    assert_identical_batches(nodes)
    assert coal.held_total > 0  # the stage actually held frames
    assert coal.released_total > 0  # ...and released some much later


@pytest.mark.parametrize("seed", FAULT_SEEDS)
def test_crash_restart_wal_catchup_under_byzantine_coalition(
    tmp_path, seed
):
    """The crash-recovery acceptance scenario: a network with one
    Byzantine member (drop 0.3 + replay 0.2) commits epochs; an HONEST
    node then fail-stops, the survivors keep committing, and a fresh
    process restarted from the victim's WAL rejoins via CATCHUP —
    converging to byte-identical committed batches for every common
    epoch, including the epochs it was down for.

    Roster arithmetic: the down phase carries TWO simultaneous faults
    (the drop-lossy Byzantine member + the crashed honest node), so it
    needs f >= 2 — at n=4/f=1 the survivors' quorum is exactly the
    three live nodes including the lossy one, and a dropped frame
    wedges the wave forever (frame drops have no retransmission; a
    quiescent epoch is absorbing).  n=7/f=2 keeps the scenario inside
    the fault budget, which is what HBBFT actually promises."""
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.core.ledger import BatchLog, encode_batch_body
    from cleisthenes_tpu_torch.protocol.honeybadger import HoneyBadger, setup_keys
    from cleisthenes_tpu_torch.transport.base import HmacAuthenticator
    from cleisthenes_tpu_torch.transport.broadcast import ChannelBroadcaster
    from cleisthenes_tpu_torch.transport.channel import ChannelNetwork

    cfg = Config(n=7, batch_size=8, crypto_backend="cpu")
    ids = [f"node{i}" for i in range(7)]
    keys = setup_keys(cfg, ids, seed=33)
    net = ChannelNetwork(seed=seed)
    bad = "node6"
    net.fault_filter = (
        Coalition([bad], seed=seed).drop(0.3).replay(0.2).filter
    )
    victim = "node1"

    def build(node_id, log):
        return HoneyBadger(
            config=cfg,
            node_id=node_id,
            member_ids=ids,
            keys=keys[node_id],
            out=ChannelBroadcaster(net, node_id, ids),
            batch_log=log,
        )

    nodes = {}
    for nid in ids:
        log = (
            BatchLog(str(tmp_path / f"{nid}.log")) if nid == victim else None
        )
        nodes[nid] = build(nid, log)
        net.join(nid, nodes[nid], HmacAuthenticator(nid, keys[nid].mac_keys))

    push_txs(nodes, 14, prefix=b"pre")
    run_epochs(net, nodes)
    k = assert_identical_batches(nodes)
    assert k >= 1  # the victim crashes AFTER epoch k-1 committed

    # fail-stop: in-flight frames die with the process; the WAL survives
    net.crash(victim)
    nodes[victim].batch_log.close()
    survivors = {n: h for n, h in nodes.items() if n != victim}
    push_txs(survivors, 14, prefix=b"down")
    run_epochs(net, survivors)
    down_depth = assert_identical_batches(survivors)
    assert down_depth > k  # epochs committed WHILE the victim was down

    # restart: fresh process, same identity/keys, state from the WAL
    fresh = build(victim, BatchLog(str(tmp_path / f"{victim}.log")))
    assert fresh.epoch >= k  # resumed from the log, not from epoch 0
    net.restart(
        victim, fresh, HmacAuthenticator(victim, keys[victim].mac_keys)
    )
    nodes[victim] = fresh
    fresh.request_catchup()
    net.run()
    # rejoin the live protocol for one more joint wave
    push_txs(nodes, 8, prefix=b"post")
    run_epochs(net, nodes)
    depth = assert_identical_batches(nodes)
    assert depth >= down_depth  # caught up through its whole outage
    # byte-identical committed batches (ledger-body bytes) everywhere,
    # down epochs included
    for e in range(depth):
        want = encode_batch_body(e, nodes["node0"].committed_batches[e])
        for nid in ids:
            got = encode_batch_body(e, nodes[nid].committed_batches[e])
            assert got == want, f"epoch {e}: {nid} bytes differ"
    fresh.batch_log.close()


def test_byzantine_duplicate_index_dec_share_does_not_stall():
    """Regression: the batched dec-share handler
    probes decryption only on the pool-size threshold CROSSING.  A
    Byzantine member replaying an HONEST node's share index makes the
    pool hit the size threshold with too few distinct Shamir indices;
    the epoch must still decrypt when real shares arrive later —
    pre-fix the crossing was consumed and no later add re-probed,
    stalling commit forever."""
    from cleisthenes_tpu_torch.ops.tpke import DhShare

    cfg, net, nodes = make_hb_network(4, batch_size=8)  # FIFO scheduler
    bad = "node0"  # sorts first: its share lands early in every pool
    hb_bad = nodes[bad]
    real_batch = hb_bad.tpke.dec_share_batch

    def replayed_index_batch(share, cts):
        # claim another sender's index: a valid-looking duplicate that
        # contributes no distinct interpolation point
        return [
            DhShare(index=2, d=good.d, e=good.e, z=good.z)
            for good in real_batch(share, cts)
        ]

    hb_bad.tpke.dec_share_batch = replayed_index_batch
    push_txs(nodes, 12)
    run_epochs(net, nodes)
    assert_identical_batches(nodes)
    committed = sum(len(b) for b in nodes["node1"].committed_batches)
    assert committed >= 12  # liveness held despite the index replay


@pytest.mark.parametrize("seed", [19, 29])
def test_byzantine_reordered_frames_preserve_agreement(seed):
    """Coalition.reorder: a coalition whose frames arrive permuted
    within a sliding window is just another adversarial asynchronous
    schedule — agreement and liveness must hold, and the stage must
    actually have reordered something."""
    cfg, net, nodes = make_hb_network(4, batch_size=8, seed=seed, auth=True)
    bad = "node1"
    coal = Coalition([bad], seed=seed).reorder(0.4, window=4)
    net.fault_filter = coal.filter
    push_txs(nodes, 12)
    run_epochs(net, nodes)
    assert_identical_batches(nodes)
    assert coal.held_total > 0  # frames were actually held...
    assert coal.released_total > 0  # ...and released out of order


def test_replay_capture_is_a_reservoir_over_the_whole_run():
    """Regression (capture bias): _captured used to keep only the
    FIRST 4096 frames, so replay could never resend late-run traffic.
    The seeded reservoir must hold a healthy share of late frames
    after seeing 3x its capacity."""
    coal = Coalition(["evil"], seed=7).replay(0.5)
    cap = coal._capture_cap
    total = 3 * cap
    for i in range(total):
        # non-member sender: stages don't run, capture still does
        coal.filter("honest", "peer", b"frame-%08d" % i)
    assert len(coal._captured) == cap
    late = sum(
        1
        for f in coal._captured
        if int(f.split(b"-")[1]) >= total - cap
    )
    # uniform reservoir => ~1/3 of residents come from the last third;
    # the old first-N capture held exactly zero of them
    assert late > cap // 10


def test_coalition_without_replay_captures_nothing():
    """Capture memory is paid only when a replay stage exists."""
    coal = Coalition(["evil"], seed=7).drop(0.5)
    coal.filter("honest", "peer", b"frame")
    assert coal._captured == []


def test_metrics_transport_block_surfaces_rejections_and_dedup():
    """Metrics.snapshot()["transport"]: MAC rejections (tamper) and
    dedup absorption (duplicate+replay) are reachable through the
    public metrics surface — no reaching into net._endpoints."""
    from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster

    c = SimulatedCluster(n=4, batch_size=8, seed=5, crypto_backend="cpu")
    bad = c.ids[3]
    c.fault_filter = (
        Coalition([bad], seed=5)
        .tamper(0.4)
        .duplicate(0.5, copies=3)
        .replay(0.4)
        .filter
    )
    for i in range(12):
        c.submit(b"tx-%04d" % i)
    c.run_until_drained()
    c.assert_agreement()
    snap = c.nodes[c.ids[0]].metrics.snapshot()["transport"]
    assert snap["delivered"] > 0
    rejected = sum(
        c.nodes[nid].metrics.snapshot()["transport"]["rejected"]
        for nid in c.ids
    )
    absorbed = sum(
        c.nodes[nid].metrics.snapshot()["transport"]["dedup_absorbed"]
        for nid in c.ids
    )
    assert rejected > 0  # tampered frames failed their MACs
    assert absorbed > 0  # duplicated/replayed votes were absorbed


def test_rejected_frames_emit_trace_instants():
    """Every MAC-rejected frame lands in the flight recorder as a
    transport/rejected instant, so adversarial runs are visible in
    tracetool reports."""
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster

    c = SimulatedCluster(
        n=4,
        config=Config(n=4, batch_size=8, trace=True, crypto_backend="cpu"),
        seed=5,
    )
    bad = c.ids[2]
    c.fault_filter = Coalition([bad], seed=5).tamper(0.6).filter
    for i in range(8):
        c.submit(b"tx-%04d" % i)
    c.run_until_drained()
    c.assert_agreement()
    rejected_events = [
        ev
        for events in c.trace_events().values()
        for ev in events
        if ev[3] == "transport" and ev[4] == "rejected"
    ]
    assert rejected_events, "no transport/rejected instants recorded"
    total_rejected = sum(
        c.net.endpoint_stats(nid)["rejected"] for nid in c.ids
    )
    assert len(rejected_events) == total_rejected


def test_byzantine_garbage_echo_batch_burns_and_commits():
    """A Byzantine MEMBER injects structurally-valid EchoBatchPayloads
    with garbage branches/shards (its own MAC, so the frames decode):
    honest nodes must park them, burn the slots on batched branch
    verification, and still commit identically from the real echoes —
    the adversarial case for the columnar ECHO path."""
    import time as _time

    from cleisthenes_tpu_torch.transport.message import (
        EchoBatchPayload,
        Message,
    )

    cfg, net, nodes = make_hb_network(4, batch_size=8)
    ids = sorted(nodes)
    bad = "node3"
    push_txs(nodes, 12)
    for hb in nodes.values():
        hb.start_epoch()
    # first wave delivers VALs; inject the garbage batches directly
    # into every honest node's handler (sender is a roster member, so
    # the membership gate passes — exactly what a MAC'd frame yields)
    garbage = EchoBatchPayload(
        epoch=0,
        shard_index=3,
        proposers=tuple(ids),
        roots=tuple(b"\x5a" * 32 for _ in ids),
        branches=tuple((b"\x5b" * 32, b"\x5c" * 32) for _ in ids),
        shards=tuple(b"\x5d" * 16 for _ in ids),
    )
    for nid in ids:
        if nid != bad:
            nodes[nid].serve_request(
                Message(sender_id=bad, timestamp=_time.time(),
                        payload=garbage, signature=b"")
            )
    run_epochs(net, nodes)
    honest = {k: v for k, v in nodes.items() if k != bad}
    hist = {
        tuple(tuple(sorted(b.tx_list())) for b in hb.committed_batches)
        for hb in honest.values()
    }
    assert len(hist) == 1
    committed = sum(
        len(b) for b in next(iter(honest.values())).committed_batches
    )
    assert committed > 0
