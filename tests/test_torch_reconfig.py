# The reference's tests/test_reconfig.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Dynamic membership: RECONFIG transactions, in-band key
resharing, joiner bootstrap via CATCHUP, retirement teardown, and WAL
replay across the roster switch — on both transports.
"""

from __future__ import annotations

import threading
import time

import pytest

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.ledger import encode_batch_body
from cleisthenes_tpu_torch.core.member import Member, RosterSchedule, RosterVersion
from cleisthenes_tpu_torch.protocol import reconfig as rcfg
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster
from cleisthenes_tpu_torch.protocol.honeybadger import setup_keys


# ---------------------------------------------------------------------------
# unit: versioned rosters + codecs
# ---------------------------------------------------------------------------


def _rv(version, activation, ids):
    return RosterVersion(
        version=version,
        activation_epoch=activation,
        members=tuple(Member(id=m) for m in ids),
    )


def test_roster_schedule_resolution():
    sched = RosterSchedule(_rv(0, 0, ["a", "b", "c", "d"]))
    sched.install(_rv(1, 10, ["b", "c", "d", "e"]))
    assert sched.version_for(0).version == 0
    assert sched.version_for(9).version == 0
    assert sched.version_for(10).version == 1
    assert sched.version_for(999).version == 1
    assert sched.known_member_ids() == frozenset("abcde")
    with pytest.raises(ValueError):
        sched.install(_rv(3, 20, ["b"]))  # skips version 2
    with pytest.raises(ValueError):
        sched.install(_rv(2, 10, ["b"]))  # activation does not advance


def test_roster_version_sorts_members():
    rv = _rv(0, 0, ["d", "a", "c", "b"])
    assert rv.member_ids == ("a", "b", "c", "d")
    assert rv.n == 4 and rv.f == 1


def test_reconfig_tx_roundtrip_and_validation():
    secret, pub = rcfg.enrollment_keypair(seed=5)
    tx = rcfg.encode_reconfig_tx(
        3,
        [("b", "", 0), ("a", "10.0.0.1", 4711), ("j", "", 0)],
        {"j": pub},
    )
    assert rcfg.is_protocol_tx(tx)
    spec = rcfg.decode_reconfig_tx(tx)
    assert spec.version == 3
    assert spec.member_ids == ("a", "b", "j")
    assert spec.members[0] == ("a", "10.0.0.1", 4711)
    assert spec.enroll_pubs == {"j": pub}
    assert spec.n == 3 and spec.f == 0 and spec.threshold == 1
    # malformations reject deterministically
    with pytest.raises(ValueError):
        rcfg.decode_reconfig_tx(tx + b"\x00")  # trailing bytes
    with pytest.raises(ValueError):
        rcfg.decode_reconfig_tx(b"\x00RCFG1|garbage")
    with pytest.raises(ValueError):  # enrollment key for a non-member
        rcfg.decode_reconfig_tx(
            rcfg.encode_reconfig_tx(1, [("a", "", 0)], {"z": pub})
        )
    with pytest.raises(ValueError):  # pub outside the group
        rcfg.decode_reconfig_tx(
            rcfg.encode_reconfig_tx(1, [("j", "", 0)], {"j": 0})
        )


def test_dealing_tx_roundtrip():
    tx = rcfg.encode_dealing_tx(
        2, "dealer-a", [3, 5], [7, 11], {"x": b"A" * 96, "y": b"B" * 96}
    )
    assert rcfg.is_protocol_tx(tx)
    d = rcfg.decode_dealing_tx(tx)
    assert d.version == 2 and d.dealer == "dealer-a"
    assert d.tpke_commits == (3, 5) and d.coin_commits == (7, 11)
    assert sorted(d.blobs) == ["x", "y"]
    with pytest.raises(ValueError):
        rcfg.decode_dealing_tx(tx[:-1])


def _pvss_fixture(tamper=None):
    """A full dealing (tpke + coin sharings over 4 receivers) with
    optional tampering applied to one receiver's blob bytes."""
    import hashlib

    from cleisthenes_tpu_torch.ops.dkg import DkgDealing
    from cleisthenes_tpu_torch.ops.tpke import DEFAULT_GROUP as G

    n, t = 4, 2
    ids = [f"n{i}" for i in range(n)]
    xs = {
        rid: int.from_bytes(
            hashlib.sha256(b"pvss-x|" + rid.encode()).digest(), "big"
        )
        % G.q
        for rid in ids
    }
    pubs = {rid: pow(G.g, x, G.p) for rid, x in xs.items()}
    deal_t = DkgDealing(1, n, t, G, seed=42)
    deal_c = DkgDealing(1, n, t, G, seed=43)
    ct = tuple(deal_t.commitments(backend="cpu", device="cpu"))
    cc = tuple(deal_c.commitments(backend="cpu", device="cpu"))
    blobs = {}
    for j, rid in enumerate(ids, start=1):
        parts = []
        for kind, (deal, commits) in enumerate(
            ((deal_t, ct), (deal_c, cc))
        ):
            parts.append(
                rcfg.pvss_encrypt_share(
                    deal.share_for(j),
                    pubs[rid],
                    hashlib.sha256(
                        b"rho|%d|" % kind + rid.encode()
                    ).digest(),
                    rcfg._pvss_ctx(7, "d0", rid, kind, commits, G),
                    G,
                )
            )
        blobs[rid] = b"".join(parts)
    if tamper is not None:
        blobs = dict(blobs)
        blobs[tamper[0]] = tamper[1](blobs[tamper[0]])
    dealing = rcfg.Dealing(
        version=7, dealer="d0", tpke_commits=ct, coin_commits=cc,
        blobs=blobs,
    )
    return G, ids, xs, pubs, (deal_t, deal_c), dealing


def test_pvss_blob_roundtrip_and_public_verification():
    """The PVSS satellite's unit contract: blobs decrypt to the dealt
    shares, verification is PUBLIC (needs no receiver secret), and a
    blob tampered toward ONE receiver fails verification for every
    observer — the dealer is excluded deterministically rather than
    detected by the victim alone."""
    G, ids, xs, pubs, deals, dealing = _pvss_fixture()
    assert all(
        len(b) == rcfg.pvss_blob_len(G) for b in dealing.blobs.values()
    )
    assert rcfg.pvss_verify_dealing(dealing, pubs, G)
    for j, rid in enumerate(ids, start=1):
        for kind, deal in enumerate(deals):
            s = rcfg.pvss_decrypt_share(
                dealing.blobs[rid], kind, xs[rid], G
            )
            assert s == deal.share_for(j) % G.q
    # flip one ciphertext byte of one receiver's blob
    def _flip(b):
        ba = bytearray(b)
        ba[10] ^= 0x01
        return bytes(ba)

    _, _, _, pubs2, _, bad = _pvss_fixture(tamper=("n2", _flip))
    assert not rcfg.pvss_verify_dealing(bad, pubs2, G)


def test_pvss_rejects_wrong_share_ciphertext():
    """A dealer that encrypts a VALID-LOOKING ciphertext of the WRONG
    share to a targeted receiver (the docs/FAULTS.md limitation this
    PR closes) fails the DLEQ against its own commitments — publicly,
    on every node."""
    import hashlib

    from cleisthenes_tpu_torch.ops.dkg import DkgDealing
    from cleisthenes_tpu_torch.ops.tpke import DEFAULT_GROUP as G

    G2, ids, xs, pubs, (deal_t, deal_c), dealing = _pvss_fixture()

    def _reencrypt_wrong(blob):
        parts = []
        for kind, (deal, commits) in enumerate(
            (
                (deal_t, dealing.tpke_commits),
                (deal_c, dealing.coin_commits),
            )
        ):
            wrong = (deal.share_for(3) + 12345) % G.q
            parts.append(
                rcfg.pvss_encrypt_share(
                    wrong,
                    pubs["n2"],
                    hashlib.sha256(b"evil|%d" % kind).digest(),
                    rcfg._pvss_ctx(7, "d0", "n2", kind, commits, G),
                    G,
                )
            )
        return b"".join(parts)

    _, _, _, _, _, evil = _pvss_fixture(
        tamper=("n2", _reencrypt_wrong)
    )
    assert not rcfg.pvss_verify_dealing(evil, pubs, G)


def test_pair_mac_key_symmetry():
    """Both ends of every new pair derive the same key from opposite
    DH halves (old member: coin share vs enrollment pub; joiner:
    enrollment secret vs coin verification key)."""
    cfg = Config(n=4, batch_size=8, crypto_backend="cpu")
    ids = [f"n{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=9)
    es, ep = rcfg.enrollment_keypair(seed=17)
    g = keys["n0"].coin_pub.group
    old = keys["n1"]
    vk1 = old.coin_pub.verification_keys[old.coin_share.index - 1]
    k_old_side = rcfg.pair_mac_key(
        1, rcfg.dh_point(old.coin_share.value, ep, g), "n1", "j", g
    )
    k_joiner_side = rcfg.pair_mac_key(
        1, rcfg.dh_point(es, vk1, g), "j", "n1", g
    )
    assert k_old_side == k_joiner_side
    boot = rcfg.joiner_bootstrap_keys(es, 1, old.coin_pub, ids, "j")
    assert boot["n1"] == k_joiner_side


def test_config_validates_reconfig_lead():
    with pytest.raises(ValueError):
        Config(n=4, decrypt_lag_max=4, reconfig_lead=4, crypto_backend="cpu")
    # the bound now clears the K-deep in-flight window too
    # (reconfig_lead > pipeline_depth + decrypt_lag_max)
    with pytest.raises(ValueError):
        Config(
            n=4, decrypt_lag_max=4, pipeline_depth=2, reconfig_lead=6, crypto_backend="cpu"
        )
    Config(n=4, decrypt_lag_max=4, pipeline_depth=1, reconfig_lead=6, crypto_backend="cpu")  # ok
    Config(n=4, decrypt_lag_max=4, pipeline_depth=2, reconfig_lead=7, crypto_backend="cpu")  # ok


# ---------------------------------------------------------------------------
# channel transport: the full lifecycle
# ---------------------------------------------------------------------------


def _drained_cluster(n=4, seed=7, **kw):
    c = SimulatedCluster(n=n, batch_size=8, seed=seed, key_seed=33, **kw, crypto_backend="cpu")
    for i in range(3 * n):
        c.submit(b"pre-%03d" % i)
    c.run_until_drained(max_rounds=30)
    return c


def _assert_identical_ledgers(cluster, nids):
    depth = min(
        len(cluster.nodes[nid].committed_batches) for nid in nids
    )
    assert depth > 0
    for e in range(depth):
        bodies = {
            encode_batch_body(
                e, cluster.nodes[nid].committed_batches[e]
            )
            for nid in nids
        }
        assert len(bodies) == 1, f"fork at epoch {e}"
    return depth


def test_joiner_bootstraps_and_participates():
    """Acceptance: a joiner added mid-run adopts the committed log via
    CATCHUP, receives its shares from the in-band ceremony, and
    participates from the activation epoch — all honest nodes (old
    and new) hold byte-identical ledgers and identical key digests."""
    c = _drained_cluster()
    try:
        pre_depth = c.assert_agreement()
        v = c.begin_reconfig(join=["node100"])
        assert v == 1
        c.run_until_drained(max_rounds=60)
        assert set(c.roster_versions().values()) == {1}
        # the reconfig machinery's own txs are protocol-internal
        seen = [
            tx
            for b in c.committed()
            for tx in b.tx_list()
            if rcfg.is_protocol_tx(tx)
        ]
        assert any(tx.startswith(rcfg.RECONFIG_TX_PREFIX) for tx in seen)
        assert any(tx.startswith(rcfg.DEAL_TX_PREFIX) for tx in seen)
        # post-activation traffic: the joiner proposes under v1
        for i in range(20):
            c.submit(b"post-%03d" % i)
        c.run_until_drained(max_rounds=40)
        depth = _assert_identical_ledgers(c, list(c.nodes))
        assert depth > pre_depth
        jn = c.nodes["node100"]
        assert jn.roster_version == 1
        assert len(jn.committed_batches) == len(
            c.nodes["node000"].committed_batches
        )
        assert any(
            "node100" in b.contributions and b.contributions["node100"]
            for b in jn.committed_batches
        ), "joiner never contributed a committed proposal"
        # key agreement: every node derived the identical material
        digests = {
            hb.rosters.latest().key_material_digest
            for hb in c.nodes.values()
        }
        assert len(digests) == 1 and b"" not in digests
        # observability: the roster switch is visible per node
        snap = jn.metrics.snapshot()["reconfig"]
        assert snap == {"roster_version": 1, "reconfigs_total": 1}
    finally:
        c.stop()


def test_retirement_teardown():
    """A retired validator orders its last epoch at the boundary and
    parks; once the survivors settle past it, its pair keys drop and
    the broadcast set narrows — and the ledgers stay byte-identical
    up to the retiree's final epoch."""
    c = _drained_cluster(seed=11)
    try:
        v = c.begin_reconfig(join=["node100"], retire=["node003"])
        assert v == 1
        c.run_until_drained(max_rounds=60)
        for i in range(12):
            c.submit(b"post-%03d" % i, node_id="node100")
        c.run_until_drained(max_rounds=40, skip=("node003",))
        retiree = c.nodes["node003"]
        assert retiree._retired_self
        activation = retiree.rosters.latest().activation_epoch
        assert retiree.epoch == activation
        assert len(retiree.committed_batches) == activation
        # survivors moved past the boundary under the new roster
        for nid in ("node000", "node001", "node002", "node100"):
            hb = c.nodes[nid]
            assert hb.roster_version == 1
            assert len(hb.committed_batches) > activation
            assert "node003" not in hb.members
        # the retiree's prefix matches everyone's
        _assert_identical_ledgers(c, list(c.nodes))
        # MAC teardown: continuing nodes no longer hold its pair key
        assert "node003" not in c.auths["node000"]._peer_keys
        assert "node003" not in c.auths["node100"]._peer_keys
        # ...so post-teardown frames from the retiree are rejected
        rejected0 = c.net.endpoint_stats("node000")["rejected"]
        retiree.request_catchup()
        c.net.run()
        assert c.net.endpoint_stats("node000")["rejected"] > rejected0
    finally:
        c.stop()


def test_rekey_only_reconfig_rotates_material():
    """Same members, new version: the threshold key material rotates
    (proactive re-key) and the ledger keeps extending seamlessly."""
    c = _drained_cluster(seed=13)
    try:
        digest0 = c.nodes["node000"].rosters.latest().key_material_digest
        pub0 = c.nodes["node000"].active_view.keys.tpke_pub.master
        v = c.begin_reconfig()  # no joins, no retirements
        c.run_until_drained(max_rounds=60)
        assert set(c.roster_versions().values()) == {v}
        for i in range(12):
            c.submit(b"rekey-%03d" % i)
        c.run_until_drained(max_rounds=40)
        c.assert_agreement()
        rv1 = c.nodes["node000"].rosters.latest()
        assert rv1.member_ids == ("node000", "node001", "node002",
                                  "node003")
        assert rv1.key_material_digest != digest0
        pub1 = c.nodes["node000"].active_view.keys.tpke_pub.master
        assert pub1 != pub0
        digests = {
            hb.rosters.latest().key_material_digest
            for hb in c.nodes.values()
        }
        assert len(digests) == 1
    finally:
        c.stop()


@pytest.mark.slow
def test_reconfig_lifecycle_n64():
    """Reconfig at scale (BASELINE config 3 roster): a 64-validator
    cluster runs the full in-band ceremony — 22 qualifying PVSS
    dealings publicly verified by every node, a join+retire roster
    swap, MAC rotation for all ~2k surviving pairs — and the ledgers
    stay byte-identical across the boundary."""
    c = SimulatedCluster(n=64, batch_size=64, seed=29, key_seed=41, crypto_backend="cpu")
    try:
        # one epoch at n=64 costs ~15s wall (64^2 frames, RS-64
        # coding, 64-wide BBA banks): keep the tx load minimal and let
        # the CEREMONY be the thing this test spends its budget on
        for i in range(8):
            c.submit(b"pre-%03d" % i)
        c.run_until_drained(max_rounds=4)
        v = c.begin_reconfig(join=["node100"], retire=["node000"])
        assert v == 1
        c.run_until_drained(max_rounds=20)
        for i in range(8):
            c.submit(b"post-%03d" % i, node_id="node100")
        c.run_until_drained(max_rounds=8, skip=("node000",))
        survivors = [nid for nid in c.nodes if nid != "node000"]
        for nid in survivors:
            hb = c.nodes[nid]
            assert hb.roster_version == 1, nid
            assert hb.active_view.config.n == 64
            assert "node000" not in hb.members
        _assert_identical_ledgers(c, list(c.nodes))
        # every survivor committed the post-boundary traffic
        committed = set()
        for b in c.nodes["node100"].committed_batches:
            committed.update(b.tx_list())
        assert {b"post-%03d" % i for i in range(8)} <= committed
    finally:
        c.stop()


@pytest.mark.faults
def test_stale_mac_frames_rejected_after_rotation_channel():
    """MAC rotation satellite (channel transport): a rekey-only
    reconfig rotates EVERY surviving pair's MAC key; once the settled
    frontier crosses the boundary the pre-rotation keys are gone from
    both ends — frames MAC'd under a stale key are rejected."""
    c = _drained_cluster(seed=19)
    try:
        old_key = c.auths["node001"]._peer_keys["node000"]
        c.begin_reconfig()  # rekey-only: same members, new version
        c.run_until_drained(max_rounds=60)
        for i in range(8):
            c.submit(b"post-%03d" % i)
        c.run_until_drained(max_rounds=40)  # settle past the boundary
        # step 2+3 of the rotation lifecycle completed: fresh key on
        # both ends, verify-either alternates dropped
        new_key = c.auths["node001"]._peer_keys["node000"]
        assert new_key != old_key
        assert c.auths["node000"]._peer_keys["node001"] == new_key
        assert "node000" not in c.auths["node001"]._alt_keys
        assert "node001" not in c.auths["node000"]._alt_keys
        # a sender still MAC'ing under the pre-rotation key (a stale
        # process, or an attacker holding compromised v0 material) is
        # rejected at the receiving endpoint
        rejected0 = c.net.endpoint_stats("node000")["rejected"]
        c.auths["node001"].set_peer_key("node000", old_key)
        c.submit(b"stale-probe", node_id="node001")
        c.run_until_drained(max_rounds=10)
        assert c.net.endpoint_stats("node000")["rejected"] > rejected0
        # the rest of the roster (fresh keys) was unaffected
        c.assert_agreement()
    finally:
        c.stop()




@pytest.mark.faults
def test_wal_replay_across_reconfig_boundary_channel(tmp_path):
    """Satellite: a node crashes AFTER the RCFG record is durable but
    BEFORE the first post-activation commit, restarts from its WAL,
    re-derives the roster switch from the replayed log (cross-checked
    against the RCFG record), and rejoins under the NEW roster."""
    c = SimulatedCluster(
        n=4, batch_size=8, seed=7, key_seed=33,
        wal_dir=str(tmp_path), crypto_backend="cpu",
    )
    try:
        for i in range(12):
            c.submit(b"pre-%03d" % i)
        c.run_until_drained(max_rounds=30)
        c.begin_reconfig(join=["node100"])
        # quiesce WITHOUT post-activation traffic: every node crosses
        # the boundary (RCFG durable, settled == activation) but no
        # epoch >= activation has committed yet
        c.run_until_drained(max_rounds=60)
        victim = "node001"
        hb = c.nodes[victim]
        activation = hb.rosters.latest().activation_epoch
        assert hb.roster_version == 1
        assert len(hb.committed_batches) == activation
        # the RCFG record is on disk
        logged = list(hb.batch_log.replay_reconfigs())
        assert len(logged) == 1
        assert logged[0][0] == 1 and logged[0][1] == activation
        # fail-stop + process restart from the WAL
        c.crash(victim)
        hb2 = c.restart_node(victim)
        assert hb2.roster_version == 1
        assert hb2.epoch == activation
        assert "node100" in hb2.members
        assert hb2.active_view.keys.tpke_pub.master == (
            c.nodes["node000"].active_view.keys.tpke_pub.master
        )
        # the restarted node participates in post-activation epochs
        for i in range(16):
            c.submit(b"post-%03d" % i)
        c.run_until_drained(max_rounds=40)
        depth = _assert_identical_ledgers(c, list(c.nodes))
        assert depth > activation
        assert any(
            victim in b.contributions and b.contributions[victim]
            for b in hb2.committed_batches[activation:]
        ), "restarted node never proposed under the new roster"
    finally:
        c.stop()


def test_routing_arms_stay_byte_equivalent_across_reconfig():
    """The equivalence-arm contract survives the roster
    change: the same seeded schedule, run under the wave-routed and
    the scalar routing disciplines, commits byte-identical ledgers
    through a join+retire reconfig (the ResharePayload barrier and
    the roster-version demux behave identically on both arms)."""
    ledgers = {}
    for wave in (True, False):
        cfg = Config(
            n=4, batch_size=8, seed=5,
            wave_routing=wave, delivery_columnar=wave, crypto_backend="cpu",
        )
        c = SimulatedCluster(config=cfg, seed=5, key_seed=33)
        try:
            for i in range(12):
                c.submit(b"eq-%03d" % i)
            c.run_until_drained(max_rounds=30)
            c.begin_reconfig(join=["node100"], retire=["node003"])
            c.run_until_drained(max_rounds=60)
            for i in range(12, 24):
                c.submit(b"eq-%03d" % i, node_id="node100")
            c.run_until_drained(max_rounds=40, skip=("node003",))
            assert c.roster_versions()["node100"] == 1
            c.assert_agreement()
            ledgers[wave] = [
                encode_batch_body(e, b)
                for e, b in enumerate(
                    c.nodes["node000"].committed_batches
                )
            ]
        finally:
            c.stop()
    assert ledgers[True] == ledgers[False]


def test_fuzz_reconfig_schedules_hold_invariants():
    """The reconfig fuzz band's machinery end to end: sampled
    schedules carry a reconfig event, and the safety/liveness
    invariants hold across the roster change (two fixed seeds of the
    CI band; the band itself runs in ci.sh)."""
    from cleisthenes_tpu_torch.tools.fuzz import run_schedule, sample_schedule

    for seed in (0, 3):
        schedule = sample_schedule(seed, n=4, rounds=16, reconfig=True)
        assert any(
            ev["op"] == "reconfig" for ev in schedule["timeline"]
        )
        assert run_schedule(schedule, crypto="cpu") is None


# ---------------------------------------------------------------------------
# transport/health: retirement (satellite)
# ---------------------------------------------------------------------------






# ---------------------------------------------------------------------------
# gRPC transport: join + WAL replay across the boundary (satellite)
# ---------------------------------------------------------------------------


@pytest.mark.faults
def test_stale_mac_frames_rejected_after_rotation_grpc():
    """MAC rotation satellite (gRPC transport): the rekey-only
    ceremony runs over real sockets; post-activation, a host signing
    under the stale v0 pair key is rejected at the receiving server."""
    from cleisthenes_tpu_torch.transport.host import ValidatorHost

    n = 4
    cfg = Config(crypto_backend="cpu",
        n=n,
        batch_size=8,
        seed=7,
        dial_timeout_s=0.25,
        dial_retry_base_s=0.05,
        dial_retry_max_s=1.0,
        decrypt_lag_max=2,
        reconfig_lead=4,
        pipeline_depth=1,
    )
    ids = [f"node{i}" for i in range(n)]
    keys = setup_keys(cfg, ids, seed=77)
    old_key = keys["node1"].mac_keys["node0"]
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
            hosts[ids[i % n]].submit(b"pre-%02d" % i)
        for h in hosts.values():
            h.propose()
        for h in hosts.values():
            h.wait_commit(timeout=60)
        # rekey-only RECONFIG: same members, fresh key material
        members = [(m, *a.rsplit(":", 1)) for m, a in addrs.items()]
        members = [(m, ip, int(p)) for m, ip, p in members]
        hosts[ids[0]].submit(rcfg.encode_reconfig_tx(1, members, {}))
        for h in hosts.values():
            h.propose()
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            if all(h.node.roster_version == 1 for h in hosts.values()):
                break
            time.sleep(0.25)
        assert all(h.node.roster_version == 1 for h in hosts.values())
        # drive settlement past the boundary so teardown pins the
        # fresh keys and drops the verify-either alternates
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if all(
                "node0" not in h._auth._alt_keys
                and h._auth._peer_keys.get("node0", old_key) != old_key
                for h in hosts.values()
                if h.node_id != "node0"
            ):
                break
            for i in range(4):
                hosts[ids[i % n]].submit(b"post-%02d" % i)
            for h in hosts.values():
                h.propose()
            time.sleep(0.5)
        assert hosts["node1"]._auth._peer_keys["node0"] != old_key
        assert "node1" not in hosts["node0"]._auth._alt_keys
        # stale sender: node1 signs to node0 under the v0 key
        rejected0 = hosts["node0"]._transport_stats()["rejected"]
        hosts["node1"]._auth.set_peer_key("node0", old_key)
        hosts["node1"].submit(b"stale-probe")
        hosts["node1"].propose()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if hosts["node0"]._transport_stats()["rejected"] > rejected0:
                break
            time.sleep(0.1)
        assert hosts["node0"]._transport_stats()["rejected"] > rejected0
    finally:
        for h in hosts.values():
            h.stop()


def test_health_tracker_retirement():
    from cleisthenes_tpu_torch.transport.health import PeerHealthTracker

    t = PeerHealthTracker(["a", "b"])
    t.dial_failed("a")
    assert "a" in t.snapshot()
    t.retire("a")
    assert t.is_retired("a")
    assert "a" not in t.snapshot()
    # racing dial events for a retired peer must not resurrect it
    t.dial_started("a")
    t.dial_failed("a")
    t.dial_scheduled("a", 0.5)
    t.connected("a")
    t.stream_lost("a")
    assert "a" not in t.snapshot()
    assert t.state("a") == "down"
    # the live peer is untouched
    t.connected("b")
    assert t.snapshot()["b"]["state"] == "up"


@pytest.mark.faults
def test_grpc_retired_peer_stops_redial_storm():
    """Satellite: a host redialing an unreachable peer backs off; the
    moment the peer retires, the loop cancels — dial attempts stop
    growing and the peer vanishes from transport_health."""
    from cleisthenes_tpu_torch.transport.host import ValidatorHost

    cfg = Config(crypto_backend="cpu",
        n=4,
        batch_size=8,
        seed=7,
        dial_timeout_s=0.1,
        dial_retry_base_s=0.02,
        dial_retry_max_s=0.1,
    )
    ids = [f"node{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=77)
    host = ValidatorHost(cfg, "node0", ids, keys["node0"])
    try:
        host.listen()
        # a peer that will never answer: the redial loop spins up
        host._addrs["node1"] = "127.0.0.1:1"  # reserved port: refused
        t = threading.Thread(
            target=host._redial_loop, args=("node1",), daemon=True
        )
        t.start()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            snap = host.health.snapshot().get("node1")
            if snap is not None and snap["dial_attempts"] >= 2:
                break
            time.sleep(0.02)
        assert snap is not None and snap["dial_attempts"] >= 2
        # retire: the loop must cancel and the health row drop
        host.retire_peer("node1")
        t.join(timeout=5)
        assert not t.is_alive(), "redial loop survived retirement"
        assert "node1" not in host.health.snapshot()
        assert "node1" not in host.members
    finally:
        host.stop()


@pytest.mark.faults
def test_grpc_join_and_wal_replay_across_reconfig(tmp_path):
    """The acceptance scenario over real sockets: a joiner host dials
    in mid-run, bootstraps via CATCHUP, and participates from its
    activation epoch; a crash-restarted member replays the roster
    switch from its WAL and rejoins under the NEW roster — ledgers
    byte-identical across old, new, and restarted nodes."""
    from cleisthenes_tpu_torch.protocol.honeybadger import NodeKeys
    from cleisthenes_tpu_torch.transport.host import ValidatorHost

    n = 4
    cfg = Config(crypto_backend="cpu",
        n=n,
        batch_size=8,
        seed=7,
        dial_timeout_s=0.25,
        dial_retry_base_s=0.05,
        dial_retry_max_s=1.0,
        decrypt_lag_max=2,
        reconfig_lead=4,
        # lockstep window keeps this scenario's tight reconfig_lead
        # legal (ISSUE 15 validates lead > depth + lag); the K-deep
        # reconfig-boundary case lives in tests/test_pipeline_depth.py
        pipeline_depth=1,
    )
    ids = [f"node{i}" for i in range(n)]
    keys = setup_keys(cfg, ids, seed=77)
    victim = "node2"
    wal = str(tmp_path / "node2.log")
    hosts = {
        i: ValidatorHost(
            cfg, i, ids, keys[i],
            batch_log_path=wal if i == victim else None,
        )
        for i in ids
    }
    joiner = None
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
        for i, tx in enumerate([b"pre-%02d" % i for i in range(8)]):
            hosts[ids[i % n]].submit(tx)
        for h in hosts.values():
            h.propose()
        for h in hosts.values():
            h.wait_commit(timeout=60)

        # -- the joiner host boots and the operator submits RECONFIG --
        jid = "nodeJ"
        enroll_secret, enroll_pub = rcfg.enrollment_keypair(seed=99)
        jkeys = NodeKeys(
            tpke_pub=keys[ids[0]].tpke_pub,
            tpke_share=None,
            coin_pub=keys[ids[0]].coin_pub,
            coin_share=None,
            mac_keys=rcfg.joiner_bootstrap_keys(
                enroll_secret, 1, keys[ids[0]].coin_pub, ids, jid
            ),
            enroll_secret=enroll_secret,
        )
        import dataclasses as _dc

        joiner = ValidatorHost(
            _dc.replace(cfg, n=n, f=None),
            jid,
            ids,
            jkeys,
            joining=True,
        )
        jaddr = joiner.listen()
        jt = threading.Thread(target=joiner.connect, args=(addrs,))
        jt.start()
        jt.join(timeout=15)
        jip, jport = jaddr.rsplit(":", 1)
        members = [(m, *a.rsplit(":", 1)) for m, a in addrs.items()]
        members = [(m, ip, int(p)) for m, ip, p in members]
        members.append((jid, jip, int(jport)))
        tx = rcfg.encode_reconfig_tx(1, members, {jid: enroll_pub})
        hosts[ids[0]].submit(tx)
        for h in hosts.values():
            h.propose()

        # the ceremony + boundary drive themselves; wait for every
        # host (joiner included) to activate v1
        deadline = time.monotonic() + 90
        everyone = list(hosts.values()) + [joiner]
        while time.monotonic() < deadline:
            if all(
                h.node.roster_version == 1 for h in everyone
            ):
                break
            time.sleep(0.25)
        assert all(h.node.roster_version == 1 for h in everyone), {
            h.node_id: h.node.roster_version for h in everyone
        }

        # -- post-activation traffic: the joiner participates ---------
        for i, tx2 in enumerate([b"post-%02d" % i for i in range(8)]):
            joiner.submit(tx2) if i % 2 else hosts[ids[0]].submit(tx2)
        for h in everyone:
            h.propose()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            depths = [len(h.committed_batches()) for h in everyone]
            if min(depths) >= cfg.reconfig_lead and all(
                h.pending_tx_count() == 0 for h in everyone
            ):
                break
            time.sleep(0.25)

        # -- crash the WAL-bearing member and restart under v1 --------
        hosts[victim].stop()
        restarted = ValidatorHost(
            cfg,
            victim,
            ids,
            keys[victim],
            listen_addr=addrs[victim],
            batch_log_path=wal,
        )
        assert restarted.node.roster_version == 1
        assert jid in restarted.node.members
        restarted.listen()
        raddrs = dict(addrs)
        raddrs[jid] = jaddr
        restarted.connect(raddrs)
        want = hosts[ids[0]].committed_batches()
        deadline = time.monotonic() + 60
        got = []
        while time.monotonic() < deadline:
            got = restarted.committed_batches()
            if len(got) >= len(want):
                break
            time.sleep(0.25)
        assert len(got) >= len(want), (len(got), len(want))
        # byte-identical ledgers across old, new and restarted nodes
        ref = [
            encode_batch_body(e, b) for e, b in enumerate(want)
        ]
        for h in [hosts[ids[0]], hosts[ids[1]], joiner, restarted]:
            batches = h.committed_batches()
            for e, body in enumerate(ref):
                assert encode_batch_body(e, batches[e]) == body
    finally:
        for h in hosts.values():
            h.stop()
        if joiner is not None:
            joiner.stop()
        if restarted is not None:
            restarted.stop()
