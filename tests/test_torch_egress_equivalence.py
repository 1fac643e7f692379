# The reference's tests/test_egress_equivalence.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Scalar vs columnar EGRESS equivalence.

The egress columnarization moved outbound work to wave granularity:
one coalescer flush hands its whole wave of folded bundles to ONE
``Authenticator.sign_wire_wave`` pass (payload bodies encode once per
distinct object through the shared-prefix ``FrameEncodeMemo``, MACs
batch over the precomputed key schedules), single-receiver sends
ride the same signer, and the protocol plane's pending coin-share
issues pool in the CryptoHub's coin column — one native
multi-exponentiation dispatch per staged pool per wave instead of one
``issue_shares_batch`` per node per drain.  That reshapes WHEN frames
encode, sign, and coin shares issue — but it must never reshape WHAT
crosses the wire or what the roster commits.
``Config.egress_columnar=False`` keeps the per-post scalar egress
path as a live comparison arm; these tests run the same seeded
schedule under both arms and require byte-identical committed ledgers
AND byte-identical wire-frame streams (under deterministically pinned
entropy/time) on the channel transport, byte-identical signer output
and committed batches on real gRPC, that the deterministic sign/coin
counters actually DROP, that the semantic coalitions still lie
per-receiver through the columnar egress arm, and that the whole
egress path is PYTHONHASHSEED-independent.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys
import threading

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from cleisthenes_tpu_torch.config import Config  # noqa: E402
from cleisthenes_tpu_torch.core.ledger import encode_batch_body  # noqa: E402
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster  # noqa: E402


def _channel_run(egress: bool) -> tuple:
    """(ledger digest, depth, delivery counters, hub counters) for one
    seeded 4-node channel-transport run under the given egress arm."""
    cluster = SimulatedCluster(
        config=Config(
            n=4, batch_size=8, seed=3031, egress_columnar=egress, crypto_backend="cpu"
        ),
        seed=3031,
        key_seed=17,
    )
    for i in range(24):
        cluster.submit(b"egr-tx-%04d" % i)
    cluster.run_epochs()
    depth = cluster.assert_agreement()
    h = hashlib.sha256()
    for nid in cluster.ids:
        for epoch, batch in enumerate(
            cluster.nodes[nid].committed_batches
        ):
            h.update(encode_batch_body(epoch, batch))
    hub = cluster.nodes[cluster.ids[0]].hub.stats()
    return h.hexdigest(), depth, cluster.net.delivery_stats(), hub


def test_scalar_vs_columnar_identical_ledgers_channel():
    col = _channel_run(egress=True)
    sca = _channel_run(egress=False)
    assert col[1] >= 2 and sca[1] >= 2  # both actually committed
    assert col[0] == sca[0], (
        "columnar egress committed different ledger bytes than the "
        f"scalar arm:\n  columnar: {col}\n  scalar:   {sca}"
    )
    # the refactor's entire point: the columnar arm makes FEWER
    # Authenticator sign passes (one wave call per flush instead of
    # one per post) and FEWER native coin-issue dispatches (one
    # pooled share_batch per wave instead of one per node per drain)
    # for the identical schedule — never more
    assert col[2]["mac_signs"] < sca[2]["mac_signs"], (col[2], sca[2])
    assert 2 * col[3]["coin_issue_batches"] <= sca[3]["coin_issue_batches"], (
        col[3], sca[3],
    )
    # both arms issue the identical shares through the same unit
    assert col[3]["coin_issue_items"] == sca[3]["coin_issue_items"]
    # payload bodies actually encoded never increase (the memo only
    # ever dedups; with no cross-receiver sharing the arms tie)
    assert col[2]["frames_encoded"] <= sca[2]["frames_encoded"]
    # scalar arm reports zeroed memo keys (schema stability)
    assert sca[2]["encode_memo_hits"] == 0
    assert sca[2]["encode_memo_misses"] == 0


def test_transport_metrics_surface_egress_counters():
    """Metrics.snapshot() carries the egress-plane counters on the
    channel transport (endpoint_stats provider) and the coin-issue
    tallies in the hub block."""
    cluster = SimulatedCluster(
        config=Config(n=4, batch_size=8, seed=6, egress_columnar=True, crypto_backend="cpu"),
        seed=6,
        key_seed=3,
    )
    for i in range(8):
        cluster.submit(b"megr-%04d" % i)
    cluster.run_epochs()
    snap = cluster.nodes[cluster.ids[0]].metrics.snapshot()
    transport = snap["transport"]
    for key in (
        "frames_encoded",
        "encode_memo_hits",
        "encode_memo_misses",
        "mac_sign_batches",
    ):
        assert key in transport, transport
    assert transport["mac_sign_batches"] > 0
    assert transport["frames_encoded"] > 0
    assert snap["hub"]["coin_share_batches"] > 0
    assert snap["hub"]["coin_share_items"] > 0


# ---------------------------------------------------------------------------
# codec/signer-level parity: sign_wire_wave vs sign_wire_many
# ---------------------------------------------------------------------------


def test_sign_wire_wave_parity_and_memo_sharing():
    """The wave signer must produce byte-identical frames to looping
    sign_wire_many (the gRPC egress path's signer — this IS the
    wire-frame equivalence proof at the seam real sockets use), share
    payload-body encodes across a wave's bundles via the memo, and
    evict FIFO."""
    from cleisthenes_tpu_torch.transport.base import (
        HmacAuthenticator,
        NullAuthenticator,
    )
    from cleisthenes_tpu_torch.transport.message import (
        BbaPayload,
        BbaType,
        BundlePayload,
        FrameEncodeMemo,
        Message,
        RbcPayload,
        RbcType,
    )

    roster = ["node0", "node1", "node2", "node3"]
    auth = HmacAuthenticator.derive(b"egress-master", "node0", roster)
    shared = BbaPayload(BbaType.BVAL, "node0", 3, 1, True)
    vals = [
        RbcPayload(
            RbcType.VAL, "node0", 3, b"r" * 32, (b"b" * 32,),
            shard_index=i, shard=b"s%d" % i,
        )
        for i in range(3)
    ]
    # a mixed egress wave: per-receiver bundles sharing one broadcast
    # run object (`shared`) plus a distinct VAL each — the coalescer's
    # exact output shape
    msgs = [
        Message(
            sender_id="node0",
            timestamp=99.25,
            payload=BundlePayload((shared, vals[i])),
        )
        for i in range(3)
    ]
    items = [(m, [f"node{i + 1}"]) for i, m in enumerate(msgs)]
    memo = FrameEncodeMemo()
    waved = auth.sign_wire_wave(items, memo)
    for (m, rids), frames in zip(items, waved):
        want = auth.sign_wire_many(m, rids)
        assert frames == want, "wave signer drifted from scalar signer"
    # `shared` encoded once, hit twice; each VAL encoded once
    assert memo.hits == 2 and memo.misses == 4, (memo.hits, memo.misses)
    # Null backend parity (benchmarks isolating crypto cost)
    null = NullAuthenticator()
    nw = null.sign_wire_wave(items, FrameEncodeMemo())
    for (m, rids), frames in zip(items, nw):
        assert frames == null.sign_wire_many(m, rids)
    # FIFO eviction: at cap the OLDEST entry goes, never the table
    small = FrameEncodeMemo(cap=2)
    from cleisthenes_tpu_torch.transport.message import encode_payload_shared

    for p in (shared, vals[0], vals[1]):
        encode_payload_shared(p, small)
    assert len(small.map) == 2
    encode_payload_shared(vals[1], small)  # newest still resident
    assert small.hits == 1


# ---------------------------------------------------------------------------
# ops-level parity: the wave-batched coin kernels vs their scalar maps
# ---------------------------------------------------------------------------


def test_coin_share_batch_matches_scalar_kernels():
    """`CommonCoin.share_batch` / `verify_shares_batch` are the
    coin-only batch entry points for callers without a hub (lockstep
    executor, tests) — the batch results must match mapping the
    scalar `share` / `verify_shares` kernels item for item, and a
    tampered share must fail exactly where the scalar check fails."""
    from cleisthenes_tpu_torch.ops import tpke
    from cleisthenes_tpu_torch.ops.coin import CommonCoin

    pub, secrets = tpke.deal(4, 2, seed=23)
    coin = CommonCoin(pub, backend="cpu")
    coin_ids = [b"egr-coin-%d" % r for r in range(3)]
    sec = secrets[1]
    batch = coin.share_batch(sec, coin_ids)
    assert len(batch) == 3
    per_coin = []
    for cid, sh in zip(coin_ids, batch):
        # a batch-issued share verifies under the scalar verifier...
        assert coin.verify_shares(cid, [sh]) == [True]
        # ...and combines to the same deterministic VUF value as a
        # quorum of scalar-issued shares
        others = [coin.share(secrets[0], cid), coin.share(secrets[2], cid)]
        assert coin.toss(cid, others) == coin.toss(cid, [sh, others[0]])
        per_coin.append((cid, [sh] + others))
    # batched verify across every coin == mapping verify_shares
    verdicts = coin.verify_shares_batch(per_coin)
    assert verdicts == [
        coin.verify_shares(cid, shs) for cid, shs in per_coin
    ]
    assert all(all(v) for v in verdicts)
    # a forged share fails in the batch exactly like in the scalar map
    from cleisthenes_tpu_torch.ops.tpke import DhShare

    good = per_coin[1][1][0]
    forged = DhShare(good.index, good.d + 1, good.e, good.z)
    tampered = [
        (per_coin[0][0], per_coin[0][1]),
        (per_coin[1][0], [forged] + per_coin[1][1][1:]),
    ]
    got = coin.verify_shares_batch(tampered)
    assert got[0] == [True, True, True]
    assert got[1][0] is False and got[1][1:] == [True, True]
    assert coin.share_batch(sec, []) == []
    assert coin.verify_shares_batch([]) == []


# ---------------------------------------------------------------------------
# wire-frame byte equivalence across arms (channel transport)
# ---------------------------------------------------------------------------

# Runs BOTH egress arms inside one subprocess with entropy and wall
# clock pinned (constant CP-nonce bytes keep every Chaum-Pedersen
# proof valid while making it batch-position-independent; a fixed
# time.time pins the envelope timestamp field), captures every frame
# at enqueue time via ChannelNetwork.frame_tap, and requires the two
# frame STREAMS — sender, receiver, and wire bytes, in order — to be
# byte-identical.  Prints one digest line carrying the deterministic
# egress counters; two PYTHONHASHSEED values must produce identical
# lines (hash-order iteration in the wave-signer / coin-pool path
# would show up as different counters, frame order, or ledger bytes).
_EGRESS_DRIVER = r"""
import hashlib
import secrets
import time

secrets.token_bytes = lambda n: b"\x07" * n  # constant CP nonces
time.time = lambda: 1_700_000_000.0  # pinned envelope timestamps

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.ledger import encode_batch_body
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster


def run(egress):
    cluster = SimulatedCluster(
        config=Config(
            n=4, batch_size=8, seed=4042, egress_columnar=egress, crypto_backend="cpu"
        ),
        seed=4042,
        key_seed=19,
    )
    frames = []
    cluster.net.frame_tap = lambda s, r, w: frames.append((s, r, w))
    for i in range(24):
        cluster.submit(b"egr-hs-%04d" % i)
    cluster.run_epochs()
    depth = cluster.assert_agreement()
    assert depth >= 2, f"want >=2 committed epochs, got {depth}"
    h = hashlib.sha256()
    for nid in cluster.ids:
        for epoch, batch in enumerate(
            cluster.nodes[nid].committed_batches
        ):
            h.update(encode_batch_body(epoch, batch))
    return frames, h.hexdigest(), cluster.net.delivery_stats(), (
        cluster.nodes[cluster.ids[0]].hub.stats()
    )


col_frames, col_digest, col_d, col_hub = run(True)
sca_frames, sca_digest, sca_d, sca_hub = run(False)
assert col_digest == sca_digest, "ledger bytes diverged across arms"
assert len(col_frames) == len(sca_frames), (
    len(col_frames), len(sca_frames),
)
for i, (a, b) in enumerate(zip(col_frames, sca_frames)):
    assert a == b, (
        f"frame {i} diverged across egress arms: "
        f"{a[0]}->{a[1]} vs {b[0]}->{b[1]}"
    )
fh = hashlib.sha256()
for s, r, w in col_frames:
    fh.update(s.encode() + b"|" + r.encode() + b"|" + w)
print(
    "EGRESS_DIGEST=%s frames=%d stream=%s signs=%d encoded=%d "
    "coin_batches=%d coin_items=%d"
    % (
        col_digest,
        len(col_frames),
        fh.hexdigest(),
        col_d["mac_signs"],
        col_d["frames_encoded"],
        col_hub["coin_issue_batches"],
        col_hub["coin_issue_items"],
    )
)
"""


def _run_egress_driver(hashseed: str) -> str:
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = hashseed
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _EGRESS_DRIVER],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, (
        f"PYTHONHASHSEED={hashseed} egress run failed:\n"
        f"{proc.stdout}\n{proc.stderr}"
    )
    for line in proc.stdout.splitlines():
        if line.startswith("EGRESS_DIGEST="):
            return line
    raise AssertionError(f"no egress digest line:\n{proc.stdout}")


def test_wire_frames_identical_across_arms_and_hash_seeds():
    a = _run_egress_driver("1")
    b = _run_egress_driver("2")
    assert a == b, (
        "columnar egress diverged across PYTHONHASHSEED values:\n"
        f"  {a}\n  {b}\n-> hash-order iteration is leaking into the "
        "wave-signer / coin-pool path (see staticcheck DET002)"
    )


# ---------------------------------------------------------------------------
# real gRPC: columnar vs scalar egress over sockets
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# semantic coalitions against the columnar egress arm
# ---------------------------------------------------------------------------


def _drive_coalition(behaviors: dict, n: int, seed: int):
    """Run a Byzantine coalition on the columnar egress arm; returns
    (agreed honest depth, the network) — assert_agreement = identical
    ledger prefixes."""
    bad = sorted(behaviors)
    cluster = SimulatedCluster(
        n=n,
        config=Config(n=n, batch_size=8, egress_columnar=True, crypto_backend="cpu"),
        seed=seed,
        key_seed=27,
        behaviors=behaviors,
    )
    honest = [i for i in cluster.ids if i not in bad]
    for i in range(12):
        cluster.submit(b"tx-%04d" % i, node_id=honest[i % len(honest)])
    cluster.run_until_drained(max_rounds=30, skip=bad)
    depth = cluster.assert_agreement(skip=bad)
    for nid in honest:
        for batch in cluster.nodes[nid].committed_batches:
            for tx in batch.tx_list():
                assert tx.startswith(b"tx-"), tx
    return depth, cluster.net


@pytest.mark.faults
def test_equivocator_coalition_columnar_egress():
    """An Equivocator's per-receiver lies enter BETWEEN the protocol
    plane and the coalescer, so the columnar flush must sign each
    receiver's distinct bundle separately (per-receiver signable)
    while the honest run's shared bodies still fold through the
    memo — conflating the two would either leak one receiver's lie to
    another or fail the MACs wholesale."""
    from cleisthenes_tpu_torch.protocol.byzantine import make_behavior

    assert Config(crypto_backend="cpu").egress_columnar is True  # the arm under test
    behaviors = {"node003": make_behavior("equivocator", seed=51)}
    depth, net = _drive_coalition(behaviors, n=4, seed=37)
    assert depth >= 1
    assert behaviors["node003"].rewrites > 0, "adversary never lied"
    # the liar's per-receiver fan-out makes mixed egress waves whose
    # unrewritten payload objects are shared across receivers — the
    # encode memo must actually dedup them
    stats = net.delivery_stats()
    assert stats["encode_memo_hits"] > 0, stats


@pytest.mark.faults
def test_selective_mute_coalition_columnar_egress():
    """SelectiveMute silences chosen links: the muted receivers'
    entries simply vanish from the egress wave, and the remaining
    per-receiver frames must still sign and deliver (honest quorums
    reach agreement without the starved links)."""
    from cleisthenes_tpu_torch.protocol.byzantine import make_behavior

    behaviors = {"node003": make_behavior("selective_mute", seed=52)}
    depth, _net = _drive_coalition(behaviors, n=4, seed=41)
    assert depth >= 1


def _grpc_epoch0_bodies(egress: bool) -> tuple:
    """(per-node epoch-0 bodies, one host's metrics snapshot) from a
    4-node run over real localhost gRPC under the given egress arm."""
    from cleisthenes_tpu_torch.protocol.honeybadger import setup_keys
    from cleisthenes_tpu_torch.transport.host import ValidatorHost

    n = 4
    cfg = Config(crypto_backend="cpu", n=n, batch_size=8, seed=81, egress_columnar=egress)
    ids = [f"node{i}" for i in range(n)]
    keys = setup_keys(cfg, ids, seed=58)
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
            hosts[ids[i % n]].submit(b"grpc-egr-%02d" % i)
        for h in hosts.values():
            h.propose()
        first = {i: h.wait_commit(timeout=60) for i, h in hosts.items()}
        assert {e for e, _ in first.values()} == {0}
        snap = hosts[ids[0]].node.metrics.snapshot()
        return [encode_batch_body(0, b) for _, b in first.values()], snap
    finally:
        for h in hosts.values():
            h.stop()


def test_scalar_vs_columnar_identical_ledgers_grpc():
    """Same roster, same submissions, real sockets: the columnar and
    scalar egress arms must commit byte-identical epoch-0 batches,
    and the columnar arm's wave signer must actually engage (sign
    batches > 0; frame-level byte equality for this path is proven at
    the signer seam by test_sign_wire_wave_parity_and_memo_sharing,
    since thread timing makes whole-run frame streams incomparable
    over real sockets)."""
    col, col_snap = _grpc_epoch0_bodies(egress=True)
    sca, _sca_snap = _grpc_epoch0_bodies(egress=False)
    # within-run agreement is byte-exact on both arms...
    assert all(b == col[0] for b in col)
    assert all(b == sca[0] for b in sca)
    # ...and across the egress-arm boundary too
    assert col[0] == sca[0], (
        "columnar vs scalar gRPC runs committed different epoch-0 bytes"
    )
    transport = col_snap["transport"]
    assert transport["mac_sign_batches"] > 0
    assert transport["frames_encoded"] > 0
    assert col_snap["hub"]["coin_share_batches"] > 0
