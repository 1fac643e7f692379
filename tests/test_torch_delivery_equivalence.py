# The reference's tests/test_delivery_equivalence.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Scalar vs columnar DELIVERY equivalence.

The delivery-plane columnarization moved inbound work to wave
granularity: frame decode memoizes on the signing-prefix digest
(transport.message.FrameDecodeMemo), MAC verification batches through
one ``Authenticator.verify_wire_many`` call per wave, and RBC receipt
state lives in the roster-wide EchoBank.  That reshapes WHEN frames
decode and verify — but it must never reshape WHAT the roster
commits.  ``Config.delivery_columnar=False`` keeps the per-frame
scalar receive path as a live comparison arm; these tests run the
same seeded schedule under both arms and require byte-identical
committed ledgers on both transports, that the columnar arm's
deterministic frame/MAC counters actually DROP, that the
semantic coalitions (equivocating per-receiver roots included) run
green against the EchoBank, and that the whole columnar receive path
is PYTHONHASHSEED-independent.
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


def _channel_run(columnar: bool) -> tuple:
    """(ledger digest, depth, delivery counters) for one seeded
    4-node channel-transport run under the given delivery arm."""
    cluster = SimulatedCluster(
        config=Config(
            n=4, batch_size=8, seed=2027, delivery_columnar=columnar, crypto_backend="cpu"
        ),
        seed=2027,
        key_seed=15,
    )
    for i in range(24):
        cluster.submit(b"dlv-tx-%04d" % i)
    cluster.run_epochs()
    depth = cluster.assert_agreement()
    h = hashlib.sha256()
    for nid in cluster.ids:
        for epoch, batch in enumerate(
            cluster.nodes[nid].committed_batches
        ):
            h.update(encode_batch_body(epoch, batch))
    return h.hexdigest(), depth, cluster.net.delivery_stats()


def test_scalar_vs_columnar_identical_ledgers_channel():
    col = _channel_run(columnar=True)
    sca = _channel_run(columnar=False)
    assert col[1] >= 2 and sca[1] >= 2  # both actually committed
    assert col[0] == sca[0], (
        "columnar delivery committed different ledger bytes than the "
        f"scalar arm:\n  columnar: {col}\n  scalar:   {sca}"
    )
    # the refactor's entire point: the columnar arm decodes FEWER
    # frames (shared-prefix memo) and makes FEWER verify calls (wave
    # batches) for the identical schedule — never more
    assert col[2]["frames_decoded"] < sca[2]["frames_decoded"], (
        col[2], sca[2],
    )
    assert col[2]["mac_verifies"] < sca[2]["mac_verifies"], (
        col[2], sca[2],
    )
    # and the memo genuinely hit (a broadcast's N receiver frames
    # share one decode)
    probes = col[2]["decode_memo_hits"] + col[2]["decode_memo_misses"]
    assert probes > 0 and col[2]["decode_memo_hits"] > 0
    # scalar arm reports zeroed memo keys (schema stability)
    assert sca[2]["decode_memo_hits"] == 0
    assert sca[2]["decode_memo_misses"] == 0


def test_transport_metrics_surface_delivery_counters():
    """Metrics.snapshot()["transport"] carries the delivery-plane
    counters on the channel transport (endpoint_stats provider)."""
    cluster = SimulatedCluster(
        config=Config(n=4, batch_size=8, seed=5, delivery_columnar=True, crypto_backend="cpu"),
        seed=5,
        key_seed=2,
    )
    for i in range(8):
        cluster.submit(b"mtx-%04d" % i)
    cluster.run_epochs()
    snap = cluster.nodes[cluster.ids[0]].metrics.snapshot()["transport"]
    for key in (
        "frames_decoded",
        "decode_memo_hits",
        "decode_memo_misses",
        "mac_verify_batches",
    ):
        assert key in snap, snap
    assert snap["mac_verify_batches"] > 0
    assert snap["delivered"] > 0


# Prints one line digesting the ledger bytes AND the columnar delivery
# structure itself: deterministic frame-decode/MAC-verify counters and
# memo tallies.  Two PYTHONHASHSEED values must produce identical
# lines — hash-order iteration anywhere in the wave-prepare / bank
# path would show up as different counters or ledger bytes.
_DELIVERY_DRIVER = r"""
import hashlib
from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.ledger import encode_batch_body
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster

cluster = SimulatedCluster(
    config=Config(n=4, batch_size=8, seed=909, delivery_columnar=True, crypto_backend="cpu"),
    seed=909,
    key_seed=4,
)
for i in range(24):
    cluster.submit(b"dlv-hs-%04d" % i)
cluster.run_epochs()
depth = cluster.assert_agreement()
assert depth >= 2, f"want >=2 committed epochs, got {depth}"
h = hashlib.sha256()
for nid in cluster.ids:
    for epoch, batch in enumerate(cluster.nodes[nid].committed_batches):
        h.update(encode_batch_body(epoch, batch))
d = cluster.net.delivery_stats()
assert Config(crypto_backend="cpu").wave_routing is True  # the router is the default arm
dispatches = sum(
    cluster.nodes[nid].metrics.handler_dispatches.value
    for nid in cluster.ids
)
waves = sum(
    cluster.nodes[nid].metrics.waves_routed.value for nid in cluster.ids
)
print(
    "DELIVERY_DIGEST=%s decoded=%d verifies=%d hits=%d misses=%d "
    "dispatches=%d waves=%d"
    % (
        h.hexdigest(),
        d["frames_decoded"],
        d["mac_verifies"],
        d["decode_memo_hits"],
        d["decode_memo_misses"],
        dispatches,
        waves,
    )
)
"""


def _run_delivery_driver(hashseed: str) -> str:
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = hashseed
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _DELIVERY_DRIVER],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, (
        f"PYTHONHASHSEED={hashseed} delivery run failed:\n"
        f"{proc.stdout}\n{proc.stderr}"
    )
    for line in proc.stdout.splitlines():
        if line.startswith("DELIVERY_DIGEST="):
            return line
    raise AssertionError(f"no delivery digest line:\n{proc.stdout}")


def test_delivery_ordering_identical_across_hash_seeds():
    a = _run_delivery_driver("1")
    b = _run_delivery_driver("2")
    assert a == b, (
        "columnar delivery diverged across PYTHONHASHSEED values:\n"
        f"  {a}\n  {b}\n-> hash-order iteration is leaking into the "
        "wave-prepare / EchoBank path (see staticcheck DET002)"
    )


# ---------------------------------------------------------------------------
# wave routing: scalar vs wave-routed ingest
# ---------------------------------------------------------------------------


def _routing_run(wave_routing: bool) -> tuple:
    """(ledger digest, depth, cluster-wide handler dispatches, waves
    routed) for one seeded 4-node channel run under the given ROUTING
    arm (delivery_columnar stays on for both — the router rides it)."""
    cluster = SimulatedCluster(
        config=Config(
            n=4,
            batch_size=8,
            seed=4041,
            delivery_columnar=True,
            wave_routing=wave_routing, crypto_backend="cpu",
        ),
        seed=4041,
        key_seed=23,
    )
    for i in range(24):
        cluster.submit(b"rtr-tx-%04d" % i)
    cluster.run_epochs()
    depth = cluster.assert_agreement()
    h = hashlib.sha256()
    for nid in cluster.ids:
        for epoch, batch in enumerate(
            cluster.nodes[nid].committed_batches
        ):
            h.update(encode_batch_body(epoch, batch))
    dispatches = sum(
        cluster.nodes[nid].metrics.handler_dispatches.value
        for nid in cluster.ids
    )
    waves = sum(
        cluster.nodes[nid].metrics.waves_routed.value
        for nid in cluster.ids
    )
    return h.hexdigest(), depth, dispatches, waves


def test_scalar_vs_wave_routing_identical_ledgers_channel():
    wav = _routing_run(wave_routing=True)
    sca = _routing_run(wave_routing=False)
    assert wav[1] >= 2 and sca[1] >= 2  # both actually committed
    assert wav[0] == sca[0], (
        "wave-routed ingest committed different ledger bytes than the "
        f"scalar routing arm:\n  wave:   {wav}\n  scalar: {sca}"
    )
    # the refactor's entire point: one batch handler invocation per
    # (kind, wave) instead of one Python call chain per payload —
    # the deterministic counter must drop by a real factor, and the
    # router must actually have demuxed waves
    assert sca[2] >= 3 * wav[2], (wav, sca)
    assert wav[3] > 0
    assert sca[3] == 0  # scalar arm never routes a wave


def test_router_metrics_schema_zeroed_on_scalar_arm():
    """snapshot()["router"] keys are present on BOTH arms (the
    schema rule) and zeroed on the scalar one."""
    for wave in (True, False):
        cluster = SimulatedCluster(
            config=Config(
                n=4, batch_size=8, seed=7, wave_routing=wave, crypto_backend="cpu"
            ),
            seed=7,
            key_seed=2,
        )
        for i in range(8):
            cluster.submit(b"rs-%04d" % i)
        cluster.run_epochs()
        snap = cluster.nodes[cluster.ids[0]].metrics.snapshot()["router"]
        assert set(snap) == {"handler_dispatches", "waves_routed"}
        assert snap["handler_dispatches"] > 0  # both arms dispatch
        assert (snap["waves_routed"] > 0) == wave


# ---------------------------------------------------------------------------
# codec-level parity: decode_frame_shared vs decode_frame
# ---------------------------------------------------------------------------


def test_decode_frame_shared_parity_and_rejections():
    """The shared-prefix decoder must accept exactly what the scalar
    decoder accepts (same Message, byte-equal signing prefix), share
    the payload object across a broadcast's frames via the memo, and
    reject the same malformed inputs."""
    from cleisthenes_tpu_torch.transport.message import (
        BbaPayload,
        BbaType,
        FrameDecodeMemo,
        Message,
        decode_frame,
        decode_frame_shared,
        encode_message,
    )

    payload = BbaPayload(BbaType.BVAL, "node0", 3, 1, True)
    msg = Message(
        sender_id="node0", timestamp=12.5, payload=payload,
        signature=b"m" * 32,
    )
    wire = encode_message(msg)
    memo = FrameDecodeMemo()
    got, prefix = decode_frame_shared(wire, memo)
    want, want_prefix = decode_frame(wire)
    assert got == want
    assert bytes(prefix) == want_prefix
    assert (memo.hits, memo.misses) == (0, 1)
    # a sibling frame of the same broadcast (same prefix, different
    # MAC) hits the memo and shares the SAME payload object — the id
    # identity the hub's dedup and the column memos downstream rely on
    sibling = encode_message(
        Message(
            sender_id="node0", timestamp=12.5, payload=payload,
            signature=b"x" * 32,
        )
    )
    got2, _ = decode_frame_shared(sibling, memo)
    assert (memo.hits, memo.misses) == (1, 1)
    assert got2.payload is got.payload
    assert got2.signature == b"x" * 32
    # rejection parity: truncations, trailing junk, bad magic
    for mutant in (
        wire[:10],
        wire[:-1],
        wire + b"\x00",
        b"XXXX" + wire[4:],
    ):
        with pytest.raises(ValueError):
            decode_frame(mutant)
        with pytest.raises(ValueError):
            decode_frame_shared(mutant, FrameDecodeMemo())
    # FIFO eviction: at cap the OLDEST entry goes, never the table
    small = FrameDecodeMemo(cap=2)
    frames = []
    for i in range(3):
        p = BbaPayload(BbaType.BVAL, "node0", i, 0, False)
        frames.append(
            encode_message(
                Message(
                    sender_id="node0", timestamp=1.0, payload=p,
                    signature=b"s" * 32,
                )
            )
        )
        decode_frame_shared(frames[-1], small)
    assert len(small.map) == 2
    decode_frame_shared(frames[2], small)  # newest still resident
    assert small.hits == 1


# ---------------------------------------------------------------------------
# semantic coalitions against the EchoBank arm
# ---------------------------------------------------------------------------


def _drive_coalition(behaviors: dict, n: int, seed: int) -> int:
    """Run a Byzantine coalition on the columnar arm; returns the
    agreed honest depth (assert_agreement = identical ledger
    prefixes)."""
    bad = sorted(behaviors)
    cluster = SimulatedCluster(
        n=n,
        config=Config(n=n, batch_size=8, delivery_columnar=True, crypto_backend="cpu"),
        seed=seed,
        key_seed=21,
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
    return depth


# ---------------------------------------------------------------------------
# fuzz bands on the columnar arm
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# semantic coalitions against the wave router
# ---------------------------------------------------------------------------


@pytest.mark.faults
def test_equivocator_coalition_columnar_bank():
    """An Equivocator sends CONFLICTING per-receiver RBC roots: the
    EchoBank's per-(root, instance) counting must keep the quorums
    separate — conflating them would fork or stall the honest
    majority."""
    from cleisthenes_tpu_torch.protocol.byzantine import make_behavior

    behaviors = {"node003": make_behavior("equivocator", seed=31)}
    depth = _drive_coalition(behaviors, n=4, seed=13)
    assert depth >= 1
    assert behaviors["node003"].rewrites > 0, "adversary never lied"


@pytest.mark.faults
def test_bad_dealer_coalition_columnar_bank():
    """BadDealer's structurally-valid wrong shards must burn their
    one-vote bank slots without wedging honest quorums."""
    from cleisthenes_tpu_torch.protocol.byzantine import make_behavior

    behaviors = {"node003": make_behavior("bad_dealer", seed=32)}
    depth = _drive_coalition(behaviors, n=4, seed=17)
    assert depth >= 1
    assert behaviors["node003"].rewrites > 0


@pytest.mark.faults
def test_epoch_sprayer_coalition_columnar_bank():
    """EpochSprayer's far-future spam exercises the demux window in
    front of the bank (no bank rows may be minted for epochs outside
    the window)."""
    from cleisthenes_tpu_torch.protocol.byzantine import (
        CompositeBehavior,
        make_behavior,
    )

    behaviors = {
        "node003": CompositeBehavior(
            [
                make_behavior("epoch_sprayer", seed=33),
                make_behavior("split_voter", seed=34),
            ]
        )
    }
    depth = _drive_coalition(behaviors, n=4, seed=19)
    assert depth >= 1


@pytest.mark.faults
def test_equivocator_coalition_wave_router():
    """Equivocating per-receiver roots through the ROUTER's echo/ready
    columns: the per-(root, instance) EchoBank counting must keep the
    quorums separate when whole waves land in one dispatch."""
    from cleisthenes_tpu_torch.protocol.byzantine import make_behavior

    assert Config(crypto_backend="cpu").wave_routing is True  # the arm under test
    behaviors = {"node003": make_behavior("equivocator", seed=41)}
    depth = _drive_coalition(behaviors, n=4, seed=23)
    assert depth >= 1
    assert behaviors["node003"].rewrites > 0, "adversary never lied"


@pytest.mark.faults
def test_epoch_sprayer_coalition_wave_router():
    """EpochSprayer's far-future spam exercises the router's
    column-granular demux window (no state minted outside it) and the
    per-payload CATCHUP renudge cadence."""
    from cleisthenes_tpu_torch.protocol.byzantine import (
        CompositeBehavior,
        make_behavior,
    )

    behaviors = {
        "node003": CompositeBehavior(
            [
                make_behavior("epoch_sprayer", seed=42),
                make_behavior("split_voter", seed=43),
            ]
        )
    }
    depth = _drive_coalition(behaviors, n=4, seed=29)
    assert depth >= 1


@pytest.mark.faults
def test_selective_mute_coalition_wave_router():
    """SelectiveMute starves chosen links: waves arrive asymmetric
    per receiver, so the router's per-receiver bundles must still
    drive the honest quorums to agreement."""
    from cleisthenes_tpu_torch.protocol.byzantine import make_behavior

    behaviors = {"node003": make_behavior("selective_mute", seed=44)}
    depth = _drive_coalition(behaviors, n=4, seed=31)
    assert depth >= 1


@pytest.mark.faults
def test_fuzz_band_columnar_delivery():
    """20 sampled composite schedules (semantic behaviors x wire
    faults x crash/partition timelines) with delivery_columnar=True —
    a seed band disjoint from ci.sh's 0:20 smoke band, so the
    delivery plane adds coverage instead of re-running it."""
    from cleisthenes_tpu_torch.tools.fuzz import run_schedule, sample_schedule

    assert Config().delivery_columnar is True  # the fuzzer's arm
    for seed in range(300, 320):
        v = run_schedule(sample_schedule(seed), crypto="cpu")
        assert v is None, f"seed {seed}: {v}"


@pytest.mark.slow
@pytest.mark.faults
def test_fuzz_deep_sweep_columnar_delivery():
    """The 200-seed slow band on the columnar delivery arm."""
    from cleisthenes_tpu_torch.tools.fuzz import run_schedule, sample_schedule

    assert Config().delivery_columnar is True
    for seed in range(320, 520):
        v = run_schedule(sample_schedule(seed), crypto="cpu")
        assert v is None, f"seed {seed}: {v}"


@pytest.mark.faults
def test_fuzz_band_wave_routing():
    """20 sampled composite schedules against the WAVE ROUTER (the
    fuzzer's default arm since wave_routing defaults True) — a seed
    band disjoint from the ci.sh smoke band and the columnar-delivery
    band, so the router seam adds coverage instead of re-running it.
    Wire-fault schedules mount a fault_filter, which on the channel
    transport keeps per-frame decode/verify but still routes the
    verified wave — the seam is exercised under tampering too."""
    from cleisthenes_tpu_torch.tools.fuzz import run_schedule, sample_schedule

    assert Config().wave_routing is True  # the fuzzer's arm
    for seed in range(520, 540):
        v = run_schedule(sample_schedule(seed), crypto="cpu")
        assert v is None, f"seed {seed}: {v}"


@pytest.mark.slow
@pytest.mark.faults
def test_fuzz_deep_sweep_wave_routing():
    """The 200-seed slow band on the wave-routing arm."""
    from cleisthenes_tpu_torch.tools.fuzz import run_schedule, sample_schedule

    assert Config().wave_routing is True
    for seed in range(540, 740):
        v = run_schedule(sample_schedule(seed), crypto="cpu")
        assert v is None, f"seed {seed}: {v}"


@pytest.mark.faults
def test_fuzz_band_scalar_routing_pinned():
    """Wave routing drains a whole wave before any handler runs, so
    the scalar arm's finer per-message interleavings (a new message
    overtaking older pending ones mid-wave) are a schedule space the
    default arm can no longer reach — this band stays PINNED to
    wave_routing=False so the adversarial scheduler keeps exploring
    it (the schedule key round-trips through repro files)."""
    from cleisthenes_tpu_torch.tools.fuzz import run_schedule, sample_schedule

    for seed in range(740, 760):
        s = sample_schedule(seed)
        s["wave_routing"] = False
        v = run_schedule(s, crypto="cpu")
        assert v is None, f"seed {seed}: {v}"


def _grpc_epoch0_bodies(
    columnar: bool, wave_routing: bool = True
) -> tuple:
    """(per-node epoch-0 bodies, one host's metrics snapshot) from a
    4-node run over real localhost gRPC under the given arms."""
    from cleisthenes_tpu_torch.protocol.honeybadger import setup_keys
    from cleisthenes_tpu_torch.transport.host import ValidatorHost

    n = 4
    cfg = Config(crypto_backend="cpu",
        n=n,
        batch_size=8,
        seed=78,
        delivery_columnar=columnar,
        wave_routing=wave_routing,
    )
    ids = [f"node{i}" for i in range(n)]
    keys = setup_keys(cfg, ids, seed=56)
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
            hosts[ids[i % n]].submit(b"grpc-dlv-%02d" % i)
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
    scalar delivery arms must commit byte-identical epoch-0 batches,
    and the columnar arm's wave verify must actually engage (batch
    count > 0, batches <= frames)."""
    col, col_snap = _grpc_epoch0_bodies(columnar=True)
    sca, _sca_snap = _grpc_epoch0_bodies(columnar=False)
    # within-run agreement is byte-exact on both arms...
    assert all(b == col[0] for b in col)
    assert all(b == sca[0] for b in sca)
    # ...and across the delivery-arm boundary too
    assert col[0] == sca[0], (
        "columnar vs scalar gRPC runs committed different epoch-0 bytes"
    )
    transport = col_snap["transport"]
    assert transport["mac_verify_batches"] > 0
    assert transport["mac_verify_batches"] <= transport["frames_decoded"]


def test_scalar_vs_wave_routing_identical_ledgers_grpc():
    """Same roster, same submissions, real sockets + the dispatcher's
    wave mailbox: the wave-routed and scalar routing arms must commit
    byte-identical epoch-0 batches, and the wave arm must actually
    route waves."""
    wav, wav_snap = _grpc_epoch0_bodies(columnar=True, wave_routing=True)
    sca, _ = _grpc_epoch0_bodies(columnar=True, wave_routing=False)
    assert all(b == wav[0] for b in wav)
    assert all(b == sca[0] for b in sca)
    assert wav[0] == sca[0], (
        "wave vs scalar routing gRPC runs committed different "
        "epoch-0 bytes"
    )
    assert wav_snap["router"]["waves_routed"] > 0
    assert wav_snap["router"]["handler_dispatches"] > 0
