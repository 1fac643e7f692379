"""The live deployment surface of the port against the reference, at
zero tolerance: the protobuf adapter's bytes, the Prometheus
exposition, the sampler's rings, the dial layer's backoff schedules and
health rows, and one epoch over real localhost gRPC.

The reference package (JAX on the CPU) is the oracle; the same seeded
inputs go through both packages and every output must be equal, byte
for byte where it is bytes."""

from __future__ import annotations

import dataclasses
import threading
from unittest import mock

import grpc
import numpy as np
import pytest

from cleisthenes_tpu.config import Config as RefConfig
from cleisthenes_tpu.core import ledger as ref_ledger
from cleisthenes_tpu.protocol.honeybadger import setup_keys as ref_setup_keys
from cleisthenes_tpu.transport import health as ref_health
from cleisthenes_tpu.transport import host as ref_host
from cleisthenes_tpu.transport import message as ref_message
from cleisthenes_tpu.transport import obs_http as ref_obs
from cleisthenes_tpu.transport import pb_adapter as ref_pb
from cleisthenes_tpu.utils import metrics as ref_metrics
from cleisthenes_tpu.utils import timeseries as ref_timeseries
from cleisthenes_tpu.utils import watchdog as ref_watchdog
from cleisthenes_tpu_torch import interop
from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core import ledger
from cleisthenes_tpu_torch.transport import health
from cleisthenes_tpu_torch.transport import host
from cleisthenes_tpu_torch.transport import message
from cleisthenes_tpu_torch.transport import obs_http
from cleisthenes_tpu_torch.transport import pb_adapter as pb
from cleisthenes_tpu_torch.utils import metrics
from cleisthenes_tpu_torch.utils import timeseries
from cleisthenes_tpu_torch.utils import watchdog

# ---------------------------------------------------------------------------
# the protobuf adapter
# ---------------------------------------------------------------------------


def _payloads(rng: np.random.Generator):
    """One port payload of every wire kind, fields drawn from ``rng``."""
    m = message

    def b(n):
        return rng.bytes(int(n))

    def i(hi=1 << 20):
        return int(rng.integers(0, hi))

    def big():
        return int.from_bytes(rng.bytes(32), "big")

    props = tuple(f"node{j:03d}" for j in range(3))
    rbc = m.RbcPayload(
        type=m.RbcType(i(3)), proposer="node001", epoch=i(),
        root_hash=b(32), branch=tuple(b(32) for _ in range(i(5))),
        shard=b(i(300)), shard_index=i(64),
    )
    bba = m.BbaPayload(
        type=m.BbaType(i(2)), proposer="node002", epoch=i(), round=i(40),
        value=bool(i(2)),
    )
    coin = m.CoinPayload("node000", i(), i(9), i(64), big(), big(), big())
    dec = m.DecSharePayload("node003", i(), i(64), big(), big(), big())
    return [
        rbc,
        bba,
        coin,
        dec,
        m.CatchupReqPayload(from_epoch=i()),
        m.CatchupRespPayload(epoch=i(), body=b(i(200))),
        m.CatchupOrdPayload(epoch=i(), body=b(i(200))),
        m.ResharePayload(version=i(9), dealer="node001", body=b(i(200))),
        m.IngressSubmitPayload("client-7", i(), i(100), b(i(64))),
        m.IngressAckPayload("client-7", i(), i(4), i(), i(), i(5000)),
        m.IngressSubscribePayload(from_epoch=i()),
        m.IngressBatchPayload(epoch=i(), body=b(i(200))),
        m.BundlePayload(items=(rbc, bba)),
        m.LanePayload(lane=i(4), inner=bba),
        m.BbaBatchPayload(m.BbaType(i(2)), i(), i(9), bool(i(2)), props),
        m.CoinBatchPayload(
            i(), i(9), i(64), props, *([big() for _ in props] for _ in "dez")
        ),
        m.DecShareBatchPayload(
            i(), i(64), props, *([big() for _ in props] for _ in "dez")
        ),
        m.ReadyBatchPayload(i(), props, tuple(b(32) for _ in props)),
        m.EchoBatchPayload(
            i(), i(64), props, tuple(b(32) for _ in props),
            tuple(tuple(b(32) for _ in range(3)) for _ in props),
            tuple(b(i(100)) for _ in props),
        ),
    ]


def _messages(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for k, p in enumerate(_payloads(rng)):
        out.append(
            message.Message(
                sender_id=f"node{k % 7:03d}",
                timestamp=float(rng.integers(0, 1 << 40)) / 1024.0,
                payload=p,
                signature=rng.bytes(32),
                attestation=rng.bytes(13) if k % 3 == 0 else b"",
            )
        )
    return out


def _kind(msg) -> int:
    return message.encode_message(msg)[5]


def test_payload_generator_covers_every_wire_kind():
    kinds = {_kind(m) for m in _messages(0)}
    want = {v for k, v in vars(message).items() if k.startswith("_KIND_")}
    assert kinds == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pb_bytes_match_reference_both_ways(seed):
    slotted = 0
    for msg in _messages(seed):
        wire = message.encode_message(msg)
        ref_msg = ref_message.decode_message(wire)
        assert ref_message.encode_message(ref_msg) == wire
        try:
            ours = pb.encode_pb_message(msg)
        except ValueError as exc:
            # no protobuf slot for this kind: the reference refuses too
            with pytest.raises(ValueError) as ref_exc:
                ref_pb.encode_pb_message(ref_msg)
            assert str(ref_exc.value) == str(exc)
            continue
        slotted += 1
        assert ref_pb.encode_pb_message(ref_msg) == ours
        # each package decodes the other's frame to the same message
        ref_back = ref_pb.decode_pb_message(ours, sender_id=msg.sender_id)
        back = pb.decode_pb_message(
            ref_pb.encode_pb_message(ref_msg), sender_id=msg.sender_id
        )
        assert message.encode_message(back) == ref_message.encode_message(
            ref_back
        )
        assert back.payload == msg.payload
        assert back.attestation == msg.attestation
    assert slotted == 10  # RBC, BBA, CATCHUP x3, RESHARE, INGRESS x4


# ---------------------------------------------------------------------------
# the Prometheus exposition and the sampler
# ---------------------------------------------------------------------------


def _target(mods, seed: int):
    """An ObsTarget whose every counter, histogram and provider is drawn
    from ``seed`` (the golden target's shape, other values)."""
    metrics_mod, watchdog_mod, obs_mod = mods
    rng = np.random.default_rng(seed)

    def n(hi=1000):
        return int(rng.integers(0, hi))

    m = metrics_mod.Metrics()
    for c in (m.msgs_in, m.msgs_out, m.epochs_committed, m.txs_committed,
              m.dedup_absorbed, m.epochs_ordered, m.handler_dispatches,
              m.waves_routed, m.eager_share_waves):
        c.inc(n())
    for h in (m.epoch_latency, m.acs_latency, m.decrypt_latency,
              m.ordered_latency, m.settle_lag_latency):
        for v in rng.exponential(0.3, size=n(20)):
            h.observe(float(v))
    front = (n(50), n(50))
    m.set_frontiers(lambda: front)
    depth = n(8)
    m.set_pipeline(lambda: depth)
    rate = float(n(10_000)) / 8.0
    m.tx_per_sec = lambda: rate
    transport = {k: n() for k in (
        "delivered", "rejected", "frames_decoded", "decode_memo_hits",
        "decode_memo_misses", "mac_verify_batches", "frames_encoded",
        "encode_memo_hits", "encode_memo_misses", "mac_sign_batches")}
    m.set_transport_stats(lambda: transport)
    hub = {"coin_share_batches": n(), "coin_share_items": n()}
    m.set_hub_stats(lambda: hub)
    wan = {"enabled": 1, "profile": "wan_global", "frames_delayed": n(),
           "retransmits": n(), "straggler_episodes": n(),
           "virtual_time_ms": n(10**6)}
    m.set_wan_stats(lambda: wan)
    ingress = {k: n() for k in (
        "submitted", "admitted", "rejected", "retried", "deduped",
        "evicted", "subscribers", "mempool_depth")}
    m.set_ingress(lambda: ingress)
    lanes = {"lanes": 3, "merge_frontier": n(),
             "ordered_epochs": [n(), n(), n()],
             "settled_epochs": [n(), n(), n()],
             "lane_fill": [n(), n(), n()], "partition_skew": n()}
    m.set_lanes(lambda: lanes)
    states = ("up", "degraded", "down")
    peers = {
        f'peer{j}"\\': {
            "state": states[n(3)], "reconnects": n(), "dial_attempts": n(),
            "dial_failures": n(), "consecutive_failures": n(),
            "recent_delays_s": [], "state_age_s": 0.0,
        }
        for j in range(3)
    }
    m.set_transport_health(lambda: peers)
    trace = {"events_recorded": n(), "events_dropped": n(),
             "high_water": n()}
    m.set_trace_stats(lambda: trace)
    wd = watchdog_mod.SloWatchdog(
        metrics=m,
        pending_fn=lambda: 0,
        peer_states_fn=lambda: {p: v["state"] for p, v in peers.items()},
    )
    m.set_alerts(wd.alerts_block)
    return obs_mod.ObsTarget(f"node-{seed}", m, wd)


PORT = (metrics, watchdog, obs_http)
REF = (ref_metrics, ref_watchdog, ref_obs)


@pytest.mark.parametrize("seed", [3, 4])
def test_prometheus_exposition_matches_reference(seed):
    ours = obs_http.render_prometheus([_target(PORT, seed), _target(PORT, 9)])
    theirs = ref_obs.render_prometheus([_target(REF, seed), _target(REF, 9)])
    assert ours == theirs
    assert "cleisthenes_epoch_latency_seconds_bucket" in ours


def test_sampler_rings_match_reference():
    rng = np.random.default_rng(5)
    snaps = [
        {"a": int(rng.integers(0, 100)), "t": {"x": float(rng.random()),
                                                "ok": bool(rng.integers(2))},
         "s": "state"}
        for _ in range(40)
    ]
    box = {}
    ours = timeseries.TimeSeriesSampler(lambda: box["s"], cap=16)
    theirs = ref_timeseries.TimeSeriesSampler(lambda: box["s"], cap=16)
    for k, snap in enumerate(snaps):
        box["s"] = snap
        assert ours.sample(now=k * 0.5) == theirs.sample(now=k * 0.5)
    assert ours.series() == theirs.series()
    assert ours.latest() == theirs.latest()
    assert ours.rate("a") == theirs.rate("a")
    assert ours.stats() == theirs.stats()
    assert timeseries.flatten_snapshot(snaps[0]) == (
        ref_timeseries.flatten_snapshot(snaps[0])
    )


# ---------------------------------------------------------------------------
# the dial layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "seed,base,cap", [(None, 0.05, 1.0), (7, 0.05, 1.0), (11, 0.2, 30.0)]
)
def test_backoff_schedules_match_reference(seed, base, cap):
    for node, peer in (("node000", "node001"), ("n3", "n0")):
        if seed is None:
            ours = health.Backoff(base, cap)
            theirs = ref_health.Backoff(base, cap)
            # OS-random jitter: the bounds are the contract
            for _ in range(20):
                assert base * 0.75 <= ours.next_delay() <= cap
                assert base * 0.75 <= theirs.next_delay() <= cap
            continue
        ours = health.Backoff(base, cap, rng=health.backoff_rng(seed, node, peer))
        theirs = ref_health.Backoff(
            base, cap, rng=ref_health.backoff_rng(seed, node, peer)
        )
        got, want = [], []
        for step in range(40):
            if step == 25:
                ours.reset()
                theirs.reset()
            if step == 30:  # a flap: connected and lost at once
                ours.note_connected(now=100.0)
                ours.note_lost(now=100.5)
                theirs.note_connected(now=100.0)
                theirs.note_lost(now=100.5)
            got.append(ours.next_delay())
            want.append(theirs.next_delay())
        assert got == want


def test_health_rows_match_reference():
    peers = ["a", "b", "c"]
    ours = health.PeerHealthTracker(peers)
    theirs = ref_health.PeerHealthTracker(peers)
    script = [
        ("dial_started", "a"), ("connected", "a"), ("dial_started", "b"),
        ("dial_failed", "b"), ("dial_scheduled", "b", 0.1),
        ("dial_failed", "b"), ("dial_failed", "b"), ("dial_failed", "b"),
        ("stream_lost", "a"), ("dial_scheduled", "a", 0.2),
        ("connected", "a"), ("retire", "c"), ("readmit", "c"),
        ("dial_started", "c"), ("connected", "c"), ("retire", "b"),
    ]
    for step in script:
        getattr(ours, step[0])(*step[1:])
        getattr(theirs, step[0])(*step[1:])
        for peer in peers:
            assert ours.state(peer) == theirs.state(peer)
            assert ours.is_retired(peer) == theirs.is_retired(peer)

    def rows(tracker):
        return {
            p: {k: v for k, v in row.items() if k != "state_age_s"}
            for p, row in tracker.snapshot().items()
        }

    assert rows(ours) == rows(theirs)


# ---------------------------------------------------------------------------
# one epoch over real localhost gRPC (tests/test_delivery_equivalence.py's
# arrangement: n=4, batch 8, eight transactions, epoch 0 on every host)
# ---------------------------------------------------------------------------


def _grpc_epoch0(config_cls, host_mod, ledger_mod, cfg_kw, keys):
    cfg = config_cls(n=4, batch_size=8, seed=78, **cfg_kw)
    ids = sorted(keys)
    hosts = {i: host_mod.ValidatorHost(cfg, i, ids, keys[i]) for i in ids}
    # every gRPC server the hosts start, with its executor: the reference's
    # stop leaves its unnamed executor's threads idle in the process, so
    # the teardown below waits for each server and shuts its executor down
    servers = []

    def recording_server(pool, *args, **kwargs):
        server = real_server(pool, *args, **kwargs)
        servers.append((server, pool))
        return server

    real_server = grpc.server
    try:
        with mock.patch.object(grpc, "server", recording_server):
            addrs = {i: h.listen() for i, h in hosts.items()}
        threads = [
            threading.Thread(target=h.connect, args=(addrs,))
            for h in hosts.values()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        for k in range(8):
            hosts[ids[k % 4]].submit(b"grpc-dlv-%02d" % k)
        for h in hosts.values():
            h.propose()
        first = {i: h.wait_commit(timeout=120) for i, h in hosts.items()}
        assert {e for e, _ in first.values()} == {0}
        return [ledger_mod.encode_batch_body(0, b) for _, b in first.values()]
    finally:
        for h in hosts.values():
            h.stop()
        for server, pool in servers:
            server.stop(None).wait(10)
            pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def reference_epoch0():
    ref_keys = ref_setup_keys(
        RefConfig(n=4, batch_size=8, seed=78), [f"node{i}" for i in range(4)],
        seed=56,
    )
    bodies = _grpc_epoch0(RefConfig, ref_host, ref_ledger, {}, ref_keys)
    carried = interop.keys_from_plain(
        {m: dataclasses.asdict(k) for m, k in ref_keys.items()}
    )
    return bodies, carried


@pytest.mark.parametrize(
    "arm", [{"crypto_backend": "cpu"},
            {"crypto_backend": "cuda", "device": "cpu"}],
    ids=["cpu", "cuda-on-cpu"],
)
def test_grpc_epoch0_matches_reference(reference_epoch0, arm):
    want, carried = reference_epoch0
    got = _grpc_epoch0(Config, host, ledger, arm, carried)
    assert all(b == want[0] for b in want)
    assert all(b == want[0] for b in got)
