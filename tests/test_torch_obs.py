# The reference's tests/test_obs.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default.
# Left out, each for tools/perfgate.py or bench.py's trend file, which
# drive the reference package: they wait for the port's benchmark
# (ROADMAP.md queue A):
#   test_perfgate_seed_then_pass_then_inflated_fail
#   test_perfgate_share_stall_retries_but_real_leak_fails
#   test_perfgate_inflated_total_is_not_share_gated
#   test_perfgate_dispatch_regression_is_noise_free
#   test_perfgate_trend_file_tolerates_torn_lines
#   test_bench_trend_append_extracts_sections
"""Live telemetry plane: sampler rings, SLO watchdogs, scrape
endpoints, and the perf-regression observatory.

Three layers under test:

1. runtime export — utils/timeseries.py bounded rings,
   Histogram.cumulative_buckets, the Prometheus text exposition
   (golden-file scrape), and the /metrics | /healthz | /vars endpoints
   on both the in-proc cluster and real gRPC hosts;
2. watchdogs — the epoch-stall detector under a SelectiveMute
   coalition, backpressure + peer-lag detectors, and /healthz flipping
   to DEGRADED under crash/partition faults;
(The reference's third layer, the tools/perfgate.py observatory,
waits for the port's tooling.)
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
import urllib.error
import urllib.request

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.protocol.byzantine import SelectiveMute
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster
from cleisthenes_tpu_torch.transport.obs_http import (
    ObsServer,
    ObsTarget,
    escape_label_value,
    render_prometheus,
)
from cleisthenes_tpu_torch.utils.metrics import Histogram, Metrics
from cleisthenes_tpu_torch.utils.timeseries import (
    TimeSeriesSampler,
    flatten_snapshot,
)
from cleisthenes_tpu_torch.utils.watchdog import (
    EPOCH_STALL,
    PEER_LAG,
    QUEUE_BACKPRESSURE,
    SloWatchdog,
    worst_health,
)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as e:  # 404/503 are assertable answers
        return e.code, e.read().decode("utf-8")


# ---------------------------------------------------------------------------
# layer 1: histogram buckets, flattening, sampler rings
# ---------------------------------------------------------------------------


def test_histogram_cumulative_buckets_and_sum():
    h = Histogram(buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    buckets = h.cumulative_buckets()
    assert buckets == [
        (0.1, 1),  # 0.05
        (1.0, 3),  # + the two 0.5s (cumulative)
        (10.0, 4),  # + 5.0
        (float("inf"), 5),  # everything
    ]
    assert h.total_sum == pytest.approx(56.05)
    assert h.total_count == 5
    # a boundary value counts into its own bucket (le is inclusive)
    hb = Histogram(buckets=(1.0,))
    hb.observe(1.0)
    assert hb.cumulative_buckets() == [(1.0, 1), (float("inf"), 1)]
    # reservoir eviction must NOT move the exposition tallies: the
    # Prometheus histogram contract wants monotonic counters, while
    # the percentile window stays bounded
    h2 = Histogram(cap=2, buckets=(10.0,))
    for v in (1.0, 2.0, 3.0):
        h2.observe(v)
    assert h2.count == 2  # percentile reservoir: bounded
    assert h2.total_count == 3  # exposition: lifetime, monotonic
    assert h2.total_sum == pytest.approx(6.0)
    assert h2.cumulative_buckets() == [(10.0, 3), (float("inf"), 3)]


def test_transport_block_uniform_on_bare_metrics():
    """Satellite: every transport key — including the delivery-plane
    columnarization counters — is ALWAYS present (zeroed) even before
    any transport registers its provider; a scraper must never see
    keys appear mid-run."""
    snap = Metrics().snapshot()
    assert snap["transport"] == {
        "delivered": 0,
        "rejected": 0,
        "dedup_absorbed": 0,
        "frames_decoded": 0,
        "decode_memo_hits": 0,
        "decode_memo_misses": 0,
        "mac_verify_batches": 0,
        "frames_encoded": 0,
        "encode_memo_hits": 0,
        "encode_memo_misses": 0,
        "mac_sign_batches": 0,
    }
    # egress-columnarization twin block: same zeroed-key
    # schema rule for the coin-issue dispatch tallies
    assert snap["hub"] == {
        "coin_share_batches": 0,
        "coin_share_items": 0,
    }
    # K-deep pipeline block: same zeroed-key schema rule
    # — present on bare metrics, at depth 1, and on every transport
    assert snap["pipeline"] == {
        "epochs_in_flight": 0,
        "eager_share_waves": 0,
    }


def test_flatten_snapshot_numeric_leaves_only():
    flat = flatten_snapshot(
        {
            "a": 1,
            "b": {"c": 2.5, "state": "up", "d": {"e": True}},
            "skip": None,
            "lst": [1, 2],
        }
    )
    assert flat == {"a": 1.0, "b.c": 2.5, "b.d.e": 1.0}


def test_sampler_rings_bounded_and_rates():
    state = {"v": 0}
    sampler = TimeSeriesSampler(
        lambda: {"ctr": state["v"], "nest": {"x": 1}}, cap=4
    )
    for i in range(8):
        state["v"] = i * 10
        sampler.sample(now=float(i))
    series = sampler.series()
    assert len(series["ctr"]) == 4  # ring keeps the newest cap points
    assert series["ctr"][0] == (4.0, 40.0)
    assert series["ctr"][-1] == (7.0, 70.0)
    assert sampler.latest() == {"ctr": 70.0, "nest.x": 1.0}
    assert sampler.rate("ctr") == pytest.approx(10.0)  # 30 over 3s
    assert sampler.rate("missing") is None
    assert sampler.stats() == {"samples": 8, "series": 2}


def test_sampler_tick_receives_synthetic_clock():
    """on_tick callbacks get the sample instant, so a synthetic
    ``sample(now=...)`` drives the riding watchdog's clock too —
    rings and verdicts tell one consistent story."""
    seen = []
    sampler = TimeSeriesSampler(lambda: {"v": 1})
    sampler.on_tick(seen.append)
    sampler.sample(now=123.5)
    assert seen == [123.5]
    m = Metrics()
    wd = SloWatchdog(
        metrics=m, pending_fn=lambda: 3, stall_grace_s=5.0
    )
    s2 = TimeSeriesSampler(m.snapshot)
    s2.on_tick(wd.check)
    m.set_alerts(wd.alerts_block)
    s2.sample(now=m._t0 + 1000.0)  # synthetic stall, no sleeping
    assert wd.alerts_block()[EPOCH_STALL]["active"] is True
    # ...and the ring recorded the post-check alert state
    assert s2.latest()["alerts.epoch_stall.active"] == 1.0


def test_sampler_thread_ticks_and_stops():
    ticks = []
    sampler = TimeSeriesSampler(lambda: {"v": 1})
    sampler.on_tick(lambda now: ticks.append(now))
    sampler.start(period_s=0.02)
    deadline = time.monotonic() + 5.0
    while not ticks and time.monotonic() < deadline:
        time.sleep(0.01)
    sampler.stop()
    assert ticks, "sampler thread never ticked"
    assert sampler.latest()["v"] == 1.0


# ---------------------------------------------------------------------------
# layer 1: the Prometheus exposition (golden-file scrape)
# ---------------------------------------------------------------------------


def test_label_escaping_per_text_format():
    assert escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'
    # escaping the escapes first: a literal backslash-n stays distinct
    # from a newline
    assert escape_label_value("x\\n") == "x\\\\n"


def _golden_target() -> ObsTarget:
    """A fully deterministic scrape target: every counter, histogram,
    provider block and alert pinned to fixed values."""
    m = Metrics()
    m.msgs_in.inc(10)
    m.msgs_out.inc(20)
    m.epochs_committed.inc(2)
    m.txs_committed.inc(30)
    m.dedup_absorbed.inc(3)
    for v in (0.05, 0.2):
        m.epoch_latency.observe(v)
    m.acs_latency.observe(0.04)
    m.decrypt_latency.observe(0.01)
    # two-frontier commit split: ordered-frontier latency,
    # the trailing settle lag, and a 1-epoch decrypt lag in flight
    m.ordered_latency.observe(0.03)
    m.settle_lag_latency.observe(0.02)
    m.epochs_ordered.inc(3)
    m.set_frontiers(lambda: (3, 2))
    # wave-routed ingest counters: zeroed keys on every
    # path; pinned nonzero so the golden scrape covers the families
    m.handler_dispatches.inc(12)
    m.waves_routed.inc(4)
    # K-deep pipeline counters: pinned nonzero so the
    # golden scrape covers the new families
    m.eager_share_waves.inc(2)
    m.set_pipeline(lambda: 3)
    m.tx_per_sec = lambda: 1.5  # pin the one wall-clock-derived gauge
    m.set_transport_stats(
        lambda: {
            "delivered": 7,
            "rejected": 1,
            # delivery-plane columnarization counters (zeroed keys on
            # every path; pinned nonzero here so the golden scrape
            # covers the new families)
            "frames_decoded": 6,
            "decode_memo_hits": 4,
            "decode_memo_misses": 2,
            "mac_verify_batches": 3,
            # egress-columnarization counters: same rule
            "frames_encoded": 5,
            "encode_memo_hits": 3,
            "encode_memo_misses": 2,
            "mac_sign_batches": 4,
        }
    )
    m.set_hub_stats(
        lambda: {"coin_share_batches": 2, "coin_share_items": 9}
    )
    # WAN emulation-plane counters: zeroed keys on every
    # path; pinned nonzero so the golden scrape covers the families
    m.set_wan_stats(
        lambda: {
            "enabled": 1,
            "profile": "wan_3region",
            "frames_delayed": 11,
            "retransmits": 2,
            "straggler_episodes": 1,
            "virtual_time_ms": 1500,
        }
    )
    # client ingress-plane counters: zeroed keys on every
    # path; pinned nonzero so the golden scrape covers the families
    m.set_ingress(
        lambda: {
            "submitted": 9,
            "admitted": 6,
            "rejected": 1,
            "retried": 1,
            "deduped": 1,
            "evicted": 1,
            "subscribers": 2,
            "mempool_depth": 4,
        }
    )
    # lane shard-out gauges: zeroed keys on every path;
    # pinned to a two-lane shape so the golden scrape covers the
    # per-lane labeled families
    m.set_lanes(
        lambda: {
            "lanes": 2,
            "merge_frontier": 5,
            "ordered_epochs": [3, 2],
            "settled_epochs": [3, 2],
            "lane_fill": [8, 6],
            "partition_skew": 2,
        }
    )
    m.set_transport_health(
        lambda: {
            'peer"q\\s': {
                "state": "down",
                "reconnects": 2,
                "dial_attempts": 9,
                "dial_failures": 4,
                "consecutive_failures": 4,
                "recent_delays_s": [],
                "state_age_s": 0.0,
            }
        }
    )
    m.set_trace_stats(
        lambda: {"events_recorded": 5, "events_dropped": 0, "high_water": 5}
    )
    wd = SloWatchdog(
        metrics=m,
        pending_fn=lambda: 0,
        peer_states_fn=lambda: {'peer"q\\s': "down"},
    )
    m.set_alerts(wd.alerts_block)
    return ObsTarget("node-a", m, wd)


def test_prometheus_exposition_matches_golden():
    """The scrape is a FORMAT contract (Prometheus text exposition
    0.0.4): byte-compare against the committed golden file so any
    accidental change to names, labels, escaping or bucket layout
    shows up as a diff, not a silent scrape break."""
    server = ObsServer([_golden_target()])
    got = server.metrics_text()
    golden_path = GOLDEN / "metrics_exposition.txt"
    assert got == golden_path.read_text(encoding="utf-8"), (
        "exposition drifted from tests/golden/metrics_exposition.txt — "
        "if intentional, regenerate: write "
        "ObsServer([_golden_target()]).metrics_text() to the golden path"
    )


def test_exposition_self_consistency():
    text = render_prometheus([_golden_target()])
    lines = text.splitlines()
    # every non-comment sample parses as `name{labels} value`
    samples = [l for l in lines if l and not l.startswith("#")]
    assert samples
    for line in samples:
        name_part, value = line.rsplit(" ", 1)
        assert "{" in name_part and name_part.endswith("}")
        float(value.replace("+Inf", "inf"))
    # cumulative buckets end in the +Inf catch-all == _count
    inf = [l for l in samples if 'le="+Inf"' in l and "epoch_latency" in l]
    count = [l for l in samples if l.startswith(
        "cleisthenes_epoch_latency_seconds_count")]
    assert inf[0].rsplit(" ", 1)[1] == count[0].rsplit(" ", 1)[1] == "2"
    # each family header appears exactly once
    helps = [l for l in lines if l.startswith("# HELP")]
    assert len(helps) == len(set(helps))


# ---------------------------------------------------------------------------
# layer 2: SLO watchdogs
# ---------------------------------------------------------------------------


def test_watchdog_stall_budget_self_calibrates():
    m = Metrics()
    wd = SloWatchdog(metrics=m, pending_fn=lambda: 1, stall_grace_s=2.0)
    assert wd.stall_budget_s() == 2.0  # no p50 yet: the grace floor
    for _ in range(4):
        m.epoch_latency.observe(10.0)
    assert wd.stall_budget_s() == pytest.approx(80.0)  # factor * p50


def test_watchdog_detectors_and_health_transitions():
    m = Metrics()
    pending = {"n": 0}
    peers = {"p1": "up"}
    wd = SloWatchdog(
        metrics=m,
        pending_fn=lambda: pending["n"],
        stall_grace_s=5.0,
        queue_depth_limit=100,
        peer_states_fn=lambda: dict(peers),
    )
    t0 = m._t0
    assert wd.check(now=t0 + 1.0) == "up"
    # pending work + no commit past the budget -> stall -> DOWN
    pending["n"] = 7
    assert wd.check(now=t0 + 60.0) == "down"
    block = wd.alerts_block()
    assert block[EPOCH_STALL] == {
        "count": 1,
        "active": True,
        "reason": block[EPOCH_STALL]["reason"],
    }
    assert "7 txs pending" in block[EPOCH_STALL]["reason"]
    # a commit clears the stall; an over-limit queue degrades
    m.epoch_committed(0, n_txs=1)
    pending["n"] = 101
    verdict = wd.check(now=m._last_commit_t + 1.0)
    assert verdict == "degraded"
    block = wd.alerts_block()
    assert block[EPOCH_STALL]["active"] is False
    assert block[EPOCH_STALL]["count"] == 1  # edge-counted, not re-fired
    assert block[QUEUE_BACKPRESSURE]["active"] is True
    # a DOWN peer keeps health degraded even with an empty queue
    pending["n"] = 0
    peers["p1"] = "down"
    assert wd.check(now=m._last_commit_t + 1.0) == "degraded"
    assert wd.alerts_block()[PEER_LAG]["active"] is True
    peers["p1"] = "up"
    assert wd.check(now=m._last_commit_t + 1.0) == "up"
    assert worst_health(["up", "degraded", "down"]) == "down"


@pytest.mark.faults
def test_epoch_stall_watchdog_fires_under_selective_mute():
    """A SelectiveMute coalition past the fault budget (2 of 4 nodes
    silent toward everyone) starves every quorum: no epoch commits,
    and the stall detector must flip the node to DOWN, count the
    firing, and land an ``alert`` instant on the timeline."""
    cfg = Config(crypto_backend="cpu", n=4, batch_size=8, seed=11, trace=True,
                 slo_stall_grace_s=5.0)
    cluster = SimulatedCluster(
        config=cfg,
        seed=11,
        behaviors={
            "node001": SelectiveMute(seed=1, fraction=1.0),
            "node002": SelectiveMute(seed=2, fraction=1.0),
        },
    )
    for i in range(16):
        cluster.submit(b"stall-%03d" % i)
    cluster.run_until_drained(max_rounds=2)
    honest = cluster.nodes["node000"]
    assert honest.metrics.epochs_committed.value == 0  # truly stalled
    # the K-deep pipeline window may have absorbed the whole queue
    # into in-flight proposals; the watchdog reads the OUTSTANDING
    # count (queue + in-flight) so a stalled node still shows work
    assert honest.outstanding_tx_count() > 0
    wd = cluster.watchdogs["node000"]
    # synthetic clock: drive past the budget without sleeping
    assert wd.check(now=honest.metrics._t0 + 1000.0) == "down"
    block = honest.metrics.snapshot()["alerts"]
    assert block[EPOCH_STALL]["active"] is True
    assert block[EPOCH_STALL]["count"] == 1
    # the firing is on the flight-recorder timeline next to the
    # protocol events that explain it
    alerts = [
        ev for ev in honest.trace.events() if ev[3] == "alert"
    ]
    assert alerts and alerts[0][4] == EPOCH_STALL


@pytest.mark.faults
def test_cluster_health_degrades_under_partition():
    """fault + telemetry: an injected partition flips the
    channel-transport /healthz verdict to DEGRADED via the peer-state
    detector (ChannelNetwork.link_states)."""
    cluster = SimulatedCluster(
        config=Config(crypto_backend="cpu", n=4, batch_size=8, seed=5), seed=5
    )
    for i in range(8):
        cluster.submit(b"part-%03d" % i)
    cluster.run_epochs()
    assert cluster.health()["status"] == "up"
    cluster.partition("node000", "node001")
    doc = cluster.health()
    assert doc["status"] == "degraded"
    assert doc["nodes"]["node000"] == "degraded"
    assert doc["nodes"]["node002"] == "up"  # unaffected pair stays UP
    cluster.net.heal("node000", "node001")
    assert cluster.health()["status"] == "up"


# ---------------------------------------------------------------------------
# layer 1+2: live endpoints on both transports
# ---------------------------------------------------------------------------


def test_cluster_obs_endpoints_scrape():
    cluster = SimulatedCluster(
        config=Config(crypto_backend="cpu", n=4, batch_size=8, seed=7, trace=True, obs_port=0),
        seed=7,
    )
    try:
        for i in range(16):
            cluster.submit(b"obs-%03d" % i)
        cluster.run_epochs()
        assert cluster.obs.port is not None
        base = f"http://127.0.0.1:{cluster.obs.port}"
        status, text = _get(base + "/metrics")
        assert status == 200
        # the acceptance surface: epoch-latency buckets, transport
        # frames, alert counters — for every roster member
        for nid in cluster.ids:
            assert (
                f'cleisthenes_epoch_latency_seconds_bucket{{node="{nid}"'
                in text
            )
            assert (
                f'cleisthenes_transport_frames_total{{node="{nid}",'
                f'result="delivered"}}' in text
            )
            assert (
                f'cleisthenes_alerts_total{{node="{nid}",'
                f'alert="epoch_stall"}} 0' in text
            )
        assert 'cleisthenes_health{node="node000"} 2' in text
        status, body = _get(base + "/healthz")
        assert status == 200 and json.loads(body)["status"] == "up"
        status, body = _get(base + "/vars")
        vars_doc = json.loads(body)
        assert set(vars_doc) == set(cluster.ids)
        assert "timeseries" in vars_doc["node000"]  # sampler rings ride /vars
        node0 = vars_doc["node000"]["metrics"]
        assert node0["epochs_committed"] >= 1
        assert set(node0["transport"]) == {
            "delivered", "rejected", "dedup_absorbed",
            "frames_decoded", "decode_memo_hits",
            "decode_memo_misses", "mac_verify_batches",
            "frames_encoded", "encode_memo_hits",
            "encode_memo_misses", "mac_sign_batches",
        }
        assert node0["alerts"][EPOCH_STALL]["active"] is False
        status, _ = _get(base + "/nope")
        assert status == 404
    finally:
        cluster.stop()


@pytest.mark.faults
def test_host_obs_endpoints_and_healthz_degrades_on_peer_crash():
    """The gRPC acceptance path: scrape a running ValidatorHost's
    /metrics (buckets + transport health + alerts present), then kill
    a peer — the survivor's /healthz must leave UP once its dial layer
    notices the lost stream."""
    from cleisthenes_tpu_torch.protocol.honeybadger import setup_keys
    from cleisthenes_tpu_torch.transport.host import ValidatorHost
    import threading

    cfg = Config(crypto_backend="cpu",
        n=4, batch_size=8, seed=5, obs_port=0,
        dial_retry_base_s=0.05, dial_retry_max_s=0.2,
    )
    ids = [f"n{i}" for i in range(4)]
    keys = setup_keys(cfg, ids, seed=3)
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
            t.join()
        for i in range(8):
            hosts[ids[i % 4]].submit(b"tx-%d" % i)
        for h in hosts.values():
            h.propose()
        hosts[ids[0]].wait_commit(timeout=60)
        base = f"http://127.0.0.1:{hosts[ids[0]].obs.port}"
        status, text = _get(base + "/metrics")
        assert status == 200
        assert 'cleisthenes_epoch_latency_seconds_bucket{node="n0"' in text
        assert 'cleisthenes_peer_health{node="n0",peer="n3",state=' in text
        assert 'cleisthenes_alert_active{node="n0",' in text
        status, body = _get(base + "/healthz")
        assert status == 200 and json.loads(body)["status"] == "up"
        # crash n3: the survivor's dial layer degrades the peer and
        # /healthz must follow
        hosts["n3"].stop()
        deadline = time.monotonic() + 30.0
        verdict = "up"
        while time.monotonic() < deadline:
            _, body = _get(base + "/healthz")
            verdict = json.loads(body)["status"]
            if verdict != "up":
                break
            time.sleep(0.2)
        assert verdict == "degraded"
        snap = hosts[ids[0]].node.metrics.snapshot()
        assert snap["transport_health"]["n3"]["state"] != "up"
    finally:
        for h in hosts.values():
            h.stop()
        # let the dying streams' close callbacks finish logging while
        # this test's capture streams are still open (the "peer stream
        # lost" warnings ride gRPC reader threads)
        time.sleep(0.3)


def test_demo_obs_port_flag(capsys):
    from cleisthenes_tpu_torch import demo

    rc = demo.main(
        ["--crypto", "cpu", "--n", "4", "--txs", "8", "--batch-size", "8",
         "--obs-port", "0"]
    )
    # same grace as the host test above: demo.main's stopped hosts
    # flush their stream-lost warnings on gRPC reader threads
    time.sleep(0.3)
    assert rc == 0
    out = capsys.readouterr().out
    assert "telemetry (/metrics /healthz /vars)" in out
