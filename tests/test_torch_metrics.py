# The reference's tests/test_metrics.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Metrics/tracing subsystem tests (SURVEY.md §5.1/§5.5), including
integration with the HoneyBadger epoch loop."""

from cleisthenes_tpu_torch.utils.metrics import Counter, Histogram, Metrics


def test_counter():
    c = Counter()
    c.inc()
    c.inc(5)
    assert c.value == 6


def test_histogram_percentiles():
    h = Histogram()
    assert h.p50 is None
    for v in range(1, 101):
        h.observe(float(v))
    assert h.count == 100
    assert 49 <= h.p50 <= 52
    assert 94 <= h.p95 <= 97
    assert h.percentile(0) == 1.0
    assert h.percentile(100) == 100.0


def test_histogram_bounded_reservoir():
    h = Histogram(cap=10)
    for v in range(100):
        h.observe(float(v))
    assert h.count == 10
    assert h.percentile(0) == 90.0  # only the newest 10 remain


def test_epoch_trace_phases():
    m = Metrics()
    m.epoch_proposed(0)
    m.epoch_acs_output(0)
    m.epoch_committed(0, n_txs=12)
    tr = m.trace(0)
    assert tr.total_s is not None and tr.total_s >= 0
    assert tr.acs_s is not None and tr.decrypt_s is not None
    assert m.epochs_committed.value == 1
    assert m.txs_committed.value == 12
    snap = m.snapshot()
    assert snap["epochs_committed"] == 1
    assert snap["epoch_p50_s"] is not None
    assert snap["tx_per_sec"] >= 0


def test_trace_map_bounded():
    m = Metrics(trace_cap=4)
    for e in range(10):
        m.epoch_proposed(e)
    assert len(m._traces) <= 4




def test_honeybadger_records_epoch_metrics():
    from tests.test_torch_honeybadger import make_hb_network, push_txs

    cfg, net, nodes = make_hb_network(4, batch_size=8)
    push_txs(nodes, 8)
    for hb in nodes.values():
        hb.start_epoch()
    net.run()
    for hb in nodes.values():
        snap = hb.metrics.snapshot()
        assert snap["epochs_committed"] >= 1
        assert snap["epoch_p50_s"] is not None
        assert snap["msgs_in"] > 0
        # phase split adds up
        tr = hb.metrics.trace(0)
        assert abs((tr.acs_s + tr.decrypt_s) - tr.total_s) < 1e-6


def test_transport_health_state_machine_and_snapshot():
    """transport.health: UP/DEGRADED/DOWN transitions, reconnect
    counters, the recorded backoff schedule, and the Metrics.snapshot
    integration (the dial layer's observability block)."""
    from cleisthenes_tpu_torch.transport.health import (
        DOWN_AFTER,
        Backoff,
        PeerHealthTracker,
        backoff_rng,
    )

    t = PeerHealthTracker(["peer-a", "peer-b"])
    assert t.state("peer-a") == "degraded"  # not connected yet
    t.dial_started("peer-a")
    t.connected("peer-a")
    assert t.state("peer-a") == "up"
    snap = t.snapshot()["peer-a"]
    assert snap["reconnects"] == 0  # boot connect is not a reconnect
    # stream loss -> DEGRADED; enough consecutive failures -> DOWN
    t.stream_lost("peer-a")
    assert t.state("peer-a") == "degraded"
    for _ in range(DOWN_AFTER):
        t.dial_started("peer-a")
        t.dial_failed("peer-a")
    assert t.state("peer-a") == "down"
    t.dial_scheduled("peer-a", 0.1)
    t.dial_scheduled("peer-a", 0.2)
    t.dial_started("peer-a")
    t.connected("peer-a")
    snap = t.snapshot()["peer-a"]
    assert snap["state"] == "up"
    assert snap["reconnects"] == 1  # the re-establishment counted
    assert snap["consecutive_failures"] == 0
    assert snap["recent_delays_s"] == [0.1, 0.2]
    # Metrics folds the block in once a provider registers
    m = Metrics()
    assert "transport_health" not in m.snapshot()
    m.set_transport_health(t.snapshot)
    assert m.snapshot()["transport_health"]["peer-b"]["state"] == "degraded"
    # Backoff: exponential growth to the cap, jitter within +/-25%,
    # deterministic for a seeded rng
    bo = Backoff(0.1, 1.0, rng=backoff_rng(5, "n0", "n1"))
    a = [bo.next_delay() for _ in range(6)]
    bo2 = Backoff(0.1, 1.0, rng=backoff_rng(5, "n0", "n1"))
    assert a == [bo2.next_delay() for _ in range(6)]
    raws = [0.1, 0.2, 0.4, 0.8, 1.0, 1.0]
    for got, raw in zip(a, raws):
        # max_s is a HARD cap: jitter never overshoots it
        assert raw * 0.75 <= got <= min(raw * 1.25, 1.0)
    assert a[1] > a[0] and a[2] > a[1]  # growth dominates the jitter
    bo.reset()
    assert bo.next_delay() <= 0.1 * 1.25
