# The reference's tests/test_metrics.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
# Left out, each for a module of a later slice (ROADMAP.md queue A):
#   test_transport_health_state_machine_and_snapshot
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
