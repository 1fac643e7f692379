"""The gRPC path of ``chip_smoke.py`` (``grpc_phase``) rehearsed on the
CPU through the phase's own builders.

The card runs BASELINE config 2 (N=16, f=5, 4,096-tx batches) as 16
``ValidatorHost``s over localhost gRPC.  Here the whole phase, twin
included, runs at N=4 with batch 16 on the host backend ('cpu'): every
gate but the card's (launches, engines, streams, kernel records) —
agreement, each transaction once, the /metrics and /healthz scrape held
to the node's snapshot, no host thread left after ``stop``, and the
'cpu' twin.  The exposition parser the scrape gate uses is held to the
port's own renderer."""

import torch

import chip_smoke as cs
from cleisthenes_tpu_torch.transport.obs_http import ObsTarget, render_prometheus
from cleisthenes_tpu_torch.utils.metrics import Metrics


def test_grpc_path_at_n4_on_the_host_backend():
    res = cs.grpc_phase(
        torch, 1.0, n=4, batch=16, txs=64, warm_txs=32, crypto_backend="cpu",
    )
    # the host backend launches nothing
    assert res["launches"]["sites"] == {} and res["kernels"] == {}
    assert res["run_s"] > 0
    assert cs.host_threads() == []


def test_parse_exposition_reads_the_renderer():
    m = Metrics()
    m.msgs_in.inc(3)
    m.epoch_latency.observe(0.25)
    m.set_transport_health(lambda: {'p"\\': {
        "state": "up", "reconnects": 1, "dial_attempts": 2,
        "dial_failures": 0, "consecutive_failures": 0,
        "recent_delays_s": [], "state_age_s": 0.0}})
    got = cs.parse_exposition(render_prometheus([ObsTarget("n0", m)]))
    assert got[("cleisthenes_msgs_in_total", (("node", "n0"),))] == 3.0
    assert got[("cleisthenes_epoch_latency_seconds_bucket",
                (("le", "+Inf"), ("node", "n0")))] == 1.0
    peer = [k for k in got if k[0] == "cleisthenes_peer_health"]
    assert peer == [("cleisthenes_peer_health",
                     (("node", "n0"), ("peer", 'p\\"\\\\'), ("state", "up")))]
