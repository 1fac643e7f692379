# The reference's tests/test_trace.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""The observability plane: flight recorder + tracetool.

Covers the recorder's contract (bounded ring keeps newest + counts
drops; the DISABLED path allocates nothing), the Chrome-trace
rendering and tracetool's schema gate, the per-epoch critical-path
attribution (>= 95% of each epoch's wall time lands on named stages —
the PR's acceptance criterion), and — extending
test_hashseed_determinism's pattern — that two subprocess runs of the
same seeded cluster under different PYTHONHASHSEED values record the
IDENTICAL event sequence (timestamps differ; sequence must not)."""

from __future__ import annotations

import copy
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from cleisthenes_tpu_torch.config import Config  # noqa: E402
from cleisthenes_tpu_torch.utils.trace import (  # noqa: E402
    CATEGORIES,
    TraceRecorder,
    maybe_recorder,
    to_chrome,
)
from tools import tracetool  # noqa: E402


# ---------------------------------------------------------------------------
# recorder unit behavior
# ---------------------------------------------------------------------------


def test_ring_overflow_keeps_newest_and_counts_drops():
    tr = TraceRecorder("n0", cap=8)
    for i in range(20):
        tr.instant("rbc", f"ev{i:02d}")
    events = tr.events()
    assert len(events) == 8
    # newest events won; oldest were evicted
    assert [e[4] for e in events] == [f"ev{i:02d}" for i in range(12, 20)]
    # sequence numbers survive eviction (ordering ground truth)
    assert [e[0] for e in events] == list(range(13, 21))
    stats = tr.stats()
    assert stats == {
        "events_recorded": 20,
        "events_dropped": 12,
        "high_water": 8,
    }


def test_span_nesting_and_chrome_rendering():
    tr = TraceRecorder("n0")
    tr.instant("epoch", "open", epoch=0)
    with tr.span("rbc", "propose", epoch=0):
        with tr.span("hub", "flush"):
            pass
    tr.instant("epoch", "commit", epoch=0, txs=3)
    events = tr.events()
    assert len(events) == 4
    # spans record at END: the inner flush carries the smaller seq,
    # and both have non-None durations
    names = [(e[3], e[4], e[2] is None) for e in events]
    assert names == [
        ("epoch", "open", True),
        ("hub", "flush", False),
        ("rbc", "propose", False),
        ("epoch", "commit", True),
    ]
    doc = to_chrome({"n0": events})
    evs = doc["traceEvents"]
    assert evs[0]["ph"] == "M" and evs[0]["args"]["name"] == "n0"
    phases = [e["ph"] for e in evs[1:]]
    assert phases == ["i", "X", "X", "i"]
    # timestamps normalized to the earliest event, in microseconds
    assert min(e["ts"] for e in evs[1:]) == 0.0
    assert tracetool.validate(doc) == []


def test_unknown_category_rejected_by_validator():
    tr = TraceRecorder("n0")
    tr.instant("epoch", "open", epoch=0)
    doc = to_chrome({"n0": tr.events()})
    bad = copy.deepcopy(doc)
    for ev in bad["traceEvents"]:
        if ev["ph"] != "M":
            ev["cat"] = "bogus"
    errors = tracetool.validate(bad)
    assert errors and "bogus" in errors[0]


def test_validator_catches_non_monotone_seq():
    tr = TraceRecorder("n0")
    tr.instant("epoch", "open", epoch=0)
    tr.instant("epoch", "commit", epoch=0, txs=0)
    doc = to_chrome({"n0": tr.events()})
    assert tracetool.validate(doc) == []
    bad = copy.deepcopy(doc)
    analysis = [e for e in bad["traceEvents"] if e["ph"] != "M"]
    analysis[1]["args"]["seq"] = analysis[0]["args"]["seq"]  # replay
    errors = tracetool.validate(bad)
    assert errors and "strictly increasing" in errors[0]


def test_disabled_path_allocates_nothing():
    """Config.trace=False constructs NO recorder; the instrumentation
    guard (one load + identity check) must not allocate."""
    import tracemalloc

    assert maybe_recorder(Config(n=4, crypto_backend="cpu"), "n0") is None  # off by default
    assert maybe_recorder(Config(n=4, trace=True, crypto_backend="cpu"), "n0") is not None

    tr = None
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[1]
        for _ in range(10_000):
            if tr is not None:  # the site pattern, disabled
                tr.instant("rbc", "x")
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    # the loop machinery itself is the only allowance; the guard must
    # add nothing per iteration (10k iterations, < 512B total)
    assert peak - base < 512


def test_disabled_cluster_has_no_recorders():
    from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster

    cluster = SimulatedCluster(
        config=Config(n=4, batch_size=8, seed=5, crypto_backend="cpu"), seed=5, key_seed=1
    )
    assert all(hb.trace is None for hb in cluster.nodes.values())
    assert cluster.hub_trace is None
    assert cluster.trace_events() == {}
    nid = cluster.ids[0]
    assert "trace" not in cluster.nodes[nid].metrics.snapshot()


# ---------------------------------------------------------------------------
# traced cluster end to end: artifact, attribution, metrics block
# ---------------------------------------------------------------------------


def _traced_cluster_doc(tmp_path):
    from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster

    cluster = SimulatedCluster(
        config=Config(n=4, batch_size=8, seed=7, trace=True, crypto_backend="cpu"),
        seed=7,
        key_seed=1,
    )
    for i in range(24):
        cluster.submit(b"tx-%04d" % i)
    cluster.run_epochs()
    cluster.assert_agreement()
    path = tmp_path / "trace.json"
    cluster.write_trace(str(path))
    return cluster, tracetool.load(str(path))


def test_traced_cluster_validates_and_attributes(tmp_path):
    cluster, doc = _traced_cluster_doc(tmp_path)
    assert tracetool.validate(doc) == []
    # per-node tracks: all four nodes plus the shared hub
    names = set(tracetool.track_names(doc).values())
    assert names == set(cluster.ids) | {"hub"}
    windows = tracetool.epoch_windows(doc)
    assert len(windows) >= 2
    for t_open, t_commit in windows.values():
        shares, chain = tracetool.attribute_epoch(doc, t_open, t_commit)
        wall = t_commit - t_open
        covered = sum(shares.values())
        # the acceptance criterion: >= 95% of each epoch's wall time
        # attributed to named stages
        assert covered >= 0.95 * wall
        assert set(shares) <= CATEGORIES
        assert chain and max(c[0] for c in chain) <= wall
    fractions = tracetool.stage_shares(doc)
    assert fractions and abs(sum(fractions.values()) - 1.0) < 0.01
    # the epoch anatomy is visible: the crypto and delivery planes
    # both show up as named stages
    assert "rbc" in fractions and "tpke" in fractions
    # metrics snapshot carries the recorder stats block
    snap = cluster.nodes[cluster.ids[0]].metrics.snapshot()
    assert snap["trace"]["events_recorded"] > 0
    assert snap["trace"]["events_dropped"] == 0
    assert 0 < snap["trace"]["high_water"] <= Config(n=4, crypto_backend="cpu").trace_buffer
    # the report renders without error and names every epoch (windows
    # key by (lane, epoch); single-lane artifacts are all lane 0)
    text = tracetool.report(doc)
    for lane, epoch in windows:
        assert lane == 0
        assert f"epoch {epoch}:" in text
    summary = tracetool.summarize(doc)
    assert summary["hub"]["flushes"] > 0
    assert summary["events_by_category"].get("transport", 0) > 0


def test_wal_appends_record_ledger_spans(tmp_path):
    from cleisthenes_tpu_torch.core.batch import Batch
    from cleisthenes_tpu_torch.core.ledger import BatchLog

    log = BatchLog(str(tmp_path / "wal.log"))
    log.trace = TraceRecorder("n0")
    log.append(0, Batch(contributions={"a": [b"tx"]}))
    log.append_checkpoint(0, [{b"tx"}])
    log.close()
    events = log.trace.events()
    assert [(e[3], e[4]) for e in events] == [
        ("ledger", "wal_append"),
        ("ledger", "wal_checkpoint"),
    ]
    assert all(e[2] is not None and e[2] >= 0 for e in events)
    assert all(e[5]["epoch"] == 0 and e[5]["bytes"] > 0 for e in events)


# ---------------------------------------------------------------------------
# cross-PYTHONHASHSEED sequence determinism (test_hashseed_determinism
# pattern: the hash seed is fixed at interpreter start, so subprocesses
# are the only honest test)
# ---------------------------------------------------------------------------

_DRIVER = r"""
import hashlib
from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster

cluster = SimulatedCluster(
    config=Config(n=4, batch_size=8, seed=1234, trace=True, crypto_backend="cpu"),
    seed=1234,
    key_seed=1,
)
for i in range(24):
    cluster.submit(b"tx-%04d" % i)
cluster.run_epochs()
depth = cluster.assert_agreement()
h = hashlib.sha256()
n_events = 0
events_by_node = cluster.trace_events()
for node in sorted(events_by_node):
    for seq, ts, dur, cat, name, args in events_by_node[node]:
        # digest everything EXCEPT the observability clock: seq, the
        # instant/span kind, category, name, and the sorted args
        n_events += 1
        h.update(
            repr(
                (node, seq, dur is None, cat, name, sorted(args.items()))
            ).encode()
        )
print("TRACE_DIGEST=%s n=%d depth=%d" % (h.hexdigest(), n_events, depth))
"""


def _run_with_hashseed(hashseed: str) -> str:
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = hashseed
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, (
        f"PYTHONHASHSEED={hashseed} traced run failed:\n"
        f"{proc.stdout}\n{proc.stderr}"
    )
    for line in proc.stdout.splitlines():
        if line.startswith("TRACE_DIGEST="):
            return line
    raise AssertionError(f"no digest line in output:\n{proc.stdout}")


def test_trace_sequence_identical_across_hash_seeds():
    a = _run_with_hashseed("1")
    b = _run_with_hashseed("2")
    assert a == b, (
        "seeded traced runs under different PYTHONHASHSEED values "
        f"recorded different event sequences:\n  {a}\n  {b}\n"
        "-> nondeterministic ordering (or args) is leaking into the "
        "flight recorder; only timestamps may differ between replays"
    )
