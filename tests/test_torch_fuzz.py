# The reference's tests/test_fuzz.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default (the
# port's fuzzer defaults to the card), plus a parity case holding the
# port's sampler, verdicts and committed ledgers to the reference's.
"""Schedule-fuzzer self-tests (cleisthenes_tpu_torch/tools/fuzz.py).

The fuzzer is only trustworthy if (a) sampled schedules are a pure
function of the seed, (b) the invariant checker actually fires, and
(c) shrinking converges to a MINIMAL failing schedule whose repro file
re-triggers the identical violation deterministically.  (b) and (c)
are proven with a PLANTED violation: a ``tx_injector`` behavior — a
Byzantine proposer slipping its own transactions into its proposals,
perfectly legal HBBFT — which the harness detects with certainty
because it knows every submitted tx.
"""

import copy
import json

import pytest

from cleisthenes_tpu_torch.tools.fuzz import (
    Violation,
    load_repro,
    run_schedule as _run_schedule,
    sample_schedule,
    shrink as _shrink,
    write_repro,
)

pytestmark = pytest.mark.faults


def run_schedule(schedule, **kwargs):
    """The reference's default backend: the host's."""
    return _run_schedule(schedule, crypto="cpu", **kwargs)


def shrink(schedule, violation=None):
    return _shrink(schedule, violation, crypto="cpu")


def planted_schedule():
    """A small failing schedule buried under irrelevant components the
    shrinker must strip away."""
    return {
        "version": 1,
        "seed": 3,
        "n": 4,
        "f": 1,
        "batch_size": 8,
        "key_seed": 33,
        "rounds": 4,
        "txs": 4,
        "bad": ["node003"],
        "behaviors": [
            {"kind": "split_voter", "node": "node003", "seed": 1},
            {"kind": "tx_injector", "node": "node003", "seed": 9},
        ],
        "wire": [{"stage": "drop", "args": {"fraction": 0.1}}],
        "timeline": [
            {
                "round": 1,
                "op": "partition",
                "node": "node003",
                "peer": "node000",
            },
            {
                "round": 2,
                "op": "heal",
                "node": "node003",
                "peer": "node000",
            },
        ],
        "check_liveness": True,
    }


def test_sampled_schedules_are_seed_pure():
    a = sample_schedule(5)
    b = sample_schedule(5)
    assert a == b
    assert a["seed"] == 5
    # sampled faults stay inside the f-budget coalition
    fault_nodes = {spec["node"] for spec in a["behaviors"]}
    fault_nodes |= {
        ev["node"] for ev in a["timeline"] if ev["op"] == "crash"
    }
    assert fault_nodes <= set(a["bad"])
    assert len(a["bad"]) == a["f"]


def test_sampler_never_mounts_the_tx_injector():
    for seed in range(40):
        s = sample_schedule(seed)
        assert all(
            b["kind"] != "tx_injector" for b in s["behaviors"]
        ), f"seed {seed} sampled the planted-violation behavior"


def test_smoke_seeds_hold_every_invariant():
    """A slice of the ci.sh smoke band: composite semantic+wire
    schedules over seeded 4-node clusters, all invariants green."""
    for seed in (0, 3):
        assert run_schedule(sample_schedule(seed)) is None


def test_planted_violation_is_detected_and_detail_named():
    v = run_schedule(planted_schedule())
    assert v is not None
    assert v["invariant"] == "no_foreign_tx"
    assert "injected|9|0" in v["detail"]


def test_shrink_converges_to_minimal_replayable_repro(tmp_path):
    """The acceptance scenario: shrink the planted schedule to the
    single guilty component, write the repro, and replay it twice —
    same violation, byte for byte."""
    schedule = planted_schedule()
    minimal, violation = shrink(schedule)
    # every irrelevant component stripped: only the injector remains
    assert minimal["behaviors"] == [
        {"kind": "tx_injector", "node": "node003", "seed": 9}
    ]
    assert minimal["wire"] == []
    assert minimal["timeline"] == []
    assert minimal["txs"] == 1
    assert minimal["rounds"] == 2
    # the minimal schedule violates the SAME invariant that started
    # the shrink (the invariant-pinning contract)
    assert violation is not None
    assert violation["invariant"] == "no_foreign_tx"
    assert run_schedule(minimal) == violation
    repro = tmp_path / "repro.json"
    write_repro(str(repro), minimal, violation)
    loaded = load_repro(str(repro))
    assert loaded["schedule"] == minimal
    # deterministic re-trigger: two fresh replays, identical reports
    r1 = run_schedule(loaded["schedule"])
    r2 = run_schedule(loaded["schedule"])
    assert r1 == r2 == violation
    # and the repro is honest JSON: round-trips unchanged
    assert json.loads(json.dumps(loaded["schedule"])) == minimal


def test_shrink_refuses_a_passing_schedule():
    with pytest.raises(ValueError, match="failing schedule"):
        shrink(sample_schedule(0))


def test_shrink_input_is_not_mutated():
    schedule = planted_schedule()
    frozen = copy.deepcopy(schedule)
    shrink(schedule)
    assert schedule == frozen


def test_shrink_skips_confirming_run_when_violation_supplied():
    """fuzz_seeds hands shrink the violation it already observed; the
    pinned invariant must match what an unprimed shrink finds."""
    schedule = planted_schedule()
    known = run_schedule(schedule)
    minimal, violation = shrink(schedule, known)
    assert violation["invariant"] == known["invariant"]
    assert minimal["behaviors"] == [
        {"kind": "tx_injector", "node": "node003", "seed": 9}
    ]


def test_violation_exception_report_shape():
    v = Violation("agreement", "fork at epoch 0", 3)
    assert v.report == {
        "invariant": "agreement",
        "detail": "fork at epoch 0",
        "round": 3,
    }


def test_fuzzer_records_flight_recorder_artifact(tmp_path):
    """run_schedule(trace_path=...) writes a merged Perfetto-loadable
    artifact (utils/trace.py) for any schedule, failing or not."""
    path = tmp_path / "fuzz_trace.json"
    v = run_schedule(
        {**planted_schedule(), "wire": [], "timeline": []},
        trace_path=str(path),
    )
    assert v is not None
    doc = json.loads(path.read_text())
    assert doc["traceEvents"], "empty trace artifact"


@pytest.mark.slow
def test_fuzz_deep_sweep():
    """The deep band: 200 sampled composite schedules, every safety
    and liveness invariant must hold (ci.sh stage runs the 0:20 smoke
    band; this is the RUN-SLOW extension)."""
    for seed in range(20, 220):
        v = run_schedule(sample_schedule(seed))
        assert v is None, f"seed {seed}: {v}"


@pytest.mark.slow
def test_fuzz_pipeline_deep_sweep():
    """The K-deep pipelined-frontier deep band: 200
    sampled composite schedules pinned alternately to depth 2 and
    depth 4 — the cross-frontier invariants (settled prefix ⊆
    ordered log, byte-identical honest ordered logs, decrypt-lag
    bound) must hold over the widened in-flight window (ci.sh runs
    the 20-seed smoke band of this sampler)."""
    for seed in range(20, 220):
        depth = 2 if seed % 2 else 4
        v = run_schedule(
            sample_schedule(seed, pipeline_depth=depth)
        )
        assert v is None, f"seed {seed} depth {depth}: {v}"


@pytest.mark.slow
def test_fuzz_wan_deep_sweep():
    """The WAN emulation deep band: 200 sampled composite
    schedules over the seeded link-model plane — the profile (lan /
    wan_3region / wan_global / straggler_tail / lossy) is itself
    drawn from the seed, so latency, jitter, loss-retransmission,
    bandwidth serialization and heavy-tailed straggler episodes all
    reshape delivery order — and every safety and liveness invariant
    must hold (ci.sh runs the 0:20 smoke band of this sampler; this
    is the RUN-SLOW extension)."""
    for seed in range(20, 220):
        v = run_schedule(sample_schedule(seed, wan=True))
        assert v is None, f"seed {seed}: {v}"


@pytest.mark.slow
def test_fuzz_reconfig_deep_sweep():
    """The dynamic-membership deep band: 200 reconfig-bearing
    schedules — every sampled crash/partition/semantic composite runs
    ACROSS a join (sometimes composed with a coalition retirement)
    reshare ceremony, and the invariants (ledger agreement, roster/
    key agreement, no foreign tx, liveness for the final roster) must
    span the switch (ci.sh runs the 0:20 smoke band of this sampler;
    this is the RUN-SLOW extension)."""
    for seed in range(20, 220):
        v = run_schedule(
            sample_schedule(seed, rounds=16, reconfig=True)
        )
        assert v is None, f"seed {seed}: {v}"


@pytest.mark.slow
def test_fuzz_lanes_deep_sweep():
    """The lane shard-out deep band: 200 sampled composite
    schedules with Config.lanes drawn from {2,3,4} per seed (appended
    LAST, extending the historical stream) — S independent HBBFT
    lanes over one roster, hash-partitioned admission and the
    deterministic cross-lane merge — gating merge-determinism (every
    honest node's merged total order byte-identical), cross-lane
    settle-exactly-once, the per-lane two-frontier invariants and
    liveness over the merged ledger (ci.sh runs the 0:20 smoke band
    of this sampler; this is the RUN-SLOW extension)."""
    for seed in range(20, 220):
        v = run_schedule(sample_schedule(seed, lanes=True))
        assert v is None, f"seed {seed}: {v}"


@pytest.mark.parametrize("seed", [0, 7])
def test_schedules_verdicts_and_ledgers_match_the_reference(seed, monkeypatch):
    """The same seed samples the same schedule as the reference's
    tools/fuzz.py, and running it gives the same verdict and the same
    committed ledger bytes on every honest node."""
    import tools.fuzz as ref_fuzz
    from cleisthenes_tpu.core.ledger import encode_batch_body

    schedule = sample_schedule(seed)
    assert schedule == ref_fuzz.sample_schedule(seed)
    built = []
    real_build = ref_fuzz._build_cluster

    def keep(*args, **kwargs):
        built.append(real_build(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(ref_fuzz, "_build_cluster", keep)
    ref_v = ref_fuzz.run_schedule(copy.deepcopy(schedule))
    bad = set(schedule["bad"])
    ref_ledgers = {
        nid: [
            encode_batch_body(e, b)
            for e, b in enumerate(built[0].nodes[nid].committed_batches)
        ]
        for nid in sorted(built[0].nodes)
        if nid not in bad
    }
    ledgers = {}
    assert run_schedule(schedule, ledgers=ledgers) == ref_v
    assert ledgers == ref_ledgers
    assert all(ledgers.values())
