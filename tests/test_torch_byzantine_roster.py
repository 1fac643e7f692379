# The reference's tests/test_byzantine.py::test_byzantine_big_roster_prefix_consistency,
# re-pointed at cleisthenes_tpu_torch, with the two helpers it imports from
# tools/sweep_common.py (build_seed_scenario, check_prefix) copied here and
# re-pointed the same way.  It takes ~100 s on one CPU core, so it has a
# file of its own: a worker that distributes tests by file runs it alone.
"""Big-roster Byzantine coalition under a bounded step budget: honest
nodes' committed histories stay prefix-consistent."""

import random

import pytest

from cleisthenes_tpu_torch.utils.adversary import Coalition
from tests.test_torch_honeybadger import make_hb_network, push_txs

pytestmark = pytest.mark.faults


def check_prefix(nodes, honest) -> bool:
    """Per-epoch PREFIX consistency among honest nodes — the real
    HBBFT agreement property for runs that may stop at a round cap
    (strict whole-history equality over-claims: honest laggards may
    hold a prefix mid-convergence).  Prints the earliest divergence."""
    hists = {
        k: [tuple(sorted(b.tx_list())) for b in nodes[k].committed_batches]
        for k in honest
    }
    ok = True
    for i in range(len(honest)):
        for j in range(i + 1, len(honest)):
            a, b = hists[honest[i]], hists[honest[j]]
            m = min(len(a), len(b))
            if a[:m] != b[:m]:
                ok = False
                for e in range(m):
                    if a[e] != b[e]:
                        sa, sb = set(a[e]), set(b[e])
                        print(
                            f"PREFIX DIVERGES {honest[i]} vs {honest[j]}"
                            f" at epoch {e}:\n"
                            f"  only in {honest[i]}: {sorted(sa - sb)[:4]}\n"
                            f"  only in {honest[j]}: {sorted(sb - sa)[:4]}",
                            flush=True,
                        )
                        break
    return ok


def build_seed_scenario(seed: int):
    """The big-roster adversarial scenario for ``seed``, as the
    reference's tools/sweep_common.py builds it.  Returns (cfg, net,
    nodes, bad, honest)."""
    rng = random.Random(seed)
    n = rng.choice([10, 13])
    f = (n - 1) // 3
    cfg, net, nodes = make_hb_network(n, batch_size=16, seed=seed)
    bad = rng.sample(sorted(nodes), f)
    coal = Coalition(bad, seed=seed)
    for stage, arg in (
        ("drop", rng.uniform(0.1, 0.6)),
        ("tamper", rng.uniform(0.0, 0.7)),
        ("duplicate", rng.uniform(0.0, 0.5)),
        ("replay", rng.uniform(0.0, 0.5)),
    ):
        if rng.random() < 0.7:
            getattr(coal, stage)(arg)
    net.fault_filter = coal.filter
    push_txs(nodes, 3 * n)
    honest = sorted(k for k in nodes if k not in bad)
    return cfg, net, nodes, bad, honest


def test_byzantine_big_roster_prefix_consistency():
    """Big rosters under coalition faults, with a BOUNDED step budget
    and the CORRECT safety assertion: per-epoch PREFIX consistency
    among honest nodes (HBBFT agreement), not whole-history equality.
    The strict-equality sweep (test_torch_byzantine.py) is valid only because its small
    rosters provably drain; at n in {10, 13} a bounded run stops
    mid-convergence and honest laggards legitimately hold a prefix
    (the seed-1005 classification: tools/sweep_roster.py).
    """
    for seed in (1001, 1013):
        cfg, net, nodes, bad, honest = build_seed_scenario(seed)
        for rnd in range(2):
            for hb in nodes.values():
                hb.start_epoch()
            net.run(max_steps=150_000)
            assert check_prefix(nodes, honest), (
                f"prefix diverged at seed {seed} round {rnd}"
            )
        committed = sum(
            len(b) for b in nodes[honest[0]].committed_batches
        )
        assert committed > 0, f"no progress at seed {seed}"
