"""The Byzantine path of ``chip_smoke.py`` (``byzantine_phase``) rehearsed
on the CPU through the phase's own builders.

The card runs BASELINE config 3 (N=64, f=21) at 10,000-tx batches with a
full-budget coalition: the first 21 nodes lie (``BYZ_KINDS`` in turn:
ShareForger, BadDealer, Equivocator, SplitVoter, SelectiveMute,
EpochSprayer) under a wire adversary of the same nodes.  Here:

- the same roster, coalition, wire adversary and transaction schedule at
  batch 64 on the host backend ('cpu'): honest agreement to depth 2,
  every transaction exactly once on every honest node, every behaviour
  lying, false branch verdicts (BadDealer) and false CP checks
  (ShareForger).  On ``crypto_backend='cuda'`` with ``device='cpu'`` the
  same N=64 run takes ~12 minutes on four CPU threads (the kernels'
  plain modexp versions: ~127 pooled CP waves), too long for this suite;
- the phase whole, on the card's code path (``'cuda'`` on
  ``device='cpu'``, the kernels' plain versions) at N=7, f=2, whose
  coalition is one ShareForger and one BadDealer, the two kinds whose
  lies K8 and K6 reject: the false verdicts are K6's and K8's, and the
  'cpu' twin matches the run (ledgers, rewrites, hub stats and rejects).
"""

import torch

import chip_smoke as cs


def test_byzantine_path_at_n64_on_the_host_backend():
    res = cs.byzantine_phase(
        torch, 1.0, n=cs.ASYNC_N, batch=64, txs=64, twin=False,
        crypto_backend="cpu",
    )
    rej = res["rejects"]
    assert rej["branch_false"] > 0 and rej["cp_false"] > 0
    # the host backend launches nothing
    assert res["launches"]["sites"] == {} and res["kernels"] == {}
    cluster, bad = cs.byzantine_cluster(cs.ASYNC_N, 64, crypto_backend="cpu")
    assert cluster.config.f == 21 and len(bad) == 21
    kinds = [type(b).__name__ for b in cluster.behaviors.values()]
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "ShareForger": 4, "BadDealer": 4, "Equivocator": 4,
        "SplitVoter": 3, "SelectiveMute": 3, "EpochSprayer": 3,
    }


def test_byzantine_phase_on_the_cuda_path_with_its_twin():
    res = cs.byzantine_phase(torch, 1.0, n=7, batch=14, txs=28, device="cpu")
    rej = res["rejects"]
    assert rej["k6_false"] == rej["branch_false"] > 0
    assert rej["k8_calls_with_a_false_verdict"] > 0 and rej["cp_false"] > 0
    assert rej["k8_calls"] > 0 and rej["k6_calls"] > 0
