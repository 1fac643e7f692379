# The reference's tests/test_semantic_byzantine.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""Semantic Byzantine adversary tests: key-holding nodes that follow
the rules of the wire but not the protocol (protocol.byzantine).

Every frame these adversaries emit carries a valid pairwise MAC — the
transport delivers all of it — and the lies differ PER RECEIVER:
conflicting RBC proposals (Equivocator), split BVAL/AUX votes
(SplitVoter), structurally-valid wrong shards (BadDealer), well-formed
wrong threshold shares (ShareForger), per-link silence (SelectiveMute)
and epoch-window spam (EpochSprayer).  The assertion is always HBBFT's
own contract: the honest majority commits identical ledger prefixes,
on the in-proc channel transport AND over real gRPC.

Module carries the ``faults`` marker (ci.sh fault-regression stage).
"""

import threading

import pytest

from cleisthenes_tpu_torch.protocol.byzantine import (
    BEHAVIOR_KINDS,
    CompositeBehavior,
    EpochSprayer,
    Equivocator,
    SelectiveMute,
    ShareForger,
    make_behavior,
)
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster
from cleisthenes_tpu_torch.utils.adversary import Coalition

pytestmark = pytest.mark.faults

SEMANTIC_KINDS = ("equivocator", "split_voter", "bad_dealer")


def drive(cluster, bad, txs=12, max_rounds=30):
    """Submit txs to honest nodes, drain, and return the agreed depth
    (assert_agreement == identical ledger prefixes among the honest)."""
    honest = [i for i in cluster.ids if i not in bad]
    for i in range(txs):
        cluster.submit(b"tx-%04d" % i, node_id=honest[i % len(honest)])
    cluster.run_until_drained(max_rounds=max_rounds, skip=bad)
    return cluster.assert_agreement(skip=bad)


def assert_only_submitted(cluster, bad):
    """No behavior here injects well-formed ciphertexts, so every
    committed tx must be one the test submitted."""
    for nid in cluster.ids:
        if nid in bad:
            continue
        for batch in cluster.nodes[nid].committed_batches:
            for tx in batch.tx_list():
                assert tx.startswith(b"tx-"), tx


@pytest.mark.parametrize("kind", SEMANTIC_KINDS)
@pytest.mark.parametrize(
    "n,bad",
    [(4, ("node003",)), (7, ("node005", "node006"))],
    ids=["n4f1", "n7f2"],
)
def test_semantic_coalition_channel_transport(kind, n, bad):
    """Equivocator / split-voter / bad-dealer coalitions at full fault
    budget: honest nodes commit identical ledger prefixes and every
    behavior actually told lies (rewrites > 0)."""
    behaviors = {
        b: make_behavior(kind, seed=11 + i) for i, b in enumerate(bad)
    }
    c = SimulatedCluster(
        n=n, batch_size=8, seed=3, behaviors=behaviors, crypto_backend="cpu"
    )
    depth = drive(c, bad)
    assert depth >= 1
    assert_only_submitted(c, bad)
    for b in c.behaviors.values():
        assert b.rewrites > 0, "the adversary never actually lied"


def test_share_forger_burns_and_still_commits():
    """Forged (well-formed, wrong) coin + TPKE shares: the batched CP
    verification burns them, replacements flow, every honest node
    commits identically AND completely — the liveness-critical share
    attack (arxiv 2407.12172's withholding/forgery class)."""
    bad = ("node000",)  # sorts first: forged shares land early in pools
    c = SimulatedCluster(
        n=4,
        batch_size=8,
        seed=9,
        behaviors={"node000": ShareForger(seed=5)},
        crypto_backend="cpu",
    )
    depth = drive(c, bad)
    assert depth >= 1
    assert c.behaviors["node000"].rewrites > 0
    committed = sum(
        len(b) for b in c.nodes["node001"].committed_batches
    )
    assert committed == 12  # liveness: every submitted tx committed


def test_selective_mute_and_sprayer_composed_with_wire_faults():
    """CompositeBehavior(SelectiveMute + EpochSprayer) on one node,
    stacked with a wire-level drop/reorder coalition on the SAME node:
    the semantic and wire planes compose without breaking agreement."""
    bad = ("node003",)
    behavior = CompositeBehavior(
        [SelectiveMute(seed=3), EpochSprayer(seed=4, every=8)]
    )
    c = SimulatedCluster(
        n=4,
        batch_size=8,
        seed=7,
        behaviors={"node003": behavior},
        crypto_backend="cpu",
    )
    c.fault_filter = (
        Coalition(["node003"], seed=7).drop(0.2).reorder(0.3).filter
    )
    depth = drive(c, bad)
    assert depth >= 1
    assert_only_submitted(c, bad)
    assert behavior.rewrites > 0


def test_equivocator_splits_roster_but_never_forks():
    """The canonical equivocation check, explicitly: the equivocating
    proposer's two proposals never BOTH commit — honest nodes agree on
    one value for its instance or exclude it entirely."""
    bad = "node000"  # the lowest-sorting proposer equivocates
    c = SimulatedCluster(
        n=4,
        batch_size=8,
        seed=13,
        behaviors={bad: Equivocator(seed=21)},
        crypto_backend="cpu",
    )
    depth = drive(c, (bad,))
    assert depth >= 1
    # per-epoch: the bad proposer's contribution (if any) is identical
    # across every honest node — assert_agreement checked bytes; here
    # we check the instance-level view for the equivocator's slot
    for e in range(depth):
        views = {
            tuple(
                c.nodes[nid].committed_batches[e].contributions.get(
                    bad, ()
                )
            )
            for nid in c.ids[1:]
        }
        assert len(views) == 1, f"equivocator forked epoch {e}"


def test_behavior_registry_round_trip():
    """Every registered kind constructs from its JSON-schedule name
    (the tools/fuzz.py repro path) and rejects unknown kinds."""
    for kind in sorted(BEHAVIOR_KINDS):
        b = make_behavior(kind, seed=3)
        assert b.seed == 3
    with pytest.raises(ValueError, match="unknown behavior"):
        make_behavior("nonsense", seed=0)


def _run_grpc_cluster(n, behaviors, txs=8, key_seed=55):
    """n validators over localhost gRPC, semantic behaviors mounted via
    the ValidatorHost seam; returns {node_id: first committed batch}
    for the honest members."""
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.protocol.honeybadger import setup_keys
    from cleisthenes_tpu_torch.transport.host import ValidatorHost

    cfg = Config(crypto_backend="cpu", n=n, batch_size=8)
    ids = [f"node{i}" for i in range(n)]
    keys = setup_keys(cfg, ids, seed=key_seed)
    hosts = {
        i: ValidatorHost(cfg, i, ids, keys[i], behavior=behaviors.get(i))
        for i in ids
    }
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
        honest = [i for i in ids if i not in behaviors]
        for i in range(txs):
            hosts[honest[i % len(honest)]].submit(b"tx-%04d" % i)
        for h in hosts.values():
            h.propose()
        first = {i: hosts[i].wait_commit(timeout=60) for i in honest}
        # the transport counters are reachable through public metrics
        # on this transport too (GrpcServer.stats + pool connections)
        transport = hosts[honest[0]].node.metrics.snapshot()["transport"]
        return first, transport
    finally:
        for h in hosts.values():
            h.stop()


@pytest.mark.parametrize("kind", SEMANTIC_KINDS)
def test_semantic_coalition_over_grpc_n4(kind):
    """(n=4, f=1) semantic coalitions over REAL gRPC streams: honest
    hosts commit the identical first batch — the transport-independence
    half of the 'both transports' contract."""
    first, transport = _run_grpc_cluster(
        4, {"node3": make_behavior(kind, seed=17)}
    )
    epochs = {e for e, _ in first.values()}
    assert epochs == {0}
    lists = [b.tx_list() for _, b in first.values()]
    assert all(l == lists[0] for l in lists)
    assert len(lists[0]) > 0
    assert all(tx.startswith(b"tx-") for tx in lists[0])
    assert transport["delivered"] > 0
    assert transport["rejected"] == 0  # lies were valid frames


@pytest.mark.slow
@pytest.mark.parametrize("kind", SEMANTIC_KINDS)
def test_semantic_coalition_over_grpc_n7(kind):
    """(n=7, f=2) over real gRPC — the full-budget variant, in the
    slow tier (7 hosts x threads x sockets)."""
    behaviors = {
        "node5": make_behavior(kind, seed=17),
        "node6": make_behavior(kind, seed=18),
    }
    first, _transport = _run_grpc_cluster(7, behaviors, txs=10)
    epochs = {e for e, _ in first.values()}
    assert epochs == {0}
    lists = [b.tx_list() for _, b in first.values()]
    assert all(l == lists[0] for l in lists)
    assert len(lists[0]) > 0
