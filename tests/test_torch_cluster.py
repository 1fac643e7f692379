# The reference's tests/test_cluster.py, re-pointed at cleisthenes_tpu_torch:
# the host backend ('cpu') where the reference took its default, and
# 'cuda' on device='cpu' (the kernels' plain versions) where it says 'tpu'.
"""SimulatedCluster API + shared-hub regression tests."""

import os

import numpy as np
import pytest

from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster
from cleisthenes_tpu_torch.utils.adversary import Coalition


def test_cluster_basic_commit():
    c = SimulatedCluster(4, batch_size=8, crypto_backend="cpu")
    txs = [b"ct-%02d" % i for i in range(12)]
    for tx in txs:
        c.submit(tx)
    rounds = c.run_epochs()
    assert rounds >= 1
    depth = c.assert_agreement()
    committed = [tx for b in c.committed()[:depth] for tx in b.tx_list()]
    assert sorted(committed) == sorted(txs)
    # the shared hub really is shared and dispatch counts are cluster-wide
    hubs = {id(hb.hub) for hb in c.nodes.values()}
    assert len(hubs) == 1


def test_cluster_per_node_hubs_equivalent():
    a = SimulatedCluster(4, batch_size=8, shared_hub=True, seed=3, crypto_backend="cpu")
    b = SimulatedCluster(4, batch_size=8, shared_hub=False, seed=3, crypto_backend="cpu")
    for c in (a, b):
        for i in range(8):
            c.submit(b"eq-%02d" % i)
        c.run_epochs()
        c.assert_agreement()
    # identical committed tx sets regardless of hub topology
    sa = {tx for bt in a.committed() for tx in bt.tx_list()}
    sb = {tx for bt in b.committed() for tx in bt.tx_list()}
    assert sa == sb


def test_cluster_byzantine_and_crash():
    c = SimulatedCluster(7, batch_size=8, seed=11, crypto_backend="cpu")
    c.fault_filter = Coalition(["node005"], seed=11).drop(0.4).tamper(0.4).filter
    c.crash("node006")
    for i in range(14):
        c.submit(b"bz-%02d" % i, node_id=c.ids[i % 5])  # only live nodes
    c.run_epochs(skip=("node006",))
    c.assert_agreement(skip=("node005", "node006"))


def test_shared_hub_epoch_gc_is_node_scoped():
    """Regression for the node-qualified hub scopes: one node advancing
    epochs (and GC'ing its old epoch scope) must not unregister a
    slower peer's hub clients for the same epoch number."""
    c = SimulatedCluster(4, batch_size=4, crypto_backend="cpu")
    for i in range(16):
        c.submit(b"gc-%02d" % i)
    c.run_epochs()
    depth = c.assert_agreement()
    assert depth >= 2  # multiple epochs actually ran and GC'd
    hub = c.nodes[c.ids[0]].hub
    # after quiescence: only live-window scopes remain; every remaining
    # scope is node-qualified (node_id, epoch-or-tag)
    for scope in hub._clients:
        assert isinstance(scope, tuple) and scope[0] in c.nodes


@pytest.mark.skipif(
    os.environ.get("RUN_SLOW") != "1",
    reason="~3 min memory soak (RUN_SLOW=1 to enable)",
)
def test_cluster_memory_soak():
    """30 epochs over one cluster: RSS must plateau after warm-up —
    the dedup memos, payload memo, parked-message buffers, and epoch
    GC are all bounded (caps + drop_scope eviction)."""
    import gc
    import resource

    c = SimulatedCluster(n=8, batch_size=64, seed=4, crypto_backend="cpu")

    def rss_mb():
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024

    base = None
    for burst in range(6):
        for i in range(64 * 5):
            c.submit(b"soak-%d-%05d" % (burst, i))
        c.run_epochs()
        gc.collect()
        if burst == 1:
            base = rss_mb()
    assert sum(len(b) for b in c.committed()) == 64 * 5 * 6
    assert rss_mb() - base < 120, "unbounded growth across epochs"
