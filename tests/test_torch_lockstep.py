"""The port's LockstepCluster (cleisthenes_tpu_torch.protocol.spmd)
against the JAX package's, epoch for epoch.

Both get the same key seed and the same submissions; the reference runs
with its 'cpu' and 'tpu' backends (JAX on the CPU), the port with
'cuda' on a CPU device (the kernels' plain PyTorch versions) and 'cpu'.
Committed batches and BBA round counts must be identical: the coin is a
deterministic threshold VUF of the dealt keys, and the commit rule is
the same.  Share bytes are not compared — CP nonces and TPKE randomness
come from ``secrets``."""

import functools

import pytest
import torch

from cleisthenes_tpu.protocol.spmd import LockstepCluster as RefCluster
from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster

# (n, batch_size, transactions, epochs)
SHAPES = {4: (64, 192, 3), 16: (256, 256, 1)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain modexp versions are ~20 small int64 ops per Montgomery
    product: intra-op threads only add contention (the suite runs
    several workers on the same cores), so these tests run on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tx(i: int) -> bytes:
    return b"torch-spmd-tx-%06d" % i


def _committed(c) -> set:
    out = set()
    for b in c.committed():
        out.update(b.tx_list())
    return out


def _run(cluster, n):
    batch, total, epochs = SHAPES[n]
    for i in range(total):
        cluster.submit(_tx(i))
    rounds = [cluster.run_epoch()["bba_rounds"] for _ in range(epochs)]
    return [b.contributions for b in cluster.committed_batches], rounds


@functools.lru_cache(maxsize=None)
def _reference(n, backend):
    batch = SHAPES[n][0]
    return _run(
        RefCluster(n=n, batch_size=batch, crypto_backend=backend, key_seed=21),
        n,
    )


@pytest.mark.parametrize("n", sorted(SHAPES))
@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_lockstep_matches_reference(n, backend):
    batch = SHAPES[n][0]
    ours = _run(
        LockstepCluster(
            n=n, batch_size=batch, crypto_backend=backend, device="cpu",
            key_seed=21,
        ),
        n,
    )
    committed, rounds = ours
    assert committed == _reference(n, "cpu")[0] == _reference(n, "tpu")[0]
    assert rounds == _reference(n, "cpu")[1] == _reference(n, "tpu")[1]
    assert sum(len(v) for c in committed for v in c.values()) == min(
        SHAPES[n][1], SHAPES[n][2] * max(batch, n) // n * n
    )


def test_lockstep_commits_all_txs():
    c = LockstepCluster(n=4, batch_size=64, key_seed=3, device="cpu")
    for i in range(128):
        c.submit(_tx(i))
    epochs = c.run_epochs()
    assert _committed(c) == {_tx(i) for i in range(128)}
    assert epochs == len(c.committed())
    assert c.pending_tx_count() == 0


def test_lockstep_multi_epoch_dedup_and_order():
    """Committed batches dedupe across proposers like the live commit
    rule; epochs drain queues in order."""
    c = LockstepCluster(n=4, batch_size=16, key_seed=2, device="cpu")
    c.submit(b"dup-tx", node_id=c.ids[0])
    c.submit(b"dup-tx", node_id=c.ids[1])
    c.run_epoch()
    batch = c.committed()[0]
    assert list(batch.tx_list()).count(b"dup-tx") == 1


def test_lockstep_stats_and_backend_routing():
    c = LockstepCluster(n=4, batch_size=16, key_seed=1, device="cpu")
    assert c.config.crypto_backend == "cuda"
    assert c.crypto.engine_backend == "cuda"  # modexp on the card's kernels
    assert c.crypto.device == torch.device("cpu")
    assert type(c.crypto.merkle).__name__ == "CudaMerkle"
    for i in range(16):
        c.submit(_tx(i))
    s = c.run_epoch()
    assert s["dec_issues"] == 16
    assert s["coin_issues"] >= 16 and s["bba_rounds"] >= 1


def test_lockstep_serial_coin_blocks_match_doubling():
    """The coin-block schedule changes batching only: same commits and
    round counts (the shares are deterministic VUFs)."""
    a = LockstepCluster(n=5, batch_size=40, key_seed=9, device="cpu")
    b = LockstepCluster(
        n=5, batch_size=40, key_seed=9, device="cpu", coin_block_doubling=False
    )
    for i in range(80):
        a.submit(_tx(i))
        b.submit(_tx(i))
    a.run_epochs()
    b.run_epochs()
    assert _committed(a) == _committed(b) == {_tx(i) for i in range(80)}
    assert a.last_stats["bba_rounds"] == b.last_stats["bba_rounds"]
    assert b.last_stats["coin_waves"] == b.last_stats["bba_rounds"]


def test_lockstep_reconfig_boundary():
    """Roster swap between epochs: history continuous, every tx once,
    the retiring node's pending txs failed over, keys rotated."""
    c = LockstepCluster(n=4, batch_size=16, key_seed=21, device="cpu")
    for i in range(32):
        c.submit(_tx(i))
    pre_epochs = c.run_epochs()
    pub0 = c.tpke.pub.master
    c.submit(_tx(900), node_id="node000")
    c.reconfigure(join=["node100"], retire=["node000"])
    assert c.ids == ["node001", "node002", "node003", "node100"]
    assert c.config.n == 4 and c.config.f == 1 and c.config.device == "cpu"
    assert c.tpke.pub.master != pub0
    for i in range(32, 48):
        c.submit(_tx(i))
    c.run_epochs()
    assert _committed(c) == {_tx(i) for i in range(48)} | {_tx(900)}
    assert len(c.committed()) > pre_epochs


def test_lockstep_reduced_quorum_roster():
    """n=5 with f=2 (one data shard, a padded 8-leaf forest) commits
    everything on the port's kernels' plain versions."""
    from cleisthenes_tpu_torch.config import Config

    c = LockstepCluster(
        n=5,
        config=Config(
            n=5, batch_size=16, attested_log=True, reduced_quorum=True,
            device="cpu",
        ),
        key_seed=23,
    )
    assert c.config.f == 2 and c.config.data_shards == 1
    for i in range(20):
        c.submit(_tx(i))
    c.run_epochs()
    assert _committed(c) == {_tx(i) for i in range(20)}
