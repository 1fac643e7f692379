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

import numpy as np
import pytest
import torch

from cleisthenes_tpu.protocol.spmd import LockstepCluster as RefCluster
from cleisthenes_tpu_torch.protocol.cluster import SimulatedCluster
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


# rosters past the GF(2^8) ceiling and the 384-bit group:
# (n, batch_size, transactions, epochs, group, key_seed)
WIDE_SHAPES = {
    "n257": (257, 257, 257, 1, None, 13),
    "g384": (4, 64, 192, 3, "GROUP384", 21),
}


@functools.lru_cache(maxsize=None)
def _reference_wide(case):
    from cleisthenes_tpu.ops import modmath as ref_mm

    n, batch, total, epochs, group, seed = WIDE_SHAPES[case]
    c = RefCluster(
        n=n, batch_size=batch, crypto_backend="cpu", key_seed=seed,
        group=group and getattr(ref_mm, group),
    )
    for i in range(total):
        c.submit(_tx(i))
    rounds = [c.run_epoch()["bba_rounds"] for _ in range(epochs)]
    return [b.contributions for b in c.committed_batches], rounds


@pytest.mark.parametrize(
    "case,backend",
    [("n257", "cpu"), ("n257", "cuda-codec"), ("g384", "cuda"), ("g384", "cpu")],
)
def test_lockstep_matches_reference_wide(case, backend):
    """n=257 (the port of test_spmd.py's
    test_lockstep_roster_past_gf256_ceiling: the GF(2^16) codec, a
    512-leaf forest, f=85) and a GROUP384 roster (the 384-bit family on
    the 'cuda' engine) commit the reference's batches in the reference's
    round counts.  n=257 keeps the 'cpu' modexp engine: its ~400k
    exponentiations a round are far beyond the plain modexp versions on
    a CPU.  Its 'cuda-codec' case swaps in the 'cuda' GF(2^16) codec
    (K11's plain version on a CPU device, delivery in three steps)."""
    from cleisthenes_tpu_torch.ops import modmath as mm
    from cleisthenes_tpu_torch.ops.backend import make_erasure_coder
    from cleisthenes_tpu_torch.ops.rs16 import Cuda16ErasureCoder

    n, batch, total, epochs, group, seed = WIDE_SHAPES[case]
    codec = backend == "cuda-codec"
    c = LockstepCluster(
        n=n, batch_size=batch, crypto_backend="cpu" if codec else backend,
        device="cpu", key_seed=seed, group=group and getattr(mm, group),
    )
    if codec:
        c.crypto.erasure = make_erasure_coder("cuda", n, c.crypto.k, device="cpu")
        assert isinstance(c.crypto.erasure, Cuda16ErasureCoder)
        idx = np.tile(np.arange(c.crypto.k), (2, 1))
        shards = np.zeros((2, c.crypto.k, 128), dtype=np.uint8)
        assert c.crypto.decode_recheck_batch(idx, shards)[2] == 3
    if n > 256:
        assert c.crypto.erasure.MAX_N == 1 << 16
    if group:
        assert c.tpke.group is mm.GROUP384
        eng = mm.get_engine_degraded(backend, mm.GROUP384, device="cpu")
        assert eng.backend == backend  # no silent fallback to the host
    for i in range(total):
        c.submit(_tx(i))
    rounds = [c.run_epoch()["bba_rounds"] for _ in range(epochs)]
    committed = [b.contributions for b in c.committed_batches]
    assert (committed, rounds) == _reference_wide(case)
    assert {tx for b in c.committed() for tx in b.tx_list()} == {
        _tx(i) for i in range(total)
    }


def test_lockstep_commits_all_txs():
    c = LockstepCluster(n=4, batch_size=64, key_seed=3, device="cpu")
    for i in range(128):
        c.submit(_tx(i))
    epochs = c.run_epochs()
    assert _committed(c) == {_tx(i) for i in range(128)}
    assert epochs == len(c.committed())
    assert c.pending_tx_count() == 0


def test_lockstep_matches_message_passing_cluster():
    """The flagship equivalence check: lockstep vs the full async path
    (the port's SimulatedCluster), both on the kernels' plain versions."""
    n, batch, total = 4, 64, 256
    lock = LockstepCluster(n=n, batch_size=batch, key_seed=11, device="cpu")
    sim = SimulatedCluster(
        n=n, batch_size=batch, key_seed=11, seed=5, device="cpu"
    )
    for i in range(total):
        lock.submit(_tx(i))
        sim.submit(_tx(i))
    lock.run_epochs()
    sim.run_epochs()
    lock_txs = _committed(lock)
    sim_txs = {tx for b in sim.committed("node000") for tx in b.tx_list()}
    assert lock_txs == sim_txs == {_tx(i) for i in range(total)}


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


def test_lockstep_aggressive_initial_block_matches():
    """coin_block_initial=4 (the aggressive first block) changes
    dispatch batching only: committed transactions and round counts
    are identical to the default schedule."""
    a = LockstepCluster(n=5, batch_size=40, key_seed=9, device="cpu")
    b = LockstepCluster(
        n=5, batch_size=40, key_seed=9, device="cpu", coin_block_initial=4
    )
    for i in range(80):
        a.submit(_tx(i))
        b.submit(_tx(i))
    a.run_epochs()
    b.run_epochs()
    assert _committed(a) == _committed(b) == {_tx(i) for i in range(80)}
    assert a.last_stats["bba_rounds"] == b.last_stats["bba_rounds"]
    assert b.last_stats["coin_waves"] <= a.last_stats["coin_waves"]


def test_lockstep_conflicting_config_rejected():
    from cleisthenes_tpu_torch.config import Config

    with pytest.raises(ValueError):
        LockstepCluster(n=7, config=Config(n=4, batch_size=16, device="cpu"))


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
