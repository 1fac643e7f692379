"""The cyclic collector around the port's lockstep epoch: ``run_epoch``
holds automatic collection while the epoch runs, ends it with one young
collection, and leaves the caller's collector as it found it.

Both arms run on the CPU: ``"cpu"`` (the native host engine) and
``"cuda"`` with ``device="cpu"`` (the kernels' plain PyTorch versions)."""

import gc
import weakref

import pytest
import torch

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster
from cleisthenes_tpu_torch.utils import trace

BACKENDS = ["cpu", "cuda"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _collector_restored():
    """Each test may turn the collector off or change its thresholds;
    the next test finds both as they were."""
    enabled, threshold = gc.isenabled(), gc.get_threshold()
    yield
    gc.set_threshold(*threshold)
    (gc.enable if enabled else gc.disable)()


def _cluster(n, backend, traced=False):
    cfg = Config(n=n, batch_size=8 * n, crypto_backend=backend, device="cpu", trace=traced)
    c = LockstepCluster(config=cfg, key_seed=7)
    for i in range(16 * n):
        c.submit(b"gc-tx-%05d" % i)
    return c


class _Collections:
    """A ``gc.callbacks`` hook: the generation of every collection that
    starts while it is installed."""

    def __init__(self):
        self.started = []

    def __call__(self, phase, info):
        if phase == "start":
            self.started.append(info["generation"])

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("enabled", [True, False], ids=["on", "off"])
def test_epoch_leaves_the_collector_as_it_found_it(backend, traced, enabled):
    c = _cluster(4, backend, traced)
    (gc.enable if enabled else gc.disable)()
    stats = c.run_epoch()
    assert gc.isenabled() is enabled
    assert stats["gc_paused"] == int(enabled)
    # and when a phase raises
    encrypt = c.tpke.encrypt
    seen = []

    def encrypt_w(msg, *a, **kw):
        seen.append(gc.isenabled())
        if len(seen) == 2:
            raise RuntimeError("planted")
        return encrypt(msg, *a, **kw)

    c.tpke.encrypt = encrypt_w
    hooks = list(gc.callbacks)
    with pytest.raises(RuntimeError, match="planted"):
        c.run_epoch()
    assert seen == [False, False]
    assert gc.isenabled() is enabled
    assert gc.callbacks == hooks and trace.ACTIVE is None


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_no_automatic_collection_before_the_boundary_one(backend, traced):
    c = _cluster(4, backend, traced)
    gc.enable()
    threshold = gc.get_threshold()
    with _Collections() as seen:
        gc.set_threshold(1, 1, 1)
        try:
            stats = c.run_epoch()
        finally:
            gc.set_threshold(*threshold)
    # the first collection the epoch let run is its own young one
    assert seen.started and seen.started[0] == 1
    assert stats["gc_paused"] == 1
    assert stats["gc_boundary_s"] >= 0.0
    if traced:
        assert stats["gc_collections"][1] >= 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_caller_without_collector_gets_no_collection(backend):
    c = _cluster(4, backend)
    gc.disable()
    with _Collections() as seen:
        stats = c.run_epoch()
    assert seen.started == []
    assert stats["gc_paused"] == 0 and stats["gc_boundary_s"] == 0.0
    assert not gc.isenabled()


class _Cyclic:
    pass


def _make_cycle():
    a, b = _Cyclic(), _Cyclic()
    a.peer, b.peer = b, a
    return weakref.ref(a)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_cycle_made_inside_the_epoch_is_dead_when_it_returns(backend, traced):
    c = _cluster(4, backend, traced)
    gc.enable()
    toss = c.coin.toss
    refs = []

    def toss_w(coin_id, shares):
        if not refs:
            refs.append(_make_cycle())
        return toss(coin_id, shares)

    c.coin.toss = toss_w
    c.run_epoch()
    assert len(refs) == 1 and refs[0]() is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_collector_held_or_not_commits_the_same_bytes(backend):
    on, off = _cluster(7, backend), _cluster(7, backend)
    for _ in range(2):
        gc.enable()
        s_on = on.run_epoch()
        gc.disable()
        s_off = off.run_epoch()
        assert (s_on["gc_paused"], s_off["gc_paused"]) == (1, 0)
        assert s_on["bba_rounds"] == s_off["bba_rounds"]
        assert s_on["coin_useful"] == s_off["coin_useful"]
    assert [x.contributions for x in on.committed_batches] == [
        x.contributions for x in off.committed_batches]
