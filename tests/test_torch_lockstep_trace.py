"""The port's LockstepCluster under its own flight recorder
(``Config.trace``): what a traced epoch records, that an untraced one
records nothing and leaves no hook behind, and that tracing changes no
committed byte.  Also the epoch whose proposals differ in shard width.

Both arms run on the CPU: ``"cpu"`` (the native host engine) and
``"cuda"`` with ``device="cpu"`` (the kernels' plain PyTorch versions,
which take the engine's pack, device and unpack path)."""

import gc

import pytest
import torch

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster
from cleisthenes_tpu_torch.utils import trace

BACKENDS = ["cpu", "cuda"]
# the spans whose time the BBA split reads apart from the spans around them
MEASURED = ("coin.issue", "coin.challenge", "coin.verify")
PHASES = ("propose", "rbc_encode", "rbc_verify", "rbc_decode", "bba", "decrypt", "commit")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cluster(n, backend, traced, key_seed=5):
    cfg = Config(n=n, batch_size=8 * n, crypto_backend=backend, device="cpu", trace=traced)
    c = LockstepCluster(config=cfg, key_seed=key_seed)
    for i in range(16 * n):
        c.submit(b"trace-tx-%05d" % i)
    return c


def _spans(c):
    return [(f"{e[3]}.{e[4]}", e[1], e[1] + e[2], e[5]) for e in c.recorder.events()
            if e[2] is not None]


def _union(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _inside(outer, spans, pred):
    return [(max(outer[1], s[1]), min(outer[2], s[2])) for s in spans
            if s is not outer and pred(s[0]) and min(outer[2], s[2]) > max(outer[1], s[1])]


def _measured(name):
    return name in MEASURED or name.startswith("engine.")


def _self(outer, spans):
    return outer[2] - outer[1] - _union(_inside(outer, spans, _measured))


@pytest.fixture(scope="module", params=[(b, n) for b in BACKENDS for n in (4, 7)],
                ids=lambda p: f"{p[0]}-n{p[1]}")
def traced(request):
    """Two traced epochs of one cluster: (cluster, [(stats, spans)])."""
    backend, n = request.param
    c = _cluster(n, backend, True)
    out = []
    for _ in range(2):
        before = len(c.recorder.events())
        stats = c.run_epoch()
        evs = c.recorder.events()[before:]
        out.append((stats, [(f"{e[3]}.{e[4]}", e[1], e[1] + e[2], e[5]) for e in evs]))
    return c, out


@pytest.mark.parametrize("backend", BACKENDS)
def test_untraced_epoch_has_no_recorder_binding_or_hook(backend):
    c = _cluster(4, backend, False)
    assert c.recorder is None
    seen = []
    toss = c.coin.toss

    def toss_w(coin_id, shares):
        seen.append(trace.ACTIVE)
        return toss(coin_id, shares)

    c.coin.toss = toss_w
    hooks = list(gc.callbacks)
    stats = c.run_epoch()
    assert seen and all(a is None for a in seen)
    assert trace.ACTIVE is None
    assert gc.callbacks == hooks
    assert "gc_s" not in stats and "gc_collections" not in stats
    assert stats["gc_paused"] == int(gc.isenabled())
    assert "coin_verifies" not in stats and "dec_fused" not in stats
    assert 0 < stats["coin_useful"] <= stats["coin_issues"]


def test_phase_spans_partition_the_epoch(traced):
    _c, epochs = traced
    for stats, spans in epochs:
        phases = {s[0]: s for s in spans if s[0].startswith("epoch.")}
        assert sorted(phases) == sorted("epoch." + p for p in PHASES)
        covered = sum(s[2] - s[1] for s in phases.values())
        assert covered >= 0.99 * stats["epoch_s"]
        for p in PHASES:
            s = phases["epoch." + p]
            assert abs((s[2] - s[1]) - stats[p + "_s"]) < 1e-6
            assert s[3] == {"epoch": s[3]["epoch"]}
        ends = sorted((s[1], s[2]) for s in phases.values())
        for (a0, a1), (b0, _b1) in zip(ends, ends[1:]):
            assert a1 == b0  # each phase ends where the next begins


def test_child_spans_lie_inside_their_parents(traced):
    _c, epochs = traced
    parents = {
        "bba.wave": ("epoch.bba",),
        "tpke.items": ("epoch.bba",),
        "coin.items": ("bba.wave",),
        "coin.issue": ("bba.wave",),
        "coin.verify": ("bba.wave",),
        "coin.toss": ("bba.wave",),
        "coin.challenge": ("coin.issue", "coin.verify"),
        "engine.pack": ("coin.issue", "coin.verify"),
        "engine.device": ("coin.issue", "coin.verify"),
        "engine.unpack": ("coin.issue", "coin.verify"),
        "tpke.kem": ("epoch.propose",),
        "tpke.stream": ("epoch.propose",),
    }
    for _stats, spans in epochs:
        names = {s[0] for s in spans}
        assert {"bba.wave", "coin.issue", "coin.challenge", "coin.verify", "tpke.kem"} <= names
        assert set(parents) | {"epoch." + p for p in PHASES} >= names - {"gc.full"}
        for s in spans:
            if s[0] not in parents:
                continue
            assert any(p[0] in parents[s[0]] and p[1] <= s[1] and s[2] <= p[2] for p in spans), s


def test_bba_parts_add_up_to_bba_s(traced):
    """The four BBA host parts (self times of ``epoch.bba``, ``coin.issue``
    and ``coin.verify``, and every ``coin.challenge``) plus the engine's
    spans inside ``epoch.bba`` make ``bba_s``."""
    _c, epochs = traced
    for stats, spans in epochs:
        (bba,) = [s for s in spans if s[0] == "epoch.bba"]
        parts = _self(bba, spans)
        parts += sum(_self(s, spans) for s in spans if s[0] in ("coin.issue", "coin.verify"))
        parts += sum(s[2] - s[1] for s in spans if s[0] == "coin.challenge")
        parts += _union(_inside(bba, spans, lambda n: n.startswith("engine.")))
        assert abs(parts - stats["bba_s"]) <= 0.03 * stats["bba_s"]


def test_span_args_carry_the_epoch_counts(traced):
    c, epochs = traced
    n, f = c.config.n, c.config.f
    for e, (stats, spans) in enumerate(epochs):
        def args(name):
            return [s[3] for s in spans if s[0] == name]

        assert sum(a["items"] for a in args("coin.items")) == stats["coin_issues"]
        assert sum(a["metas"] for a in args("coin.items")) * n == stats["coin_issues"]
        assert [a["items"] for a in args("tpke.items")] == [stats["dec_issues"]]
        issued = stats["coin_issues"] + stats["dec_issues"]
        assert sum(a["items"] for a in args("coin.issue")) == issued
        waves = args("bba.wave")
        assert [a["wave"] for a in waves] == list(range(stats["coin_waves"]))
        assert {a["epoch"] for a in waves} == {e}
        assert [a["dec"] for a in waves] == [True] + [False] * (len(waves) - 1)
        assert sum(a["rounds"] for a in waves) >= stats["bba_rounds"]
        tosses = [a["rounds"] * a["instances"] for a in waves]
        assert [a["tosses"] for a in args("coin.toss")] == tosses
        assert sum(a["shares"] for a in args("coin.verify")) == (f + 1) * stats["coin_issues"] // n
        assert sum(a["combines"] + a["memo_hits"] for a in args("coin.verify")) == (
            stats["coin_issues"] // n + n)
        assert len(args("tpke.kem")) == len(args("tpke.stream")) == n
        assert 0 < stats["coin_useful"] <= stats["coin_issues"]
        assert stats["gc_s"] >= 0.0 and len(stats["gc_collections"]) == 3
        # the epoch's closing young collection is the collector's hook's too
        assert stats["gc_paused"] == 1 and stats["gc_collections"][1] >= 1
        if c.crypto.engine_backend == "cuda":
            packs = args("engine.pack")
            assert packs and len(packs) == len(args("engine.device")) == len(args("engine.unpack"))
            assert all(not a["pinned"] and a["bytes_out"] > 0 for a in args("engine.device"))
        else:
            assert not args("engine.pack")
    assert c.recorder.stats()["events_dropped"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_full_collection_inside_a_traced_epoch_is_a_span(backend):
    c = _cluster(4, backend, True)
    toss = c.coin.toss
    done = []

    def toss_w(coin_id, shares):
        if not done:
            done.append(gc.collect())
        return toss(coin_id, shares)

    c.coin.toss = toss_w
    hooks = list(gc.callbacks)
    stats = c.run_epoch()
    assert gc.callbacks == hooks and trace.ACTIVE is None
    assert stats["gc_collections"][2] >= 1 and stats["gc_s"] > 0
    full = [s for s in _spans(c) if s[0] == "gc.full"]
    (bba,) = [s for s in _spans(c) if s[0] == "epoch.bba"]
    assert full and all(bba[1] <= s[1] and s[2] <= bba[2] for s in full)
    assert all(isinstance(s[3]["collected"], int) for s in full)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tracing_changes_no_committed_byte(backend):
    a, b = _cluster(7, backend, False), _cluster(7, backend, True)
    for _ in range(2):
        sa, sb = a.run_epoch(), b.run_epoch()
        assert sa["bba_rounds"] == sb["bba_rounds"]
        assert sa["coin_useful"] == sb["coin_useful"]
    assert [x.contributions for x in a.committed_batches] == [
        x.contributions for x in b.committed_batches]


def test_recorder_and_profiler_clocks_map_by_anchors():
    """Program-clock reads around a profiler span's start anchor the
    recorder's clock onto ``torch.profiler``'s timeline: a recorder span
    and a ``record_function`` span opened back to back then land within
    2 ms of each other."""
    from torch.profiler import ProfilerActivity, profile, record_function

    rec = trace.TraceRecorder("anchor")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        before = rec.now()
        anchor = record_function("anchor")
        anchor.__enter__()
        after = rec.now()
        sum(range(20000))
        t0 = rec.now()
        with record_function("probe"):
            sum(range(200000))
        rec.complete("probe", "probe", t0)
        anchor.__exit__(None, None, None)
    starts = {e.name: (e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name in ("anchor", "probe")}
    offset = (before + after) / 2 - starts["anchor"][0] / 1e6
    (ev,) = rec.events()
    start_us = (ev[1] - offset) * 1e6
    end_us = (ev[1] + ev[2] - offset) * 1e6
    assert abs(start_us - starts["probe"][0]) < 2000
    assert abs(end_us - starts["probe"][1]) < 2000


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("key_seed", [1, 2, 3, 4])
def test_epoch_of_mixed_proposal_widths_commits(backend, key_seed):
    """One proposer's two 180-byte transactions fill shards of 256 bytes,
    the others' two 250-byte ones shards of 384: each proposal is read
    back over its own width and every transaction commits once."""
    c = LockstepCluster(n=4, batch_size=8, crypto_backend=backend, device="cpu",
                        key_seed=key_seed)
    txs = []
    for t in range(2):
        for j, nid in enumerate(c.ids):
            tx = bytes([j, t]) + bytes(range(256))[: (180 if j == 0 else 250) - 2]
            txs.append(tx)
            c.submit(tx, nid)
    from cleisthenes_tpu_torch.ops.payload import split_payload

    widths = set()
    encrypt = c.tpke.encrypt

    def encrypt_w(msg, *a, **kw):
        ct = encrypt(msg, *a, **kw)
        from cleisthenes_tpu_torch.protocol.keys import serialize_ciphertext

        widths.add(split_payload(serialize_ciphertext(ct, c.tpke.group),
                                 c.config.data_shards).shape[1])
        return ct

    c.tpke.encrypt = encrypt_w
    c.run_epoch()
    assert len(widths) == 2
    got = c.committed()[0].tx_list()
    assert sorted(got) == sorted(txs)
