"""Reading the program's spans: self times, drops, the clock anchors and
the idle attribution over both sets of spans, on synthetic events; and
the split of one real traced epoch on the CPU."""

import pytest

from hbbench import progtrace, trace


def ev(seq, name, t0, t1, **args):
    cat, nm = name.split(".", 1)
    return (seq, t0, t1 - t0, cat, nm, args)


# one epoch: bba [10, 20] holds a wave whose issue [11, 15] holds a
# challenge [13, 14] and the engine's pack/device/unpack [11.5, 12.5];
# the verify [15, 18] holds a challenge [17, 18] and an engine call
# [15.5, 16.5]; a full collection [12, 12.2] interrupts the engine's leg
EPOCH = [
    ev(1, "tpke.items", 10.0, 10.5),
    ev(2, "coin.items", 10.5, 11.0),
    ev(3, "engine.pack", 11.5, 11.75),
    ev(4, "engine.device", 11.75, 12.25),
    ev(5, "engine.unpack", 12.25, 12.5),
    ev(6, "coin.challenge", 13.0, 14.0, rows=8),
    ev(7, "coin.issue", 11.0, 15.0, items=8),
    ev(8, "engine.pack", 15.5, 15.75),
    ev(9, "engine.device", 15.75, 16.25),
    ev(10, "engine.unpack", 16.25, 16.5),
    ev(11, "coin.challenge", 17.0, 18.0, rows=4),
    ev(12, "coin.verify", 15.0, 18.0, shares=4, combines=2, memo_hits=0),
    ev(13, "coin.toss", 18.0, 19.0, tosses=2),
    ev(14, "bba.wave", 10.5, 19.0, epoch=0, wave=0, rounds=1, instances=2, dec=True),
    ev(15, "epoch.bba", 10.0, 20.0, epoch=0),
    ev(16, "tpke.kem", 1.0, 1.5),
    ev(17, "tpke.stream", 1.5, 2.0, bytes=100),
    ev(18, "epoch.propose", 1.0, 3.0, epoch=0),
    ev(19, "gc.full", 12.0, 12.2, collected=3),
]


def test_self_time_leaves_out_measured_spans_and_keeps_the_collector():
    ss = progtrace.spans(EPOCH)
    split = progtrace.epoch_split(ss)
    # bba: 10 s less issue (4) and verify (3); gc.full is not subtracted
    assert split["bba_bookkeeping"] == pytest.approx(3.0)
    # issue: 4 less its challenge (1) and its engine call (1)
    assert split["share_issue_host"] == pytest.approx(2.0)
    assert split["share_verify_host"] == pytest.approx(1.0)
    assert split["cp_challenge"] == pytest.approx(2.0)
    assert split["engine_pack"] == pytest.approx(0.5)
    assert split["engine_unpack"] == pytest.approx(0.5)
    assert split["engine_in_bba"] == pytest.approx(2.0)
    assert split["propose_kem"] == pytest.approx(0.5)
    assert progtrace.bba_parts_s(split) == pytest.approx(10.0)


def test_epochs_are_cut_by_their_clock_and_drops_read_none():
    two = EPOCH + [ev(20 + e[0], f"{e[3]}.{e[4]}", e[1] + 100, e[1] + e[2] + 100, **e[5])
                   for e in EPOCH]
    epochs = [{"program_events": progtrace.in_window(two, 0.5, 21.0)},
              {"program_events": progtrace.in_window(two, 100.5, 121.0)}]
    assert [len(ep["program_events"]) for ep in epochs] == [len(EPOCH)] * 2
    assert progtrace.per_epoch_ms(epochs, "bba_bookkeeping", 0) == pytest.approx(3000.0)
    assert progtrace.per_epoch_ms(epochs, "bba_bookkeeping", 1) is None
    assert progtrace.per_epoch_ms(epochs + [{"program_events": []}], "cp_challenge", 0) is None
    assert progtrace.per_epoch_ms([], "cp_challenge", 0) is None


def test_coin_useful_pct_reads_the_counter_and_nothing_without_it():
    eps = [{"stats": {"coin_issues": 100, "coin_useful": 80}},
           {"stats": {"coin_issues": 300, "coin_useful": 270}}]
    assert progtrace.coin_useful_pct(eps) == pytest.approx(87.5)
    # a program that does not count coin_useful
    assert progtrace.coin_useful_pct([{"stats": {"coin_issues": 100}}]) is None
    assert progtrace.coin_useful_pct([]) is None


def test_clock_anchors_give_offset_and_drift():
    # program clock = profiler clock + 1000 s, drifting 20 us over the window
    anchors = [(1000.0 + 5.0 - 1e-6, 1000.0 + 5.0 + 1e-6, 5.0e6),
               (1000.00002 + 55.0 - 3e-6, 1000.00002 + 55.0 + 3e-6, 55.0e6)]
    off, drift = progtrace.clock_offset(anchors)
    assert off == pytest.approx(1000.0, abs=1e-9)
    assert drift == pytest.approx(2e-5, abs=1e-9)
    # a wide anchor (a span's first entry, 1.6 ms) gives way to a narrow
    # one of the same half
    wide = (1000.0 + 6.0 - 1.6e-3, 1000.0 + 6.0, 6.0e6)
    narrow = (1000.00002 + 50.0 - 1e-6, 1000.00002 + 50.0 + 1e-6, 50.0e6)
    off, drift = progtrace.clock_offset([wide] + anchors[:1] + [narrow] + anchors[1:])
    assert off == pytest.approx(1000.0, abs=1e-9)
    assert drift == pytest.approx(2e-5, abs=1e-9)
    off, drift = progtrace.clock_offset(anchors[:1])
    assert (off, drift) == (pytest.approx(1000.0, abs=1e-9), 0.0)
    mapped = progtrace.to_profiler([("epoch.bba", 1010.0, 1011.0, {})], 1000.0)
    assert mapped == [("epoch.bba", pytest.approx(10.0e6), pytest.approx(11.0e6))]
    with pytest.raises(ValueError):
        progtrace.clock_offset([])


def test_idle_by_both_span_sets_names_program_spans_and_leaves_the_old_split_alone():
    window = (0.0, 100.0)
    dev = [("k", 30.0, 40.0), ("Memcpy HtoD", 60.0, 62.0)]
    bench = [("epoch", 5.0, 95.0), ("engine.dual_pow", 55.0, 65.0)]
    before = trace.idle_by_label(dev, bench, window)
    split = trace.profile_split(dev, window)
    prog = [("epoch.propose", 5.5, 20.0), ("epoch.bba", 20.0, 90.0), ("coin.verify", 50.0, 70.0),
            ("engine.device", 58.0, 63.0), ("gc.full", 80.0, 85.0), ("epoch.commit", 90.0, 95.0)]
    # program spans on the program clock (offset 7 s), mapped onto the profiler's
    mapped = progtrace.to_profiler([(n, a / 1e6 + 7.0, b / 1e6 + 7.0, {}) for n, a, b in prog], 7.0)
    refined = trace.idle_by_label(dev, bench + mapped, window)
    # the benchmark's own attribution and the busy share are unchanged
    assert trace.idle_by_label(dev, bench, window) == before
    assert trace.profile_split(dev, window) == split
    assert sum(refined.values()) == pytest.approx(sum(before.values()))
    assert sum(refined.values()) == pytest.approx(window[1] * (1 - split["busy_share"]))
    # the innermost open span of either set names each idle moment
    assert refined["host"] == pytest.approx(10.0)
    assert refined["epoch.propose"] == pytest.approx(14.5)
    assert refined["epoch.bba"] == pytest.approx(10.0 + 10.0 + 10.0 + 5.0)
    assert refined["coin.verify"] == pytest.approx(5.0 + 5.0)
    assert refined["engine.dual_pow"] == pytest.approx(3.0 + 2.0)
    assert refined["engine.device"] == pytest.approx(2.0 + 1.0)  # the copy 60-62 is busy
    assert refined["gc.full"] == pytest.approx(5.0)
    assert refined["epoch.commit"] == pytest.approx(5.0)
    # the bare label keeps only the moment before the program's first phase
    assert refined["epoch"] == pytest.approx(0.5)
    assert before == pytest.approx({"host": 10.0, "epoch": 70.0, "engine.dual_pow": 8.0})


def test_a_real_traced_epoch_splits_its_bba_time():
    torch = pytest.importorskip("torch")
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        c = LockstepCluster(config=Config(n=4, batch_size=32, crypto_backend="cuda", device="cpu",
                                          trace=True), key_seed=9)
        for i in range(64):
            c.submit(b"hb-progtrace-%04d" % i)
        t0 = c.recorder.now()
        stats = c.run_epoch()
        t1 = c.recorder.now()
    finally:
        torch.set_num_threads(threads)
    epoch = [{"program_events": progtrace.in_window(c.recorder.events(), t0, t1), "stats": stats}]
    split = progtrace.epoch_split(progtrace.spans(epoch[0]["program_events"]))
    assert progtrace.bba_parts_s(split) == pytest.approx(stats["bba_s"], rel=0.03)
    assert split["engine_pack"] > 0 and split["engine_unpack"] > 0 and split["propose_kem"] > 0
    assert progtrace.per_epoch_ms(epoch, "cp_challenge", 0) == pytest.approx(split["cp_challenge"] * 1e3)
    assert 0 < progtrace.coin_useful_pct(epoch) <= 100
