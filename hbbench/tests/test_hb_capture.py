"""What the recorder keeps of the modexp engine's calls in a traced
window: K12's pow rows only on an engine of a wide family."""

import pytest

from hbbench.capture import Recorder


class _Engine:
    def pow_batch_grouped(self, groups):
        return [[b ** e for e in exps] for b, exps in groups]

    def pow_batch(self, bases, exps):
        return [b ** e for b, e in zip(bases, exps)]

    def dual_pow_batch(self, u1, e1, u2, e2):
        return [a ** x * b ** y for a, x, b, y in zip(u1, e1, u2, e2)]


def _drive(wide: bool) -> Recorder:
    rec = Recorder(seed=1, rbc_epochs=2, trace=True, wide=wide)
    engine = _Engine()
    rec._install_engine(engine)
    engine.pow_batch_grouped([(2, [1, 2])])  # before the window: not kept
    rec.window = True
    assert engine.pow_batch_grouped([(2, [1, 2]), (3, []), (5, [3])]) == [[2, 4], [], [125]]
    assert engine.pow_batch([7], [2]) == [49]
    assert engine.dual_pow_batch([2], [3], [1], [0]) == [8]
    rec.window = False
    engine.pow_batch([7], [3])
    return rec


@pytest.mark.parametrize("wide", [True, False], ids=["wide", "256-bit"])
def test_the_recorder_keeps_pow_rows_only_on_a_wide_engine(wide):
    rec = _drive(wide)
    assert rec.dual_rows == [([2], [3], [1], [0])]
    if wide:
        assert rec.wide_pow_calls() == [([2, 2, 5], [1, 2, 3]), ([7], [2])]
    else:
        assert rec.pow_groups == rec.pow_rows == [] and rec.wide_pow_calls() == []


def test_the_harness_names_the_engines_family():
    from cleisthenes_tpu_torch.ops.modmath import DEFAULT_GROUP, GROUP384, GroupParams

    from hbbench import harness

    p256 = int(harness.load_json("configs", "hb-n128-f42")["group"]["p"], 16)
    assert harness.wide_family("cuda", DEFAULT_GROUP) is None
    assert harness.wide_family("cuda", GroupParams(p=p256, q=(p256 - 1) // 2, g=4)) is None
    assert harness.wide_family("cuda", GROUP384) == 48
    assert harness.wide_family("cpu", GROUP384) is None
    modp14 = (1 << 2048) - (1 << 1984) - 1 + (1 << 64) * 12345
    assert harness.wide_family("cuda", GroupParams(p=modp14 | 1, q=0, g=4)) == 264
