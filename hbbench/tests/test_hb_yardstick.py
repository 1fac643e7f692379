"""The frozen yardstick: bounds from shapes alone, the least products of
an exponentiation, and the device split of a trace."""

import numpy as np
import pytest

from hbbench import trace, yardstick


def test_k6_bound_reproduces_the_kernel_table():
    # PERF.md's kernel table: K6 at N=128 (16,384 branches, D=7, L=128)
    # and N=512 (262,144 branches, D=9, L=128)
    assert yardstick.merkle_verify_bound(16384, 128, 7) == (0.020316620752984387, "operations")
    assert yardstick.merkle_verify_bound(262144, 128, 9) == (0.4009491276400367, "operations")


def test_least_products():
    e = np.zeros((3, 32), np.uint8)
    e[1, 31] = 1
    e[2, :] = 0xFF
    assert list(yardstick.least_pow(e)) == [0, 2, yardstick.least_pow(e)[2]]
    assert 255 < yardstick.least_pow(e)[2] < 2 * 256 + 2
    zero = np.zeros_like(e)
    # a dual pow with one exponent zero is one pow
    assert list(yardstick.least_dual(e, zero)) == list(yardstick.least_pow(e))
    # a shared chain of squarings costs less than two pows
    assert yardstick.least_dual(e[2:], e[2:])[0] < 2 * yardstick.least_pow(e[2:])[0]


def test_dual_pow_bound_counts_bytes_and_products():
    rows = 64
    u = [3] * rows
    e = [2**255 - 19] * rows
    ms, by, products = yardstick.dual_pow_bound(u, e, u, e)
    assert products > rows * 256 and by == "operations"
    assert ms == yardstick.mont_bound(rows * 163, products)[0]


def test_comb_products_fall_with_shared_bases():
    rng = np.random.default_rng(5)
    exps = rng.integers(0, 256, (256, 32), dtype=np.uint8)
    bases = np.zeros((2, 33), np.uint8)
    one = yardstick.least_comb(bases[:1], exps, np.zeros(256, np.int64))
    two = yardstick.least_comb(bases, exps, np.arange(256) % 2)
    assert 0 < one < two


def test_profile_split_and_idle_labels():
    window = (0.0, 100.0)
    dev = [("dual_pow_kernel<Plan<1>>", 10.0, 20.0), ("wide_dual_pow_kernel", 15.0, 25.0),
           ("Memcpy HtoD (Pageable -> Device)", 60.0, 70.0), ("merkle_verify_kernel", 95.0, 120.0)]
    split = trace.profile_split(dev, window)
    assert split["busy_us"] == 30.0 and split["busy_share"] == 0.3
    assert split["copies_us"] == {"HtoD": 10.0}
    assert trace.kernel_us(split, "dual_pow_kernel") == 10.0
    spans = [("epoch", 0.0, 90.0), ("engine.dual_pow", 5.0, 30.0), ("rbc.verify", 90.0, 100.0)]
    idle = trace.idle_by_label(dev, spans, window)
    assert idle == {"engine.dual_pow": 10.0, "epoch": 55.0, "rbc.verify": 5.0}
    assert sum(idle.values()) == 100.0 - split["busy_us"]


def _k8_rows():
    """600 fixed rows of K8's shape: unreduced bases, exponents of every
    length, Lagrange rows (u2 = 1, e2 = 0) and zero exponents."""
    import random

    p = 0xFFB28EF6A7CB6CEE1758160402FB047422834BD4AF8E388BD0BB1F438E9DA767
    q = (p - 1) // 2
    r = random.Random(20)
    rows = 600
    u1 = [r.randrange(1 << 264) if i % 7 == 0 else r.randrange(p) for i in range(rows)]
    e1 = [r.randrange(q) if i % 5 else r.randrange(1 << r.randrange(1, 256)) for i in range(rows)]
    u2 = [1 if i % 3 == 0 else r.randrange(p) for i in range(rows)]
    e2 = [0 if i % 3 == 0 else r.randrange(q) for i in range(rows)]
    e1[0] = e2[0] = e1[1] = 0
    return u1, e1, u2, e2


def test_k8_and_k6_bounds_are_pinned_on_256_bit_rows():
    # the values the yardstick gave before K12's bounds joined it
    from hbbench import harness

    rows = _k8_rows()
    assert yardstick.dual_pow_bound(*rows) == (0.002755821890782828, "operations", 213906)
    exps = np.frombuffer(b"".join(e.to_bytes(32, "big") for e in rows[1]), np.uint8).reshape(-1, 32)
    assert int(yardstick.least_pow(exps).sum()) == 179065
    # a 256-bit engine's window: K8 and K6 exactly, no K12
    got = harness.window_bounds(None, dual=[rows, rows], verify=[(16384, 128, 7)], pows=[rows[:2]])
    assert got == {"dual_pow_bound_ms": 2 * 0.002755821890782828,
                   "merkle_verify_bound_ms": 0.020316620752984387}


def _least_pow_of(x: int) -> int:
    """least_pow of one exponent, by its digits as Python integers."""
    if x == 0:
        return 0
    costs = []
    for w in range(1, 8):
        digits = -(-x.bit_length() // w)
        nonzero = sum((x >> (w * i)) & ((1 << w) - 1) != 0 for i in range(digits))
        costs.append(2 + (2**w - 2) + w * (digits - 1) + nonzero - 1)
    return min(costs)


@pytest.mark.parametrize("nb", [32, 48, 99, 264])
def test_least_pow_agrees_with_the_integers_at_every_width(nb):
    rng = np.random.default_rng(nb)
    e = rng.integers(0, 256, (60, nb), dtype=np.uint8)
    e[::3, : nb // 2] = 0
    e[::7] = 0
    e[1::11, :-1] = 0
    got = yardstick.least_pow(e)
    for row, x in enumerate(int.from_bytes(r.tobytes(), "big") for r in e):
        assert got[row] == _least_pow_of(x)


@pytest.mark.parametrize("vb", [48, 264])
def test_wide_rows_bound_without_raising(vb):
    import random

    bits = 384 if vb == 48 else 2048
    r = random.Random(vb)
    rows = 300
    bases = [r.getrandbits(bits - 1) for _ in range(rows)]
    exps = [r.getrandbits(bits - 1) | 1 << (bits - 2) for _ in range(rows)]
    ms, by, products = yardstick.wide_pow_bound(bases, exps, vb)
    assert products >= rows * (bits - 1 - 1)
    # the repository's bound of a wide product, at the issue rate
    ops = yardstick.WIDE_BOUND_OPS[yardstick.WIDE_WORDS[vb]]
    assert ops == {48: 950, 264: 26987}[vb]
    assert (ms, by) == yardstick.bound(rows * 3 * vb, 0, products * ops) and by == "operations"
    lagrange = [1] * rows, [0] * rows
    ms, by, dual = yardstick.wide_dual_pow_bound(bases, exps, *lagrange, vb)
    assert dual == products  # a row whose other exponent is 0 is one pow
    ms, by, dual = yardstick.wide_dual_pow_bound(bases, exps, bases, exps, vb)
    assert products < dual < 2 * products
    assert (ms, by) == yardstick.bound(rows * 5 * vb, 0, dual * ops)


def test_a_wide_engine_window_takes_k12_bounds():
    from hbbench import harness

    rows = [3, 5], [2**383 + 1, 7], [1, 9], [0, 11]
    got = harness.window_bounds(48, dual=[rows], verify=[], pows=[([2], [2**300])])
    assert set(got) == {"wide_dual_pow_bound_ms", "wide_pow_bound_ms"}
    assert got["wide_dual_pow_bound_ms"] == yardstick.wide_dual_pow_bound(*rows, 48)[0]
    assert got["wide_pow_bound_ms"] == yardstick.wide_pow_bound([2], [2**300], 48)[0]


def test_k12_readers_and_k8_reader_take_their_own_kernels():
    from hbbench import harness
    from hbbench.harness import RunData

    dev = [("dual_pow_kernel<Plan<8, 32, 1, 4, 4, 32, 6> >", 0.0, 100.0),
           ("wide_dual_pow_kernel<Plan<12, 48, 1, 4, 3, 128, 2> >", 100.0, 300.0),
           ("wide_pow_kernel<Plan<12, 48, 1, 4, 3, 128, 2> >", 300.0, 700.0)]
    run = RunData(setup_s=1.0, window_s=1.0, epochs=[], committed_in_window=0,
                  profile=trace.profile_split(dev, (0.0, 1000.0)),
                  dual_pow_bound_ms=0.05, wide_dual_pow_bound_ms=0.1, wide_pow_bound_ms=0.1)
    read = {m: harness.load_metric(m).read(run)
            for m in ("dual_pow_roofline", "wide_dual_pow_roofline", "wide_pow_roofline")}
    assert read == {"dual_pow_roofline": 50.0, "wide_dual_pow_roofline": 50.0, "wide_pow_roofline": 25.0}
    # a window that made no K12 call reads nothing, not 0
    run.wide_pow_bound_ms = run.wide_dual_pow_bound_ms = None
    assert harness.load_metric("wide_pow_roofline").read(run) is None
    assert harness.load_metric("wide_dual_pow_roofline").read(run) is None
