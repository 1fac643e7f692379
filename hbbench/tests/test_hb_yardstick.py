"""The frozen yardstick: bounds from shapes alone, the least products of
an exponentiation, and the device split of a trace."""

import numpy as np

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
