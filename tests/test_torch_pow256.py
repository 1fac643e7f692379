"""The 256-bit generic pow's (K7) design as the Python side sees it: the
two plans csrc/modexp.cu declares against the wrapper, the card's shared
memory and the entry point's split by call size; a pure-integer model of
the kernel's schedule (the counting sort of rows by exponent bit length,
longest first; a warp's window from its longest exponent; the table in
its entries; the whole-warp zero-digit skip; lanes past the last row that
repeat it and store nothing) against ``pow`` on the DKG's rows, the edge
rows and ragged batches; and ``chip_smoke.py``'s count of the schedule's
products against the model and against ``least_pow`` at the N=128
roster's ``finalize``.  The plain version is held to the reference's
``_pow_fused`` in tests/test_torch_modmath.py."""

import random
import re
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs
from cleisthenes_tpu_torch.csrc.sass_ops import modexp_plans
from cleisthenes_tpu_torch.ops import modexp_cuda as mx
from cleisthenes_tpu_torch.ops import modmath as mm

PLANS = modexp_plans()
POWS = ["PowPlan", "PowSmallPlan"]
P = mm.P
P2 = cs.P2
R = 1 << 256
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
SMS = 132
SOURCE = (Path(mx.__file__).parent.parent / "csrc" / "modexp.cu").read_text()


def round16(x: int) -> int:
    return -(-x // 16) * 16


def pow_smem(plan) -> int:
    """Dynamic shared memory of one K7 block (csrc/modexp.cu ``pow_smem``):
    the teams' staged exponent rows, then a table of 2^W entries of K words
    for every lane of the block."""
    teams = plan["threads"] // plan["team"]
    k = -(-8 // plan["team"])
    return round16(teams * 32) + (1 << plan["window"]) * k * plan["threads"] * 4


def order_model(exps):
    """The kernel's counting sort as pow_keys_kernel and pow_scatter_kernel
    run it: key 256 - bit length, the keys' histogram, the cursors as its
    exclusive scan, then every row placed at its key's cursor, the scatter's
    warps in turn (32 rows each; the lanes of a warp that share a key in
    lane order).  On the card the warps take their places in the order
    their atomics land, which moves rows only within a key."""
    keys = [256 - e.bit_length() for e in exps]
    hist = [0] * 257
    for k in keys:
        hist[k] += 1
    cursor, run = [], 0
    for h in hist:
        cursor.append(run)
        run += h
    perm = [None] * len(exps)
    for w0 in range(0, len(exps), 32):
        for i in range(w0, min(w0 + 32, len(exps))):
            perm[cursor[keys[i]]] = i
            cursor[keys[i]] += 1
    return perm


def pow_model(bases, exps, p: int, wmax: int, team: int, order: bool = True):
    """K7's schedule on integers: the rows through ``order_model``'s
    permutation, 32 / team of them a warp, the last warp filled with the
    last row (those lanes store nothing); per warp from its longest
    exponent's bits b: nothing for b = 0, else the window w =
    ``chip_smoke.pow_window(b, wmax)``, every base into the domain (the
    33rd byte folded as lo R^2 + h R^3; one product more for the warp where
    any row has one), the table b^0 .. b^(2^w - 1), the top digit's entry,
    then w squarings a digit and a table product unless the warp's digits
    there are all zero; last one product out of the domain.  Returns
    (results, products a row), both in the rows' own order."""
    r_inv = pow(R, -1, p)
    r2, r3, one = R * R % p, R * R * R % p, R % p

    def mont(a, b):
        return a * b * r_inv % p

    def to_mont(x):
        lo, h = x % R, x >> 256
        return (mont(lo, r2) + (mont(h, r3) if h else 0)) % p

    def digit(e, d, w):
        return (e >> (w * d)) & ((1 << w) - 1)

    n = len(bases)
    per_warp = 32 // team
    perm = order_model(exps) if order else list(range(n))
    lanes = perm + [perm[-1]] * ((-n) % per_warp)
    out, prods = [None] * n, [None] * n
    for w0 in range(0, len(lanes), per_warp):
        warp = lanes[w0 : w0 + per_warp]
        bits = max(exps[r].bit_length() for r in warp)
        accs, cnt = [one] * len(warp), 0
        if bits:
            w = cs.pow_window(bits, wmax)
            top = (bits - 1) // w
            cnt += 1 + any(bases[r] >> 256 for r in warp)
            tabs = []
            for r in warp:
                x = to_mont(bases[r])
                tab = [one, x]
                for _ in range(2, 1 << w):
                    tab.append(mont(tab[-1], x))
                tabs.append(tab)
            cnt += 2**w - 2
            accs = [tabs[k][digit(exps[r], top, w)] for k, r in enumerate(warp)]
            for d in range(top - 1, -1, -1):
                for _ in range(w):
                    accs = [mont(a, a) for a in accs]
                cnt += w
                digs = [digit(exps[r], d, w) for r in warp]
                if any(digs):
                    accs = [mont(a, tabs[k][dg]) for k, (a, dg) in enumerate(zip(accs, digs))]
                    cnt += 1
        cnt += 1
        for k, (r, a) in enumerate(zip(warp, accs)):
            if w0 + k < n:  # a lane past the last row stores nothing
                assert out[r] is None, "a row written twice"
                out[r], prods[r] = mont(a, 1), cnt
    return out, prods


def finalize_rows(n: int, t: int, p: int, seed: int):
    """(bases, exponents) ints of one node's ``finalize`` K7 call at roster
    (n, t) (``chip_smoke.dkg_step_rows``), the rows in the step's order."""
    b, e = cs.dkg_step_rows(np, np.random.default_rng(seed), p, n, t, "finalize")
    return mm.bytes33_to_ints(b), [int.from_bytes(r.tobytes(), "big") for r in e]


def edge_rows(p: int):
    """Every pair of the edge bases (0, 1, p - 1, p + 5, 2^264 - 1) and the
    edge exponents (0, 1, q, 2^256 - 1)."""
    q = (p - 1) // 2
    eb, ee = [0, 1, p - 1, p + 5, 2**264 - 1], [0, 1, q, 2**256 - 1]
    return [b for b in eb for _ in ee], [e for _ in eb for e in ee]


def test_pow_plans_match_kernel_source_and_wrapper():
    """csrc/modexp.cu declares K7's two plans for the 8-word family
    (32-byte exponent rows), one window each (the table's size; a warp
    picks its own window up to it); the wrapper's split and workspace are
    the source's: PowSmallPlan's rows an SM (MIN_BLOCKS x TEAMS) and the
    sort's words (``kSortWords``: 257-key histogram and cursors, a
    ticket)."""
    for name in POWS:
        plan = PLANS[name]
        assert plan["nw"] == 8 and plan["val_bytes"] == 32
        assert plan["window"] == plan["dual_window"]
        assert plan["team"] in (1, 2, 4, 8, 16, 32) and plan["threads"] % 32 == 0
        assert 1 <= plan["window"] <= 8
    small = PLANS["PowSmallPlan"]
    assert mx.POW_SMALL_ROWS_PER_SM == (
        small["min_blocks"] * small["threads"] // small["team"]
    )
    sort_words = int(re.search(r"kSortWords = (\d+);", SOURCE).group(1))
    assert mx.POW_SORT_WORDS == sort_words == 2 * 257 + 1


@pytest.mark.parametrize("name", POWS)
def test_pow_plan_shared_memory_fits(name):
    """K7's shared memory fits one block's limit and ``min_blocks`` blocks
    fit an SM (1 KB reserved each)."""
    plan = PLANS[name]
    smem = pow_smem(plan)
    assert smem <= SMEM_PER_BLOCK
    assert plan["min_blocks"] * (smem + 1024) <= SMEM_PER_SM


def test_pow_plans_split_the_calls_by_size():
    """On 132 SMs the entry point sends a call of at most one wave of
    PowSmallPlan's resident rows there (the decrypt-combine shape, 5,504
    rows), in the rows' own order, and a longer one to PowPlan (the DKG
    steps' 704,512 to 737,280 rows), ordered by length; ``pow_plan`` and
    ``POW_ORDERED`` are the entry point's rules, and the small plan's
    teams spread a call's rows over more warps than the large plan's
    lanes."""
    assert re.search(
        r"if \(n <= \(long long\)sms \* PowSmallPlan::MIN_BLOCKS \* PowSmallPlan::TEAMS\)\s*"
        r"return launch_pow<PowSmallPlan>", SOURCE)
    for name, ordered in mx.POW_ORDERED.items():
        assert f"launch_pow<{name}>(base, exp, out, ws, n, spec, stream, dev, " \
            f"{str(ordered).lower()});" in SOURCE
    last = SMS * mx.POW_SMALL_ROWS_PER_SM
    assert mx.pow_plan(last, SMS) == "PowSmallPlan" and mx.pow_plan(last + 1, SMS) == "PowPlan"
    assert mx.pow_plan(5504, SMS) == "PowSmallPlan"
    for rows in (704512, 720896, 737280):
        assert mx.pow_plan(rows, SMS) == "PowPlan"
    assert PLANS["PowSmallPlan"]["team"] > PLANS["PowPlan"]["team"]


def test_pow_window_is_the_kernels_and_the_cheapest():
    """``chip_smoke.pow_window`` is csrc/modexp.cu's: the w in 1..W with the
    fewest table and digit products for a warp's longest exponent, 1 bit
    for the shortest warps and the plans' full window for full-length
    ones."""
    assert "(1 << w) - 2 + ((bits + w - 1) / w - 1) * (w + 1)" in SOURCE
    wmax = PLANS["PowPlan"]["window"]
    for bits in range(1, 257):
        w = cs.pow_window(bits, wmax)
        cost = [2**v - 2 + (-(-bits // v) - 1) * (v + 1) for v in range(1, wmax + 1)]
        assert cost[w - 1] == min(cost) and w == cost.index(min(cost)) + 1
    assert cs.pow_window(1, wmax) == cs.pow_window(2, wmax) == 1
    assert cs.pow_window(255, wmax) == cs.pow_window(256, wmax) == wmax


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_order_is_a_bijection_longest_first(seed):
    """The counting sort's permutation holds every row once, longest
    exponent first, rows of one length in their own order."""
    rnd = random.Random(seed)
    exps = [rnd.getrandbits(rnd.choice([0, 1, 2, 9, 64, 255, 256])) for _ in range(1000)]
    perm = order_model(exps)
    assert sorted(perm) == list(range(len(exps)))
    bits = [exps[r].bit_length() for r in perm]
    assert bits == sorted(bits, reverse=True)
    assert perm == sorted(range(len(exps)), key=lambda r: (-exps[r].bit_length(), r))


@pytest.mark.parametrize("name", POWS)
@pytest.mark.parametrize("p", [P, P2], ids=["default", "p2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pow_model_equals_pow(name, p, seed):
    """The model of K7's schedule at the shipped plan equals b^e mod p on
    ``finalize``'s rows at a small roster (n=8, t=3: j^k mod q, short for
    small j), every edge pair and seeded full-length rows."""
    plan = PLANS[name]
    rnd = random.Random(seed)
    q = (p - 1) // 2
    fb, fe = finalize_rows(8, 3, p, seed)
    eb, ee = edge_rows(p)
    bases = fb + eb + [rnd.randrange(p) for _ in range(40)]
    exps = fe + ee + [rnd.randrange(q) for _ in range(40)]
    got, _ = pow_model(bases, exps, p, plan["window"], plan["team"], mx.POW_ORDERED[name])
    assert got == [pow(b, e, p) for b, e in zip(bases, exps)]


@pytest.mark.parametrize("name", POWS)
@pytest.mark.parametrize("n", [1, 31, 33, 203])
def test_pow_model_ragged_batches(name, n):
    """Batches of 1, 31, 33 and 203 rows (no multiple of a warp, a block or
    a team): the last warp's spare lanes repeat the last row of the order
    and store nothing; every row gets its own result once."""
    plan = PLANS[name]
    rnd = random.Random(n)
    eb, ee = edge_rows(P)
    bases = (eb + [rnd.randrange(2**264) for _ in range(n)])[:n]
    exps = (ee + [rnd.getrandbits(rnd.choice([1, 5, 40, 255])) for _ in range(n)])[:n]
    got, prods = pow_model(bases, exps, P, plan["window"], plan["team"], mx.POW_ORDERED[name])
    assert got == [pow(b, e, P) for b, e in zip(bases, exps)]
    assert None not in prods


def test_pow_model_zero_warp_makes_no_products():
    """A warp whose exponents are all 0 makes only the product out of the
    domain, and gives 1 (0^0 = 1, as the reference's binary method); a
    warp of short exponents takes a 1-bit window and no table products."""
    rnd = random.Random(3)
    bases = (
        [0]
        + [rnd.randrange(2**264) for _ in range(31)]
        + [rnd.randrange(P) for _ in range(32)]
    )
    exps = [0] * 32 + [1, 2, 3] * 10 + [3, 1]
    got, prods = pow_model(bases, exps, P, 4, 1, order=False)
    assert got == [pow(b, e, P) for b, e in zip(bases, exps)]
    assert prods[:32] == [1] * 32
    assert cs.pow_window(2, 4) == 1 and prods[32] == 1 + 0 + 1 + 1 + 1


@pytest.mark.parametrize("name", POWS)
@pytest.mark.parametrize("order", [True, False])
def test_pow_schedule_counts_the_models_products(name, order):
    """``chip_smoke.pow_schedule`` (numpy, used for the bounds' beside and
    the n=128 count below) counts, row for row, the products of the integer
    model, with and without the ordering, on ``finalize`` rows, edge rows
    and a ragged tail."""
    plan = PLANS[name]
    rnd = random.Random(11)
    fb, fe = finalize_rows(8, 3, P, 4)
    eb, ee = edge_rows(P)
    bases = fb + eb + [rnd.randrange(P) for _ in range(13)]
    exps = fe + ee + [rnd.getrandbits(rnd.choice([3, 70, 255])) for _ in range(13)]
    _, prods = pow_model(bases, exps, P, plan["window"], plan["team"], order)
    counted = cs.pow_schedule(np, mm.ints_to_bytes33(bases), mm.exps_to_bytes(exps),
                              plan["window"], 32 // plan["team"], order)
    assert counted.tolist() == prods


def test_pow_schedule_near_least_pow_at_n128_finalize():
    """At one node's N=128 ``finalize`` (t = 43, 704,512 rows) the
    schedule of the many-wave plan, which that call takes, makes at most
    1.1x the products ``least_pow`` counts (each row's best fixed window on
    its own; 149.4 a row), and without the ordering it would make about
    twice as many: a warp of the step's own order holds one dealer's
    exponents j^0 .. j^31, of every length."""
    n, t = 128, 43
    b, e = cs.dkg_step_rows(np, np.random.default_rng(2026), P, n, t, "finalize")
    # least_pow is per row, and each of the n x t exponents repeats for
    # every one of the n dealers
    least = int(cs.least_pow(np, e.reshape(n, n, t, 32)[:, 0].reshape(-1, 32)).sum()) * n
    plan = PLANS["PowPlan"]
    ordered = int(cs.pow_schedule(np, b, e, plan["window"], 32 // plan["team"]).sum())
    assert least <= ordered <= 1.1 * least
    assert 149 <= least / len(b) <= 150
    unordered = int(cs.pow_schedule(np, b, e, plan["window"], 32 // plan["team"],
                                    order=False).sum())
    assert unordered > 1.6 * least
