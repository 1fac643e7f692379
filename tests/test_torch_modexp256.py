"""The 256-bit modexp kernels' (K8 dual pow, K9 comb) design as the
Python side sees it: the plans csrc/modexp.cu declares against the
wrapper's comb width and the card's shared memory and L2, the windows
against the product counts of the kernels' schedules, pure-integer
models of those schedules (the dual pow's warp-uniform fixed window with
its Lagrange skip, the comb's table build in rounds and its
accumulation) against ``pow``, the bound's ``least_comb`` against a
direct count and against every comb's own, and the engine's dual-pow
rows (Lagrange rows after the CP rows).  The plain versions are held to
the reference in tests/test_torch_modmath.py."""

import math
import random

import numpy as np
import pytest

import chip_smoke as cs
from cleisthenes_tpu_torch.csrc.sass_ops import (
    MONT_FIRST_OPS, MONT_OPS, MONT_PIPE_OPS, MONT_TEAM_OPS, modexp_plans,
)
from cleisthenes_tpu_torch.ops import modexp_cuda as mx
from cleisthenes_tpu_torch.ops import modmath as mm

PLANS = modexp_plans()
DUAL, SMALL, COMB = PLANS["DualPlan"], PLANS["DualSmallPlan"], PLANS["CombPlan"]
DUALS = ["DualPlan", "DualSmallPlan"]
P = mm.P
Q = (P - 1) // 2
P2 = 0x93A40B764F1F5026ADA7C38AA3EF4EE81E01E89F9FE80837B1E370913DA99F13
R = 1 << 256
# an H100: a block's most shared memory, an SM's, its SMs and its L2
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
SMS = 132
L2_BYTES = 50 * 1024 * 1024
# exponent bits of the default group's shares (q < 2^255)
Q_BITS = Q.bit_length()


def round16(x: int) -> int:
    return -(-x // 16) * 16


def dual_smem(plan, wd=None) -> int:
    """Dynamic shared memory of one K8 block (csrc/modexp.cu
    ``dual_smem``): both staged exponent rows, then a table of 2^wd
    entries per base (K words a lane, for every lane of the block)."""
    wd = wd or plan["dual_window"]
    teams = plan["threads"] // plan["team"]
    k = -(-8 // plan["team"])
    return 2 * round16(teams * 32) + 2 * (1 << wd) * k * plan["threads"] * 4


def comb_rows(w: int, bits: int = 256) -> int:
    return -(-bits // w)


def comb_table_bytes(w: int) -> int:
    """One base's comb table: ceil(256 / w) rows of 2^w 32-byte entries."""
    return comb_rows(w) * (1 << w) * 32


def dual_products(bits: int, w: int, lagrange: bool) -> int:
    """Montgomery products of K8's schedule for a row of full-width
    exponents in a warp of random rows: into the domain and a table per
    base (one base for a warp of Lagrange rows), one chain of w
    squarings a digit, a table product per digit of each base (the top
    one of the first base a table load), out of the domain."""
    d = math.ceil(bits / w)
    bases = 1 if lagrange else 2
    return bases * (1 + 2**w - 2) + w * (d - 1) + bases * d - 1 + 1


def comb_products(n_exps: int, w: int, bits: int = Q_BITS) -> int:
    """Montgomery products of K9's schedule for one base with n_exps
    exponents: into the domain, the chain's w (r - 1) squarings, the
    table's r (2^w - 2) products, and r - 1 table products and one out of
    the domain per exponent (a zero digit multiplies by R mod p)."""
    r = comb_rows(w, bits)
    return 1 + w * (r - 1) + r * (2**w - 2) + n_exps * r


def mont(a: int, b: int, p: int) -> int:
    return a * b * pow(R, -1, p) % p


def test_plans_match_kernel_source_and_wrapper():
    """csrc/modexp.cu declares the five plans of the 8-word family
    (32-byte exponent rows; K7's two are held in tests/test_torch_pow256.py);
    the comb's width is the wrapper's ``COMB_WIDTH``, so the table the
    wrapper allocates is the one the kernels index."""
    assert sorted(PLANS) == ["CombPlan", "DualPlan", "DualSmallPlan", "PowPlan", "PowSmallPlan"]
    for plan in PLANS.values():
        assert plan["nw"] == 8 and plan["val_bytes"] == 32
        assert plan["window"] == plan["dual_window"]
    assert COMB["window"] == mx.COMB_WIDTH
    assert mx.COMB_ROWS == 64 and mx.COMB_COLS == 16  # the plain comb's own nibble table


def small_wave_rows() -> int:
    """The most rows dual_pow_fused sends to DualSmallPlan on an H100:
    one wave of its resident blocks."""
    return SMS * SMALL["min_blocks"] * (SMALL["threads"] // SMALL["team"])


def test_dual_plans_split_the_epochs_calls():
    """The N=128 epoch's round-0 dual pow (22,016 rows) fits one wave of
    DualSmallPlan's blocks and takes its larger window; the N=512 one
    (350,208 rows) takes DualPlan's, whose smaller tables keep more rows
    resident."""
    assert cs.MODEXP_SHAPES["n128"][3] <= small_wave_rows() < cs.MODEXP_SHAPES["n512"][3]
    assert SMALL["dual_window"] > DUAL["dual_window"]
    per_sm = {name: PLANS[name]["min_blocks"] * PLANS[name]["threads"] // PLANS[name]["team"]
              for name in DUALS}
    assert per_sm["DualPlan"] > per_sm["DualSmallPlan"]


@pytest.mark.parametrize("name", DUALS + ["CombPlan", "PowPlan", "PowSmallPlan"])
def test_plan_is_whole_warps_of_teams(name):
    plan = PLANS[name]
    t = plan["team"]
    assert t in (1, 2, 4, 8, 16, 32)
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 1024
    assert -(-8 // t) * t == 8  # every lane holds the same number of words
    assert 1 <= plan["window"] <= 8


@pytest.mark.parametrize("name", DUALS)
def test_dual_plan_shared_memory_fits(name):
    """K8's shared memory fits one block's limit and ``min_blocks`` blocks
    fit an SM (1 KB reserved each); the staged value rows and the
    results (33 bytes a row) fit the table area they borrow."""
    plan = PLANS[name]
    smem = dual_smem(plan)
    assert smem <= SMEM_PER_BLOCK
    assert plan["min_blocks"] * (smem + 1024) <= SMEM_PER_SM
    teams = plan["threads"] // plan["team"]
    tables = smem - 2 * round16(teams * 32)
    assert 2 * round16(teams * 33) <= tables


def test_comb_tables_fit_l2_and_static_shared_memory():
    """At N=128 every base's table (257) fits the L2 at once; at N=512
    the tables that comb_apply's resident blocks read at once — g's and
    those of the bases whose consecutive exponents the resident lanes
    cover, plus one a block could straddle into — fit it too, so a
    base's table stays hot while its exponents run.  comb_apply's static
    shared memory (staged exponents and results) stays under 48 KB."""
    table = comb_table_bytes(COMB["window"])
    n_g, n_b, per_base, _ = cs.MODEXP_SHAPES["n128"]
    assert (1 + n_b) * table <= L2_BYTES
    n_g, n_b, per_base, _ = cs.MODEXP_SHAPES["n512"]
    resident = SMS * COMB["min_blocks"] * COMB["threads"]
    live = 1 + -(-resident // per_base) + 1
    assert live * table <= L2_BYTES
    assert COMB["threads"] * 32 + round16(COMB["threads"] * 33) <= 48 * 1024


@pytest.mark.parametrize("name", DUALS)
def test_dual_window_is_the_cheapest(name):
    """Each K8 plan's per-base window needs the fewest products of its
    schedule, CP and Lagrange rows alike (the epoch's calls are half
    each), to within 1 %, among the windows whose tables keep the plan's
    ``min_blocks`` blocks on an SM."""
    plan = PLANS[name]

    def cost(w):
        return dual_products(Q_BITS, w, False) + dual_products(Q_BITS, w, True)

    fits = [w for w in range(1, 9)
            if plan["min_blocks"] * (dual_smem(plan, w) + 1024) <= SMEM_PER_SM]
    assert plan["dual_window"] in fits
    assert cost(plan["dual_window"]) <= 1.01 * min(cost(w) for w in fits)


@pytest.mark.parametrize("shape", sorted(cs.MODEXP_SHAPES))
def test_comb_width_is_the_cheapest_that_fits(shape):
    """K9's width needs the fewest products of its schedule at both
    epochs' round-0 shapes among the widths whose tables meet the L2 rule
    of the test above (all of N=128's at once)."""
    n_g, n_b, per_base, _ = cs.MODEXP_SHAPES[shape]

    def cost(w):
        return comb_products(n_g, w) + n_b * comb_products(per_base, w)

    def fits(w):
        _, nb128, _, _ = cs.MODEXP_SHAPES["n128"]
        return (1 + nb128) * comb_table_bytes(w) <= L2_BYTES

    widths = [w for w in range(2, 9) if fits(w)]
    assert COMB["window"] in widths
    assert cost(COMB["window"]) == min(cost(w) for w in widths)


def dual_model(rows, p: int, w: int, team: int):
    """K8's schedule on integers, warp by warp (32 / team rows a warp):
    both bases into the domain (the 33rd byte folded as lo R^2 + h R^3),
    a table per base unless the warp's exponents of that base are all
    zero, then from the warp's top digit one chain of w squarings a digit
    and a table product per base's digit unless the warp's digits there
    are all zero.  Returns (results, products per warp)."""
    r2, r3, one = R * R % p, R * R * R % p, R % p

    def to_mont(x):
        lo, h = x % R, x >> 256
        return (mont(lo, r2, p) + (mont(h, r3, p) if h else 0)) % p

    def digit(e, d):
        return (e >> (w * d)) & ((1 << w) - 1)

    def top(e):
        return (e.bit_length() - 1) // w if e else -1

    out, prods = [], []
    per_warp = 32 // team
    for at in range(0, len(rows), per_warp):
        warp = rows[at : at + per_warp]
        n = 0
        t = max(max(top(e1), top(e2)) for _u1, e1, _u2, e2 in warp)
        any1 = any(e1 for _u1, e1, _u2, e2 in warp)
        any2 = any(e2 for _u1, e1, _u2, e2 in warp)
        tabs = []
        for u1, e1, u2, e2 in warp:
            pair = []
            for u, used in ((u1, any1), (u2, any2)):
                tab = [one]
                if used and t >= 0:
                    x = to_mont(u)
                    n += 1 + (u >> 256 > 0)
                    tab += [x]
                    for _ in range(2, 1 << w):
                        tab.append(mont(tab[-1], x, p))
                        n += 1
                pair.append(tab)
            tabs.append(pair)
        accs = [one] * len(warp)
        if t >= 0:
            accs = [tabs[i][0][digit(r[1], t) if any1 else 0] for i, r in enumerate(warp)]
            for d in range(t, -1, -1):
                if any(digit(r[3], d) for r in warp):
                    accs = [
                        mont(a, tabs[i][1][digit(r[3], d)], p)
                        for i, (a, r) in enumerate(zip(accs, warp))
                    ]
                    n += len(warp)
                if d == 0:
                    break
                for _ in range(w):
                    accs = [mont(a, a, p) for a in accs]
                    n += len(warp)
                if any(digit(r[1], d - 1) for r in warp):
                    accs = [
                        mont(a, tabs[i][0][digit(r[1], d - 1)], p)
                        for i, (a, r) in enumerate(zip(accs, warp))
                    ]
                    n += len(warp)
        out += [mont(a, 1, p) for a in accs]
        prods.append(n + len(warp))
    return out, prods


@pytest.mark.parametrize("name", DUALS)
@pytest.mark.parametrize("p", [P, P2], ids=["default", "p2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_dual_model_equals_pow(name, p, seed):
    """The model of K8's schedule at the shipped plan equals u1^e1 u2^e2
    mod p on the edge rows (bases 0, 1, p - 1, p + 5, 2^264 - 1;
    exponents 0, 1, q, 2^256 - 1; a warp of zero exponents) and seeded
    CP and Lagrange rows, as the engine orders them."""
    rnd = random.Random(seed)
    u1, e1, u2, e2 = cs.dual_inputs(rnd, p, 96)
    rows = list(zip(u1, e1, u2, e2)) + [(rnd.randrange(p), 0, 1, 0)] * 32
    got, _ = dual_model(rows, p, PLANS[name]["dual_window"], PLANS[name]["team"])
    assert got == [pow(a, x, p) * pow(b, y, p) % p for a, x, b, y in rows]


@pytest.mark.parametrize("name", DUALS)
def test_dual_model_skips_the_second_table_for_lagrange_warps(name):
    """A warp of Lagrange rows (u2 = 1, e2 = 0) makes the products of one
    pow: no second table and no second-base product; a warp of CP rows
    makes those of the dual pow; both as the schedule's count says."""
    rnd = random.Random(5)
    w, per_warp = PLANS[name]["dual_window"], 32 // PLANS[name]["team"]
    cp = [
        (
            rnd.randrange(P),
            rnd.randrange(Q) | (1 << 254),
            rnd.randrange(P),
            rnd.randrange(Q) | (1 << 254),
        )
        for _ in range(per_warp)
    ]
    lag = [(rnd.randrange(P), rnd.randrange(Q) | (1 << 254), 1, 0) for _ in range(per_warp)]
    _, (n_cp, n_lag) = dual_model(cp + lag, P, w, PLANS[name]["team"])
    assert n_cp == per_warp * dual_products(255, w, False)
    assert n_lag == per_warp * dual_products(255, w, True)
    assert n_lag < 0.85 * n_cp


def comb_table_model(base: int, p: int, w: int):
    """K9's table build as comb_table_kernel runs it: the chain s_k =
    base^(2^(w k)) by w squarings a row, entries 0 (R mod p) and 1 (s_k)
    of every row, then rounds h = 1, 2, 4, ... that fill the entries j in
    (h, 2h] of every row as T[k][h] T[k][j - h], from entries of earlier
    rounds only.  Returns (table, rounds) with table[k][j] =
    base^(j 2^(w k)) R mod p."""
    rows, cols = comb_rows(w), 1 << w
    r2, r3, one = R * R % p, R * R * R % p, R % p
    x = (mont(base % R, r2, p) + (mont(base >> 256, r3, p) if base >> 256 else 0)) % p
    chain = [x]
    for _ in range(rows - 1):
        for _ in range(w):
            x = mont(x, x, p)
        chain.append(x)
    table = [[one, s_k] + [None] * (cols - 2) for s_k in chain]
    done, rounds, h = {0, 1}, 0, 1
    while h < cols:
        fill = range(h + 1, min(2 * h, cols - 1) + 1)
        for row in table:
            for j in fill:
                assert h in done and j - h in done and row[j] is None
                row[j] = mont(row[h], row[j - h], p)
        done |= set(fill)
        rounds += len(fill) > 0
        h *= 2
    return table, rounds


@pytest.mark.parametrize("w", [COMB["window"], 4, 8])
def test_comb_table_model_rounds(w):
    """The table build fills every entry with base^(j 2^(w k)) R mod p in
    w rounds after the chain, each round's operands from earlier ones."""
    base = 2**264 - 1
    table, rounds = comb_table_model(base, P, w)
    rows, cols = comb_rows(w), 1 << w
    for k in (0, 1, rows - 1):
        for j in (0, 1, 2, cols - 1):
            assert table[k][j] == pow(base, j << (w * k), P) * R % P
    assert all(v is not None for row in table for v in row)
    assert rounds == w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_comb_apply_model_equals_pow(seed):
    """The comb's accumulation at the shipped width, T[0][d_0] times
    T[k][d_k] for every further digit and out of the domain, equals
    base^e mod p for the edge and seeded exponents of several bases."""
    rnd = random.Random(seed)
    w = COMB["window"]
    bases, exps, rows = cs.comb_inputs(rnd, P, 20, 6, 6, True)
    tables = [comb_table_model(b, P, w)[0] for b in bases]
    for e, r in zip(exps, rows):
        d = [(e >> (w * k)) & ((1 << w) - 1) for k in range(comb_rows(w))]
        acc = tables[r][0][d[0]]
        for k in range(1, comb_rows(w)):
            acc = mont(acc, tables[r][k][d[k]], P)
        assert mont(acc, 1, P) == pow(bases[r], e, P)


@pytest.mark.parametrize("seed", [0, 1])
def test_least_comb_counts_the_cheapest_width_per_base(seed):
    """chip_smoke.py's ``least_comb`` equals a direct count of the fewest
    products over widths 2..8 chosen per base, and no comb of one width
    for the whole call — the shipped kernel's schedule among them —
    counts fewer."""
    rnd = random.Random(seed)
    bases, exps, rows = cs.comb_inputs(rnd, P, 60, 4, 25, True)
    arrs = (mm.ints_to_bytes33([b % P for b in bases]), mm.exps_to_bytes(exps),
            np.array(rows, dtype=np.int32))
    got = cs.least_comb(np, *arrs)
    want = 0
    for j, b in enumerate(bases):
        mine = [e for e, r in zip(exps, rows) if r == j]
        bits = max(e.bit_length() for e in mine)
        best = []
        for w in range(2, 9):
            r = max(-(-bits // w), 1)
            cost = 1 + (b % 2**264 >= R) + w * (r - 1) + r * (2**w - 2)
            for e in mine:
                nz = sum(1 for k in range(0, 258, w) if (e >> k) & ((1 << w) - 1))
                cost += max(nz - 1, 0) + 1
            best.append(cost)
        want += min(best)
    assert got == want
    for w in range(2, 9):
        one_width = sum(
            comb_products(sum(r == j for r in rows), w, 256)
            for j in range(len(bases))
        )
        assert got <= one_width


def test_mont_ops_is_the_lesser_count():
    """The 256-bit bounds take the fewest instructions a product has been
    seen to need: the lesser of the first design's and the team
    product's SASS counts (csrc/sass_ops.py checks both on the card).
    Split by pipe (``MONT_PIPE_OPS``: INT32 pipe, FMA pipe, issued), the
    team product's issued instructions are its ALU count, the two pipes
    hold no more than those, and the bound a product takes, the largest of
    each pipe's count over its rate and the issued over the issue rate, is
    never above the one-pipe bound of ``MONT_OPS`` at the INT32 rate."""
    assert MONT_OPS == min(MONT_FIRST_OPS, MONT_TEAM_OPS) <= 429
    i32, fma, issued = MONT_PIPE_OPS
    assert issued == MONT_TEAM_OPS
    assert i32 > 0 and fma > 0 and i32 + fma <= issued
    per_product = max(i32 / cs.INT32_OPS_PER_S, fma / cs.FMA_INT_OPS_PER_S,
                      issued / cs.ISSUE_OPS_PER_S)
    assert per_product <= MONT_OPS / cs.INT32_OPS_PER_S
    products = 10**6
    ms, by = cs.mont_bound(0, products)
    assert by == "operations" and ms == pytest.approx(products * per_product * 1e3)
    assert cs.mont_bound_one_pipe(0, products) == pytest.approx(
        products * MONT_OPS / cs.INT32_OPS_PER_S * 1e3)


def test_engine_sends_lagrange_rows_after_cp_rows(monkeypatch):
    """The 256-bit engine's fused CP-verify/combine call is one dual pow
    whose Lagrange rows (u2 = 1, e2 = 0) all follow its CP rows, so that
    K8's warps of Lagrange rows skip the second table and products."""
    from cleisthenes_tpu_torch.ops import tpke

    seen = []
    real = mx.dual_pow_fused

    def keep(u1, e1, u2, e2, spec):
        seen.append((u2.clone(), e2.clone()))
        return real(u1, e1, u2, e2, spec)

    monkeypatch.setattr(mx, "dual_pow_fused", keep)
    n, thr = 4, 2
    pub, shares = tpke.deal(n, thr, seed=3)
    svc = tpke.Tpke(pub, backend="cpu")
    ct = svc.encrypt(b"grouped rows")
    ctx = svc.context(ct)
    kw = {"backend": "cuda", "device": "cpu"}
    dec = tpke.issue_shares_batch(
        [(shares[i], ct.c1, ctx, pub.verification_keys[i]) for i in range(n)], **kw
    )
    tpke._COMBINE_MEMO.clear()
    verdicts, values, _ = tpke.verify_and_combine_share_groups(
        [(pub, ct.c1, dec, ctx)], pub.threshold, **kw
    )
    assert verdicts == [[True] * n] and values[0] is not None
    ((u2, e2),) = seen
    lag = (e2 == 0).all(1).tolist()
    assert len(lag) == 2 * n + thr and lag.index(True) == 2 * n and all(lag[2 * n :])
    assert bool((u2[2 * n :, 0] == 1).all()) and not bool(u2[2 * n :, 1:].any())
