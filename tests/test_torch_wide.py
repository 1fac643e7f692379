"""The wide Montgomery kernels' (K12) design as the Python side sees it:
each family's plan (team of lanes, windows, block size), as
csrc/modexp_wide.cu declares it, against the wrapper's families and the
card's shared memory, the window choice against the product count of
the kernel's schedule, and the engine's dual-pow rows (Lagrange rows
after the CP rows).  The plain versions on edge rows and ragged batches
are held to the reference in tests/test_torch_groups.py."""

import math

import pytest
import torch

from cleisthenes_tpu_torch.csrc.sass_ops import wide_plans
from cleisthenes_tpu_torch.ops import modexp_cuda as mx
from cleisthenes_tpu_torch.ops.modmath import GROUP384

PLANS = wide_plans()
# the exponent widths of the families' groups in the repository: the
# subgroup orders q of GROUP384, Oakley group 1 and MODP-14
Q_BITS = {12: 383, 25: 767, 66: 2047}
FAMILIES = sorted(PLANS)
# an H100's shared memory: a block's most, and an SM's for all its blocks
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pow_products(bits: int, w: int) -> int:
    """Montgomery products of the kernel's pow schedule for a full-width
    exponent of ``bits`` bits in a warp of random exponents (a digit
    position that is zero in every team of a warp is rare enough to
    leave out): into the domain, entries 2 .. 2^w - 1 of the table, w
    squarings and a table product per digit after the top one, out of
    the domain."""
    d = math.ceil(bits / w)
    return 1 + (2**w - 2) + (w + 1) * (d - 1) + 1


def dual_products(bits: int, w: int) -> int:
    """... and of the dual pow's: both bases into the domain, a table per
    base, one chain of squarings with a product per digit of each base
    (the top digit's first from a table load), out of the domain."""
    d = math.ceil(bits / w)
    return 2 + 2 * (2**w - 2) + w * (d - 1) + 2 * d - 1 + 1


def words(plan) -> int:
    """Words of a value one lane holds (the kernel's ``Plan::K``)."""
    return -(-plan["nw"] // plan["team"])


def smem_bytes(plan, dual: bool, w=None) -> int:
    """Dynamic shared memory of one block (the kernel's ``smem_bytes``):
    the staged exponent rows, then the tables (2^w entries of ``words``
    words a lane), for the plan's window or ``w``."""
    teams = plan["threads"] // plan["team"]
    rows = -(-teams * plan["val_bytes"] // 16) * 16
    n = 2 if dual else 1
    w = w or plan["dual_window" if dual else "window"]
    return n * rows + n * (1 << w) * words(plan) * plan["threads"] * 4


def test_plans_match_kernel_source():
    """csrc/modexp_wide.cu declares one plan for each of the wrapper's
    families (``WIDE_WORDS``), with the family's words and row bytes."""
    assert sorted(mx.WIDE_WORDS.values()) == FAMILIES == [12, 25, 66]
    for nw, plan in PLANS.items():
        assert plan["nw"] == nw and mx.WIDE_WORDS[plan["val_bytes"]] == nw


@pytest.mark.parametrize("nw", FAMILIES)
def test_plan_layout_fits_the_card(nw):
    """A team is a power-of-two part of a warp whose lanes hold every
    word; blocks are whole warps; both kernels' shared memory fits one
    block's limit, and ``min_blocks`` blocks fit an SM (1 KB reserved
    each); the staged base rows fit the table area they borrow."""
    plan = PLANS[nw]
    t, k = plan["team"], words(plan)
    assert t in (1, 2, 4, 8, 16, 32)
    assert k * t >= nw > (k - 1) * t
    assert plan["threads"] % 32 == 0 and 128 <= plan["threads"] <= 256
    assert 4 * nw >= plan["val_bytes"] > 4 * (nw - 1)
    for dual in (False, True):
        smem = smem_bytes(plan, dual)
        assert smem <= SMEM_PER_BLOCK
        assert plan["min_blocks"] * (smem + 1024) <= SMEM_PER_SM
        tables = (2 if dual else 1) * (1 << plan["dual_window" if dual else "window"])
        table_bytes = tables * k * plan["threads"] * 4
        teams = plan["threads"] // t
        assert (2 if dual else 1) * teams * plan["val_bytes"] <= table_bytes
    # the 12-word plan (one lane an exponentiation): 128 staged 48-byte
    # exponent rows, then 16 pow-table entries of 12 words for 128 lanes
    if nw == 12:
        assert smem_bytes(plan, False) == 128 * 48 + 16 * 12 * 128 * 4


@pytest.mark.parametrize("nw", FAMILIES)
def test_plan_windows_are_the_cheapest(nw):
    """The pow window (4 or 5 bits) and the dual pow's per-base window
    need the fewest products of the kernel's schedule at the family's
    exponent width, to within 1 %, among the windows whose tables keep
    ``min_blocks`` blocks on an SM."""
    plan = PLANS[nw]
    bits = Q_BITS[nw]

    def fits(w, dual):
        return plan["min_blocks"] * (smem_bytes(plan, dual, w) + 1024) <= SMEM_PER_SM

    assert plan["window"] in (4, 5)
    best = min(pow_products(bits, w) for w in (4, 5) if fits(w, False))
    assert pow_products(bits, plan["window"]) <= 1.01 * best
    best = min(dual_products(bits, w) for w in range(1, 9) if fits(w, True))
    assert dual_products(bits, plan["dual_window"]) <= 1.01 * best


def test_engine_sends_lagrange_rows_after_cp_rows(monkeypatch):
    """The fused CP-verify/combine call in a wide group is one dual pow
    whose Lagrange rows (u2 = 1, e2 = 0) all follow its CP rows, so that
    the kernel's warps of Lagrange rows skip the second base's table and
    products (the kernel keeps no reorder of its own)."""
    from cleisthenes_tpu_torch.ops import tpke

    seen = []
    real = mx.wide_dual_pow_fused

    def keep(u1, e1, u2, e2, spec):
        seen.append((u2.clone(), e2.clone()))
        return real(u1, e1, u2, e2, spec)

    monkeypatch.setattr(mx, "wide_dual_pow_fused", keep)
    n, thr = 4, 2
    pub, shares = tpke.deal(n, thr, seed=3, group=GROUP384)
    svc = tpke.Tpke(pub, backend="cpu")
    ct = svc.encrypt(b"grouped rows")
    ctx = svc.context(ct)
    kw = {"backend": "cuda", "device": "cpu"}
    dec = tpke.issue_shares_batch(
        [(shares[i], ct.c1, ctx, pub.verification_keys[i]) for i in range(n)],
        group=GROUP384, **kw,
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
