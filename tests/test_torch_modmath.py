"""The port's modexp kernels (cleisthenes_tpu_torch.ops.modexp_cuda) and
engine (ops.modmath ``ModEngine('cuda')``) against the JAX package's.

On the CPU the wrappers run their plain PyTorch versions; each is held
byte for byte to the reference's device function itself
(``_pow_fused``, ``_dual_pow_fused``, ``_pow_fused_grouped``,
``mont_mul_batch``, JAX on the CPU, the group constants from
``_spec256``) on the same 33/32-byte inputs, for two 256-bit groups and
the edge rows: bases 0, 1, p-1 and bases in [p, 2^264); exponents 0, 1,
q and 2^256-1; the dual's Lagrange rows u2=1, e2=0.  Tolerance is zero:
this is exact integer math."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleisthenes_tpu.ops import modmath as ref
from cleisthenes_tpu_torch.ops import modexp_cuda as mx
from cleisthenes_tpu_torch.ops import modmath as mm

# the second 256-bit safe prime of tests/test_groups.py (seed 20260730)
P2 = 0x93A40B764F1F5026ADA7C38AA3EF4EE81E01E89F9FE80837B1E370913DA99F13
GROUPS = {
    "default": mm.DEFAULT_GROUP,
    "p2": mm.GroupParams(p=P2, q=(P2 - 1) // 2, g=4),
}
B = 40


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain modexp versions are ~20 small int64 ops per Montgomery
    product: intra-op threads only add contention (the suite runs
    several workers on the same cores), so these tests run on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
G_ROWS, G_COLS = 8, 20


def _ref_group(gp):
    return ref.GroupParams(p=gp.p, q=gp.q, g=gp.g)


def _ref_spec(gp):
    m_limbs, m_prime, r_limbs, r2_limbs = ref._spec256(_ref_group(gp))
    return (
        jnp.asarray(m_limbs), jnp.int32(m_prime),
        jnp.asarray(r_limbs), jnp.asarray(r2_limbs),
    )


def _bases(rnd, gp, n):
    """n 33-byte values: the edge rows first, then random ones, some of
    them in [p, 2^264)."""
    p = gp.p
    edge = [0, 1, p - 1, p, p + 1, 2**264 - 1, 2**256]
    rest = [
        rnd.randrange(p, 2**264) if i % 4 == 0 else rnd.randrange(p)
        for i in range(n - len(edge))
    ]
    return edge + rest


def _exps(rnd, gp, n):
    edge = [0, 1, gp.q, 2**256 - 1, 2, 0, 1]
    return edge + [rnd.randrange(2**256) for _ in range(n - len(edge))]


def _np33(xs):
    return np.ascontiguousarray(mm.ints_to_bytes33(xs))


def _np32(xs):
    return np.ascontiguousarray(mm.exps_to_bytes(xs))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_pow_fused_matches_reference_kernel(name):
    gp = GROUPS[name]
    rnd = random.Random(71)
    base, exp = _np33(_bases(rnd, gp, B)), _np32(_exps(rnd, gp, B))
    want = np.asarray(ref._pow_fused(jnp.asarray(base), jnp.asarray(exp), *_ref_spec(gp)))
    got = mx.pow_fused(_t(base), _t(exp), mx.mont_spec(gp.p)).numpy()
    assert np.array_equal(got, want)
    ints = mm.bytes33_to_ints(got)
    bases, exps = mm.bytes33_to_ints(base), [int.from_bytes(r.tobytes(), "big") for r in exp]
    assert ints == [pow(b, e, gp.p) for b, e in zip(bases, exps)]


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_dual_pow_fused_matches_reference_kernel(name):
    gp = GROUPS[name]
    rnd = random.Random(72)
    u1, e1 = _bases(rnd, gp, B), _exps(rnd, gp, B)
    u2 = list(reversed(_bases(rnd, gp, B)))
    e2 = _exps(rnd, gp, B)
    # the Lagrange rows that ride the CP-verify dispatch: u2=1, e2=0
    for i in range(0, B, 3):
        u2[i], e2[i] = 1, 0
    arrs = (_np33(u1), _np32(e1), _np33(u2), _np32(e2))
    want = np.asarray(
        ref._dual_pow_fused(*(jnp.asarray(a) for a in arrs), *_ref_spec(gp))
    )
    got = mx.dual_pow_fused(*(_t(a) for a in arrs), mx.mont_spec(gp.p)).numpy()
    assert np.array_equal(got, want)
    p = gp.p
    assert mm.bytes33_to_ints(got) == [
        pow(a, x, p) * pow(b, y, p) % p for a, x, b, y in zip(u1, e1, u2, e2)
    ]


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_pow_fused_grouped_matches_reference_kernel(name):
    gp = GROUPS[name]
    rnd = random.Random(73)
    bases = _bases(rnd, gp, G_ROWS)
    exps = [_exps(rnd, gp, G_COLS) for _ in range(G_ROWS)]
    b_np = _np33(bases)
    e_np = np.stack([_np32(row) for row in exps])
    want = np.asarray(
        ref._pow_fused_grouped(jnp.asarray(b_np), jnp.asarray(e_np), *_ref_spec(gp))
    )
    # the reference's (n, G) rectangle as the port's flat rows
    rows = torch.arange(G_ROWS, dtype=torch.int32).repeat_interleave(G_COLS)
    got = mx.pow_fused_grouped(
        _t(b_np), _t(e_np.reshape(-1, 32)), rows, mx.mont_spec(gp.p)
    ).numpy()
    assert got.shape == (G_ROWS * G_COLS, 33)
    assert np.array_equal(got.reshape(G_ROWS, G_COLS, 33), want)
    assert mm.bytes33_to_ints(got) == [
        pow(b, e, gp.p) for b, row in zip(bases, exps) for e in row
    ]


def test_pow_fused_grouped_any_row_order():
    """Each exponent names its base's table by row index: rows in any
    order, a base reused far apart, a base with no exponents."""
    gp = GROUPS["p2"]
    rnd = random.Random(76)
    bases = _bases(rnd, gp, 9)
    rows = [rnd.choice((0, 2, 3, 5, 8)) for _ in range(37)]
    exps = _exps(rnd, gp, 37)
    got = mx.pow_fused_grouped(
        _t(_np33(bases)), _t(_np32(exps)),
        torch.tensor(rows, dtype=torch.int32), mx.mont_spec(gp.p),
    )
    assert mm.bytes33_to_ints(got.numpy()) == [
        pow(bases[r], e, gp.p) for r, e in zip(rows, exps)
    ]


def test_mont_mul_batch_matches_reference_on_integer_semantics():
    """out * 2^256 == x * y == ref_out * 2^264 (mod p): the port's
    radix is 2^256, the reference's 2^264 (22 x 12-bit limbs)."""
    gp = mm.DEFAULT_GROUP
    p = gp.p
    rnd = random.Random(74)
    xs = [0, 1, p - 1] + [rnd.randrange(p) for _ in range(29)]
    ys = [p - 1, p - 1, p - 1] + [rnd.randrange(p) for _ in range(29)]
    ref_out = ref.limbs_to_ints(
        np.asarray(ref.mont_mul_batch(ref.ints_to_limbs(xs), ref.ints_to_limbs(ys)))
    )
    got = mm.bytes33_to_ints(
        mx.mont_mul_batch(_t(_np33(xs)), _t(_np33(ys)), mx.mont_spec(p)).numpy()
    )
    assert got == [r * 2**8 % p for r in ref_out]
    assert got == [x * y * pow(2**256, -1, p) % p for x, y in zip(xs, ys)]


def test_mont_mul_batch_second_group():
    p = P2
    rnd = random.Random(75)
    xs = [rnd.randrange(p) for _ in range(16)]
    ys = [rnd.randrange(p) for _ in range(16)]
    got = mm.bytes33_to_ints(
        mx.mont_mul_batch(_t(_np33(xs)), _t(_np33(ys)), mx.mont_spec(p)).numpy()
    )
    assert got == [x * y * pow(2**256, -1, p) % p for x, y in zip(xs, ys)]


def test_mont_spec_words():
    spec = mx.mont_spec(mm.P)
    w = [int(v) for v in spec.words]
    assert len(w) == 33

    def val(lo):
        return sum(x << (32 * i) for i, x in enumerate(w[lo : lo + 8]))

    r = 2**256
    assert val(0) == mm.P
    assert (w[8] * mm.P) % 2**32 == 2**32 - 1  # -p^-1 mod 2^32
    assert (val(9), val(17), val(25)) == (r % mm.P, r * r % mm.P, r**3 % mm.P)
    for bad in (2**256 + 1, 2**200, 1):
        with pytest.raises(ValueError):
            mx.mont_spec(bad)


def test_empty_and_misshapen_inputs():
    spec = mx.mont_spec(mm.P)
    empty33 = torch.zeros((0, 33), dtype=torch.uint8)
    empty32 = torch.zeros((0, 32), dtype=torch.uint8)
    assert mx.pow_fused(empty33, empty32, spec).shape == (0, 33)
    assert mx.dual_pow_fused(empty33, empty32, empty33, empty32, spec).shape == (0, 33)
    two = torch.zeros((2, 33), dtype=torch.uint8)
    assert mx.pow_fused_grouped(
        two, empty32, torch.zeros((0,), dtype=torch.int32), spec
    ).shape == (0, 33)
    exps3 = torch.zeros((3, 32), dtype=torch.uint8)
    for rows in ([0, 1, 2], [0, -1, 1], [0, 1]):
        with pytest.raises(ValueError, match="rows"):
            mx.pow_fused_grouped(two, exps3, torch.tensor(rows, dtype=torch.int32), spec)
    with pytest.raises(ValueError, match="rows"):
        mx.pow_fused_grouped(two, exps3, torch.zeros((3,), dtype=torch.int64), spec)
    with pytest.raises(ValueError):
        mx.pow_fused(torch.zeros((3, 32), dtype=torch.uint8), empty32, spec)
    with pytest.raises(ValueError):
        mx.pow_fused(
            torch.zeros((3, 33), dtype=torch.int32),
            torch.zeros((3, 32), dtype=torch.uint8), spec,
        )


# ---------------------------------------------------------------------------
# the engine: ModEngine('cuda', device='cpu') vs the reference's 'tpu'
# ---------------------------------------------------------------------------


@pytest.fixture
def ref_device_pinned(monkeypatch):
    """Pin the reference engine's batches to its XLA kernels (its host
    floors would send them to the native kernel), as
    tests/test_groups.py does."""
    monkeypatch.setattr(ref.ModEngine, "host_delegation", False)


def _engines(gp):
    return (
        mm.ModEngine("cuda", group=gp, device="cpu"),
        ref.ModEngine("tpu", group=_ref_group(gp)),
    )


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_engine_pow_and_dual_match_reference(name, ref_device_pinned):
    gp = GROUPS[name]
    ours, theirs = _engines(gp)
    rnd = random.Random(81)
    bases = _bases(rnd, gp, 24)
    exps = _exps(rnd, gp, 24)
    want = theirs.pow_batch(bases, exps)
    assert ours.pow_batch(bases, exps) == want == [
        pow(b, e, gp.p) for b, e in zip(bases, exps)
    ]
    u2 = [1] * 8 + [rnd.randrange(gp.p) for _ in range(16)]
    e2 = [0] * 8 + [rnd.randrange(gp.q) for _ in range(16)]
    assert ours.dual_pow_batch(bases, exps, u2, e2) == theirs.dual_pow_batch(
        bases, exps, u2, e2
    )
    assert ours.pow_batch([], []) == [] and ours.dual_pow_batch([], [], [], []) == []


def test_engine_grouped_splits_tails_and_order(ref_device_pinned):
    """The comb's engine path on the reference's G_ROW case
    (test_modmath_xla.py): groups of odd sizes past the reference's
    512-exponent row split, and one base given twice, come back in
    order from one dispatch with one table per distinct base."""
    gp = mm.DEFAULT_GROUP
    ours, theirs = _engines(gp)
    rnd = random.Random(11)
    p, q = gp.p, gp.q
    groups = [
        (rnd.randrange(2, p), [rnd.randrange(0, q) for _ in range(sz)])
        for sz in (700, 1200, 100, 3)
    ]
    groups.append((groups[1][0] + p, [rnd.randrange(0, q) for _ in range(5)]))
    got = ours.pow_batch_grouped(groups)
    assert got == theirs.pow_batch_grouped(groups)
    for (base, exps), res in zip(groups, got):
        assert len(res) == len(exps)
        for i in range(0, len(exps), 97):
            assert res[i] == pow(base, exps[i], p)
        assert res[-1] == pow(base, exps[-1], p)  # tail ordering


@pytest.mark.parametrize("sizes", [(30, 20, 13), (70, 0, 5)])
def test_engine_grouped_small_and_mixed(sizes, monkeypatch):
    """Below the comb crossover (64 exponents) a grouped call flattens
    to pow_batch; above it the comb runs.  Either way: python pow, base
    reduced mod p, an empty group kept in place."""
    gp = GROUPS["p2"]
    ours = mm.ModEngine("cuda", group=gp, device="cpu")
    seen = []
    real = mx.pow_fused_grouped
    monkeypatch.setattr(
        mx, "pow_fused_grouped",
        lambda *a: seen.append((a[0].shape, a[1].shape)) or real(*a),
    )
    rnd = random.Random(sum(sizes))
    groups = [
        (rnd.randrange(2**264), [rnd.randrange(2**256) for _ in range(sz)])
        for sz in sizes
    ]
    got = ours.pow_batch_grouped(groups)
    assert got == [[pow(b, e, gp.p) for e in exps] for b, exps in groups]
    assert bool(seen) == (sum(sizes) >= mm.ModEngine.COMB_MIN)
    # one dispatch, a table per base that has exponents
    want = [((sum(1 for s in sizes if s), 33), (sum(sizes), 32))]
    assert seen == (want if seen else [])


def test_engine_cuda_needs_a_gpu_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mm.ModEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mm.ModEngine("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mm.get_engine("cuda")
    eng = mm.ModEngine("cuda", device="cpu")
    assert eng.device == torch.device("cpu") and eng.backend == "cuda"
    with pytest.raises(ValueError):
        mm.ModEngine("tpu")


def test_engine_routing_for_wide_groups():
    """The 384-bit group now gets a 'cuda' engine (the K12 family); a
    group no CUDA family hosts (past 2112 bits, as in the reference's
    test_xla_engine_still_rejects_beyond_every_family) degrades to the
    host engine, and asking for the device engine explicitly raises."""
    g384 = mm.GroupParams(p=ref.P384, q=(ref.P384 - 1) // 2, g=4)
    assert mm.cuda_capable(g384) and g384 == mm.GROUP384
    eng384 = mm.get_engine_degraded("cuda", g384, device="cpu")
    assert eng384.backend == "cuda" and eng384 is mm.get_engine("cuda", g384, device="cpu")
    p_huge = (1 << 3000) + 117  # odd, 3001 bits
    wide = mm.GroupParams(p=p_huge, q=(p_huge - 1) // 2, g=4)
    assert not mm.cuda_capable(wide)
    assert mm.cuda_capable(mm.DEFAULT_GROUP) and mm.cuda_capable(GROUPS["p2"])
    assert not mm.cuda_capable(mm.GroupParams(p=2**255, q=1, g=4))
    eng = mm.get_engine_degraded("cuda", wide, device="cpu")
    assert eng.backend == "cpu"
    assert eng.pow_batch([5, 7], [3, wide.q]) == [125, pow(7, wide.q, wide.p)]
    with pytest.raises(ValueError):
        mm.get_engine("cuda", wide, device="cpu")
    dev = mm.get_engine_degraded("cuda", mm.DEFAULT_GROUP, device="cpu")
    assert dev.backend == "cuda" and dev is mm.get_engine("cuda", device="cpu")


def test_engine_stats_count_calls():
    """``ModEngine.stats``: one call per batch call (an empty one is
    none), its seconds, and the device leg inside them."""
    eng = mm.ModEngine("cuda", group=GROUPS["p2"], device="cpu")
    assert eng.stats == {"calls": 0, "engine_s": 0.0, "device_s": 0.0}
    eng.pow_batch([3, 5], [7, 11])
    eng.dual_pow_batch([3], [7], [5], [11])
    eng.pow_batch_grouped([(3, [1] * 40), (5, [2] * 30)])  # the comb
    eng.pow_batch_grouped([(3, [])])
    eng.pow_batch([], [])
    assert eng.stats["calls"] == 3
    assert eng.stats["engine_s"] >= eng.stats["device_s"] > 0
    host = mm.ModEngine("cpu", group=GROUPS["p2"])
    host.pow_batch([3], [7])
    assert host.stats["calls"] == 1 and host.stats["device_s"] == 0.0
