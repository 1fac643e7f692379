"""The reference's engine and TPKE cases, re-pointed at the port's
``'cuda'`` backend on a CPU device (the modexp kernels' plain PyTorch
versions): tests/test_tpke.py ``TestModEngine`` and its batched-issue
and fused verify/combine cases, and tests/test_modmath_xla.py's
batched issue/combine case.

The port keeps only the batched share ops the lockstep epoch uses, so
where a reference case checks against a scalar op the port lacks
(``issue_share``, ``verify_shares``, ``verify_share_groups``) it runs
that op from the reference on the same dealt keys: ``deal`` is
deterministic in its seed, and the two packages' keys and shares are
the same integers."""

import random

import pytest
import torch

from cleisthenes_tpu.ops import tpke as ref_tpke
from cleisthenes_tpu_torch.ops import modmath as mm
from cleisthenes_tpu_torch.ops import tpke

rng = random.Random(99)
CUDA = {"backend": "cuda", "device": "cpu"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain modexp versions are ~20 small int64 ops per Montgomery
    product: intra-op threads only add contention (the suite runs
    several workers on the same cores), so these tests run on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_keys(n, threshold, seed):
    pub, shares = ref_tpke.deal(n=n, threshold=threshold, seed=seed)
    return pub, shares


def _as_ref(shares):
    return [ref_tpke.DhShare(*s) for s in shares]


class TestModEngine:
    def test_pow_batch_cuda_matches_pow(self):
        eng = mm.ModEngine("cuda", device="cpu")
        bases = [rng.randrange(2, mm.P) for _ in range(9)]
        exps = [rng.randrange(mm.Q) for _ in range(9)]
        assert eng.pow_batch(bases, exps) == [
            pow(b, e, mm.P) for b, e in zip(bases, exps)
        ]

    def test_dual_pow_batch_cuda(self):
        eng = mm.ModEngine("cuda", device="cpu")
        u1 = [rng.randrange(2, mm.P) for _ in range(5)]
        u2 = [rng.randrange(2, mm.P) for _ in range(5)]
        e1 = [rng.randrange(mm.Q) for _ in range(5)]
        e2 = [rng.randrange(mm.Q) for _ in range(5)]
        assert eng.dual_pow_batch(u1, e1, u2, e2) == [
            pow(a, x, mm.P) * pow(b, y, mm.P) % mm.P
            for a, x, b, y in zip(u1, e1, u2, e2)
        ]

    def test_edge_exponents(self):
        eng = mm.ModEngine("cuda", device="cpu")
        assert eng.pow_batch([7, 7, 0, 1, mm.P - 1], [0, 1, 5, 9, 2]) == [
            1, 7, 0, 1, pow(mm.P - 1, 2, mm.P)
        ]

    def test_empty_batch(self):
        assert mm.ModEngine("cuda", device="cpu").pow_batch([], []) == []

    def test_byte_codec_roundtrip(self):
        xs = [rng.randrange(2**264) for _ in range(20)]
        assert mm.bytes33_to_ints(mm.ints_to_bytes33(xs)) == xs


def test_issue_and_combine_batch_match_scalar():
    """issue_shares_batch / combine_shares_batch vs their scalar
    equivalents (reference tests/test_modmath_xla.py)."""
    pub, shares = tpke.deal(4, 2, seed=5)
    ref_pub, _ = _ref_keys(4, 2, 5)
    assert ref_pub.master == pub.master
    base = pow(tpke.DEFAULT_GROUP.g, 12345, tpke.DEFAULT_GROUP.p)
    ctx = b"batch-issue-test"
    vks = pub.verification_keys
    items = [(s, base, ctx, vks[s.index - 1]) for s in shares]
    out = tpke.issue_shares_batch(items, **CUDA)
    assert [s.index for s in out] == [s.index for s in shares]
    # every batched share verifies under the reference's scalar verifier
    assert all(ref_tpke.verify_shares(ref_pub, base, _as_ref(out), ctx))
    # vk=None recomputes the verification key: same validity
    out2 = tpke.issue_shares_batch([(shares[0], base, ctx, None)], **CUDA)
    assert all(ref_tpke.verify_shares(ref_pub, base, _as_ref(out2), ctx))
    # combines (scalar vs batch vs distinct subsets) agree
    a = tpke.combine_shares(out[:2], 2)
    b = tpke.combine_shares(out[2:4], 2)
    assert a == b  # subset independence
    tpke._COMBINE_MEMO.clear()
    got = tpke.combine_shares_batch([out[:2], out[1:3], out[2:]], 2, **CUDA)
    assert got == [a, a, a]


class TestBatchedIssue:
    def test_batched_issue_verifies_under_scalar_path(self):
        pub, shares = tpke.deal(n=5, threshold=2, seed=77)
        ref_pub, ref_shares = _ref_keys(5, 2, 77)
        base = tpke.hash_to_group(b"cross-check")
        ctx = b"cross|ctx"
        out = tpke.issue_shares_batch(
            [(s, base, ctx, pub.verification_keys[s.index - 1]) for s in shares],
            **CUDA,
        )
        # the reference's scalar verifier accepts every batched share
        assert all(ref_tpke.verify_shares(ref_pub, base, _as_ref(out), ctx))
        # and a reference scalar-issued share verifies under the port's
        # batched path
        one = ref_tpke.issue_share(ref_shares[0], base, ctx)
        v, _, _ = tpke.verify_and_combine_share_groups(
            [(pub, base, [tpke.DhShare(*one)] + out[1:], ctx)], 2, **CUDA
        )
        assert all(v[0])

    def test_comb_path_issue(self):
        """Enough items for the comb (>= 64 exponents in the grouped
        call): shares still verify and combine like the host's."""
        pub, shares = tpke.deal(n=7, threshold=3, seed=45)
        ref_pub, _ = _ref_keys(7, 3, 45)
        items = []
        bases = [tpke.hash_to_group(b"comb|%d" % i) for i in range(6)]
        for i, base in enumerate(bases):
            items += [
                (s, base, b"c|%d" % i, pub.verification_keys[s.index - 1])
                for s in shares
            ]
        out = tpke.issue_shares_batch(items, **CUDA)
        for i, base in enumerate(bases):
            grp = _as_ref(out[7 * i : 7 * i + 7])
            assert all(ref_tpke.verify_shares(ref_pub, base, grp, b"c|%d" % i))
            # subset independence, across the two packages' combines
            assert tpke.combine_shares(
                out[7 * i : 7 * i + 3], 3
            ) == ref_tpke.combine_shares(grp[3:6], 3)


class TestFusedVerifyCombine:
    def test_fused_matches_separate_ops(self):
        pub, shares = tpke.deal(n=7, threshold=3, seed=42)
        ref_pub, _ = _ref_keys(7, 3, 42)
        groups = []
        ref_groups = []
        for i in range(4):
            ctx = b"g|%d" % i
            base = tpke.hash_to_group(b"b|%d" % i)
            out = tpke.issue_shares_batch(
                [(s, base, ctx, pub.verification_keys[s.index - 1])
                 for s in shares],
                **CUDA,
            )
            groups.append((pub, base, out, ctx))
            ref_groups.append((ref_pub, base, _as_ref(out), ctx))
        v1 = ref_tpke.verify_share_groups(ref_groups)
        c1 = tpke.combine_shares_batch([g[2][:3] for g in groups], 3, **CUDA)
        tpke._COMBINE_MEMO.clear()
        v2, c2, _ = tpke.verify_and_combine_share_groups(groups, 3, **CUDA)
        assert v1 == v2 and c1 == c2
        # memo is seeded: a follow-up scalar combine is a pure hit
        assert tpke.combine_shares(groups[0][2][:3], 3) == c2[0]

    def test_fused_combine_only_sets(self):
        pub, shares = tpke.deal(n=6, threshold=3, seed=43)
        base = tpke.hash_to_group(b"co")
        ctx = b"co|ctx"
        out = tpke.issue_shares_batch(
            [(s, base, ctx, pub.verification_keys[s.index - 1])
             for s in shares],
            **CUDA,
        )
        want = tpke.combine_shares_batch([out[:3], out[2:5]], 3, **CUDA)
        tpke._COMBINE_MEMO.clear()
        # equal-but-distinct group object must still combine (keyed by
        # value, not identity)
        gp2 = mm.GroupParams(p=mm.P, q=mm.Q, g=mm.G)
        v, gvals, co = tpke.verify_and_combine_share_groups(
            [(pub, base, out, ctx)],
            3,
            combine_only_sets=[out[:3], out[2:5]],
            combine_only_group=gp2,
            **CUDA,
        )
        assert all(v[0])
        assert co == want

    def test_fused_flags_tampered_share(self):
        pub, shares = tpke.deal(n=5, threshold=2, seed=44)
        base = tpke.hash_to_group(b"tamper")
        ctx = b"t|ctx"
        out = tpke.issue_shares_batch(
            [(s, base, ctx, pub.verification_keys[s.index - 1])
             for s in shares],
            **CUDA,
        )
        bad = list(out)
        bad[2] = tpke.DhShare(
            index=bad[2].index, d=bad[2].d, e=bad[2].e, z=bad[2].z + 1
        )
        v, _, _ = tpke.verify_and_combine_share_groups(
            [(pub, base, bad, ctx)], 2, **CUDA
        )
        assert v[0] == [True, True, False, True, True]


def test_default_device_needs_a_gpu():
    """The batched ops' defaults (backend='cuda', device='cuda') run on
    the card: on a machine without one they raise instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default runs there")
    pub, shares = tpke.deal(n=4, threshold=2, seed=46)
    base = tpke.hash_to_group(b"nogpu")
    out = tpke.issue_shares_batch(
        [(s, base, b"x", pub.verification_keys[s.index - 1]) for s in shares],
        device="cpu",
    )
    tpke._COMBINE_MEMO.clear()
    for call in (
        lambda: tpke.issue_shares_batch(
            [(shares[0], base, b"x", pub.verification_keys[0])]
        ),
        lambda: tpke.issue_shares_batch(
            [(shares[0], base, b"x", pub.verification_keys[0])], backend="cuda"
        ),
        lambda: tpke.combine_shares_batch([out[:2]], 2),
        lambda: tpke.verify_and_combine_share_groups([(pub, base, out, b"x")], 2),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tpke.Tpke(pub).backend == "cuda"


def test_unfused_decrypt_combine_matches_fused_epoch(monkeypatch):
    """The decrypt wave's unfused branch (protocol/spmd.py, taken when
    the coin and TPKE thresholds differ) runs the generic pow: the
    epoch's decryption-share sets, combined again after clearing the
    memo, give the values the epoch's fused dual-pow dispatch left."""
    from cleisthenes_tpu_torch.protocol import spmd

    sets = []
    real = spmd.verify_and_combine_share_groups

    def seen(*args, **kwargs):
        sets.extend(kwargs.get("combine_only_sets", ()))
        return real(*args, **kwargs)

    monkeypatch.setattr(spmd, "verify_and_combine_share_groups", seen)
    c = spmd.LockstepCluster(n=4, batch_size=16, key_seed=5, device="cpu")
    for i in range(16):
        c.submit(b"unfused-%d" % i)
    c.run_epoch()
    thr, gp = c.tpke.pub.threshold, c.tpke.group
    assert len(sets) == 4 and all(len(s) == thr for s in sets)
    fused = [tpke.combine_shares(s, thr, gp) for s in sets]  # memo hits
    tpke._COMBINE_MEMO.clear()
    assert tpke.combine_shares_batch(sets, thr, group=gp, **CUDA) == fused
