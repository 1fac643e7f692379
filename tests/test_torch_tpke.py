"""The reference's engine, TPKE and coin cases, re-pointed at the port:
tests/test_tpke.py (``TestModEngine``, ``TestShamir``, ``TestTpke``,
``TestCommonCoin``, ``TestGroupMembership``, ``TestBatchedChallenge``,
``TestFusedVerifyCombine``), tests/test_modmath_xla.py's batched
issue/combine case and tests/test_hub.py's ``TestSharePool`` and
multi-group ``verify_share_groups`` cases.  The engine-backed cases run
on the port's ``'cuda'`` backend on a CPU device (the modexp kernels'
plain PyTorch versions) and, where the reference runs both backends, on
``'cpu'`` too.

Every case uses the port's own scalar and pooled share ops
(``issue_share``, ``verify_shares``, ``verify_share_groups``,
``SharePool``); ``test_scalar_ops_match_reference`` holds each of them
to the reference's on the same dealt keys (``deal`` is deterministic in
its seed, so the two packages' keys and shares are the same integers).

Left out: ``TestModEngine::test_limb_roundtrip`` (it asserts the TPU's
22x12-bit limb layout; the port's byte codec has
``test_byte_codec_roundtrip``) and
``TestGroupMembership::test_deserialize_rejects_poisoned_c1`` (it needs
``protocol/honeybadger.py``'s ciphertext codec, which the port does not
have yet)."""

import random

import pytest
import torch

from cleisthenes_tpu.ops import tpke as ref_tpke
from cleisthenes_tpu_torch.ops import coin as coin_mod
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
    # every batched share verifies under the scalar verifier
    assert all(tpke.verify_shares(pub, base, out, ctx, **CUDA))
    # vk=None recomputes the verification key: same validity
    out2 = tpke.issue_shares_batch([(shares[0], base, ctx, None)], **CUDA)
    assert all(tpke.verify_shares(pub, base, out2, ctx, **CUDA))
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
        base = tpke.hash_to_group(b"cross-check")
        ctx = b"cross|ctx"
        out = tpke.issue_shares_batch(
            [(s, base, ctx, pub.verification_keys[s.index - 1]) for s in shares],
            **CUDA,
        )
        # the scalar verifier accepts every batched share
        assert all(tpke.verify_shares(pub, base, out, ctx, **CUDA))
        # and a scalar-issued share verifies under the batched path
        one = tpke.issue_share(shares[0], base, ctx)
        v, _, _ = tpke.verify_and_combine_share_groups(
            [(pub, base, [one] + out[1:], ctx)], 2, **CUDA
        )
        assert all(v[0])

    def test_comb_path_issue(self):
        """Enough items for the comb (>= 64 exponents in the grouped
        call): shares still verify and combine like the host's."""
        pub, shares = tpke.deal(n=7, threshold=3, seed=45)
        items = []
        bases = [tpke.hash_to_group(b"comb|%d" % i) for i in range(6)]
        for i, base in enumerate(bases):
            items += [
                (s, base, b"c|%d" % i, pub.verification_keys[s.index - 1])
                for s in shares
            ]
        out = tpke.issue_shares_batch(items, **CUDA)
        for i, base in enumerate(bases):
            grp = out[7 * i : 7 * i + 7]
            assert all(tpke.verify_shares(pub, base, grp, b"c|%d" % i, **CUDA))
            # subset independence, across the two packages' combines
            assert tpke.combine_shares(
                grp[:3], 3
            ) == ref_tpke.combine_shares(_as_ref(grp[3:6]), 3)


class TestFusedVerifyCombine:
    def test_fused_matches_separate_ops(self):
        pub, shares = tpke.deal(n=7, threshold=3, seed=42)
        groups = []
        for i in range(4):
            ctx = b"g|%d" % i
            base = tpke.hash_to_group(b"b|%d" % i)
            out = tpke.issue_shares_batch(
                [(s, base, ctx, pub.verification_keys[s.index - 1])
                 for s in shares],
                **CUDA,
            )
            groups.append((pub, base, out, ctx))
        v1 = tpke.verify_share_groups(groups, **CUDA)
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
    svc, coin = tpke.Tpke(pub), coin_mod.CommonCoin(pub)
    ct = svc.encrypt(b"x")  # host-side, as in the reference
    for call in (
        lambda: svc.dec_share_batch(shares[0], [ct]),
        lambda: svc.verify_dec_shares(ct, [svc.dec_share(shares[0], ct)]),
        lambda: coin.share_batch(shares[0], [b"c"]),
        lambda: coin.verify_shares(b"c", [coin.share(shares[0], b"c")]),
        lambda: tpke.verify_shares(pub, base, out, b"x"),
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


ARMS = {"cpu": {"backend": "cpu"}, "cuda": CUDA}


def test_scalar_ops_match_reference():
    """Each of the port's scalar and pooled share ops against the
    reference's on the same dealt keys: shares issued by either package
    verify under the other's ``verify_shares``, and both packages'
    ``verify_share_groups`` give the same verdicts on the same groups,
    tampered shares included."""
    pub, shares = tpke.deal(n=5, threshold=2, seed=78)
    ref_pub, ref_shares = _ref_keys(5, 2, 78)
    assert (ref_pub.master, ref_pub.verification_keys) == (
        pub.master, pub.verification_keys
    )
    groups, ref_groups = [], []
    for i in range(3):
        base, ctx = tpke.hash_to_group(b"parity|%d" % i), b"p|%d" % i
        ours = [tpke.issue_share(s, base, ctx) for s in shares]
        theirs = [tpke.DhShare(*ref_tpke.issue_share(s, base, ctx)) for s in ref_shares]
        assert [s.d for s in ours] == [s.d for s in theirs]
        for arm in ARMS.values():
            assert all(tpke.verify_shares(pub, base, theirs, ctx, **arm))
        assert all(ref_tpke.verify_shares(ref_pub, base, _as_ref(ours), ctx))
        mixed = ours[:2] + theirs[2:]
        mixed[i] = mixed[i]._replace(z=mixed[i].z + 1)
        groups.append((pub, base, mixed, ctx))
        ref_groups.append((ref_pub, base, _as_ref(mixed), ctx))
    want = ref_tpke.verify_share_groups(ref_groups)
    assert [v.count(False) for v in want] == [1, 1, 1]
    for arm in ARMS.values():
        assert tpke.verify_share_groups(groups, **arm) == want
    # SharePool: the same deferred-verdict flow gives the same subsets
    pools = (tpke.SharePool(2), ref_tpke.SharePool(2))
    for pool, grp in zip(pools, (groups[0][2], _as_ref(groups[0][2]))):
        for k, sh in enumerate(grp):
            pool.add(f"n{k}", sh)
    verdicts = want[0]
    for pool in pools:
        senders, _ = pool.collect_pending()
        pool.apply_verdicts(senders, verdicts)
    assert [tuple(s) for s in pools[0].ready()] == [tuple(s) for s in pools[1].ready()]


class TestShamir:
    def test_lagrange_recovers_secret(self):
        secret = rng.randrange(mm.Q)
        shares = tpke._shamir_shares(
            secret, 7, 3, lambda k: rng.randbytes(k)
        )
        xs = [2, 5, 7]
        lams = tpke.lagrange_coeff_at_zero(xs)
        got = sum(l * shares[x - 1] for l, x in zip(lams, xs)) % mm.Q
        assert got == secret

    def test_fewer_than_threshold_insufficient(self):
        # t-1 shares give a different (wrong) interpolation
        secret = rng.randrange(mm.Q)
        shares = tpke._shamir_shares(secret, 7, 3, lambda k: rng.randbytes(k))
        xs = [1, 4]
        lams = tpke.lagrange_coeff_at_zero(xs)
        got = sum(l * shares[x - 1] for l, x in zip(lams, xs)) % mm.Q
        assert got != secret


@pytest.mark.parametrize("backend", sorted(ARMS))
class TestTpke:
    def _setup(self, backend, n=4, f=1, seed=5):
        pub, shares = tpke.deal(n, f + 1, seed=seed)
        return tpke.Tpke(pub, **ARMS[backend]), shares

    def test_encrypt_decrypt_roundtrip(self, backend):
        svc, shares = self._setup(backend)
        msg = b"proposal for epoch 9: " + bytes(range(100))
        ct = svc.encrypt(msg)
        dec = [svc.dec_share(s, ct) for s in shares]
        ok = svc.verify_dec_shares(ct, dec)
        assert ok == [True] * 4
        # any f+1 = 2 shares decrypt
        assert svc.combine(ct, [dec[1], dec[3]]) == msg
        assert svc.combine(ct, [dec[0], dec[2]]) == msg
        # the batched issue gives the same d for every ciphertext
        cts = [ct, svc.encrypt(b"second")]
        batch = svc.dec_share_batch(shares[2], cts)
        assert [s.d for s in batch] == [svc.dec_share(shares[2], c).d for c in cts]
        assert all(svc.verify_dec_shares(c, [s]) == [True] for c, s in zip(cts, batch))

    def test_bad_share_rejected(self, backend):
        svc, shares = self._setup(backend)
        ct = svc.encrypt(b"secret")
        good = svc.dec_share(shares[0], ct)
        forged = tpke.DhShare(index=2, d=good.d, e=good.e, z=good.z)
        wrong_d = tpke.DhShare(
            index=good.index, d=pow(good.d, 2, mm.P), e=good.e, z=good.z
        )
        oob = tpke.DhShare(index=99, d=good.d, e=good.e, z=good.z)
        ok = svc.verify_dec_shares(ct, [good, forged, wrong_d, oob])
        assert ok == [True, False, False, False]

    def test_share_for_other_ciphertext_rejected(self, backend):
        svc, shares = self._setup(backend)
        ct1 = svc.encrypt(b"one")
        ct2 = svc.encrypt(b"two")
        d1 = svc.dec_share(shares[0], ct1)
        assert svc.verify_dec_shares(ct2, [d1]) == [False]

    def test_tampered_ciphertext_fails_integrity(self, backend):
        svc, shares = self._setup(backend)
        ct = svc.encrypt(b"payload")
        bad = tpke.Ciphertext(
            c1=ct.c1, c2=bytes([ct.c2[0] ^ 1]) + ct.c2[1:], tag=ct.tag
        )
        dec = [svc.dec_share(s, bad) for s in shares[:2]]
        with pytest.raises(ValueError, match="integrity"):
            svc.combine(bad, dec)

    def test_too_few_shares_raises(self, backend):
        svc, shares = self._setup(backend)
        ct = svc.encrypt(b"x")
        with pytest.raises(ValueError, match="need >="):
            svc.combine(ct, [svc.dec_share(shares[0], ct)])


@pytest.mark.parametrize("backend", sorted(ARMS))
class TestCommonCoin:
    def test_agreement_across_share_subsets(self, backend):
        n, f = 7, 2
        pub, shares = tpke.deal(n, f + 1, seed=11)
        c = coin_mod.CommonCoin(pub, **ARMS[backend])
        cid = b"epoch3|proposer5|round0"
        all_shares = [c.share(s, cid) for s in shares]
        assert c.verify_shares(cid, all_shares) == [True] * n
        v1 = c.combine(cid, all_shares[:3])
        v2 = c.combine(cid, all_shares[4:7])
        v3 = c.combine(cid, [all_shares[0], all_shares[3], all_shares[6]])
        assert v1 == v2 == v3
        # the batched issue and verify: same d, same verdicts, same coin
        cids = [cid, b"epoch3|proposer5|round1"]
        batch = [c.share_batch(s, cids) for s in shares]
        assert [b[0].d for b in batch] == [s.d for s in all_shares]
        got = c.verify_shares_batch([(x, [b[i] for b in batch]) for i, x in enumerate(cids)])
        assert got == [[True] * n] * 2
        assert c.combine(cid, [b[0] for b in batch[2:5]]) == v1

    def test_different_ids_differ(self, backend):
        pub, shares = tpke.deal(4, 2, seed=12)
        c = coin_mod.CommonCoin(pub, **ARMS[backend])
        vals = set()
        for r in range(8):
            cid = b"round|%d" % r
            sh = [c.share(s, cid) for s in shares[:2]]
            vals.add(c.toss(cid, sh))
        assert vals == {True, False}  # 8 tosses, both outcomes seen

    def test_bad_coin_share_rejected(self, backend):
        pub, shares = tpke.deal(4, 2, seed=13)
        c = coin_mod.CommonCoin(pub, **ARMS[backend])
        cid = b"cid"
        good = c.share(shares[0], cid)
        evil = tpke.DhShare(index=1, d=good.d, e=good.e, z=(good.z + 1) % mm.Q)
        assert c.verify_shares(cid, [good, evil]) == [True, False]
        assert c.verify_shares_batch([(cid, [evil, good])]) == [[False, True]]


def test_keys_distinct_between_tpke_and_coin_seeds():
    pub_a, _ = tpke.deal(4, 2, seed=1)
    pub_b, _ = tpke.deal(4, 2, seed=2)
    assert pub_a.master != pub_b.master


class TestGroupMembership:
    """Ciphertext c1 values outside the prime-order subgroup must be
    rejected before share issuance."""

    def test_rejects_non_members(self):
        for bad in (0, 1, mm.P - 1, mm.P, mm.P + 5):
            assert not tpke.is_group_element(bad)

    def test_rejects_non_residue(self):
        # p = 2q+1 safe prime: non-residues have order 2q, x^q == -1
        x = next(
            x for x in range(2, 100) if pow(x, mm.Q, mm.P) == mm.P - 1
        )
        assert not tpke.is_group_element(x)

    def test_accepts_honest_values(self):
        assert tpke.is_group_element(mm.G)
        pub, _ = tpke.deal(4, 2, seed=3)
        assert tpke.is_group_element(pub.master)
        ct = tpke.Tpke(pub, **CUDA).encrypt(b"m")
        assert tpke.is_group_element(ct.c1)


class TestBatchedChallenge:
    def test_cp_challenge_batch_matches_scalar(self):
        """The batched CP-challenge path (ops/hashrows +
        _cp_challenge_batch) stays byte-identical to the scalar
        _hash_to_int transcript above the m < 64 cutoff."""
        import secrets as _s

        gp = mm.DEFAULT_GROUP
        nb = gp.nbytes
        ctxs, bases, his, ds, a1s, a2s = [], [], [], [], [], []
        m = 100
        for i in range(m):
            # mixed context lengths exercise the group-by-length path
            ctxs.append(b"ctx|%d" % (10 ** (i % 4)))
            for lst in (bases, his, ds, a1s, a2s):
                lst.append(int.from_bytes(_s.token_bytes(nb), "big") % gp.p)
        got = tpke._cp_challenge_batch(ctxs, bases, his, ds, a1s, a2s, gp)
        got_small = tpke._cp_challenge_batch(
            ctxs[:8], bases[:8], his[:8], ds[:8], a1s[:8], a2s[:8], gp
        )
        assert got_small == got[:8]
        for k in range(m):
            want = (
                tpke._hash_to_int(
                    b"cp", ctxs[k],
                    tpke._ibytes(bases[k], nb), tpke._ibytes(his[k], nb),
                    tpke._ibytes(ds[k], nb), tpke._ibytes(a1s[k], nb),
                    tpke._ibytes(a2s[k], nb),
                )
                % gp.q
            )
            assert got[k] == want


@pytest.mark.parametrize("backend", sorted(ARMS))
def test_groups_agree_with_single_calls(backend):
    """tests/test_hub.py's multi-group fold: a TPKE group and a coin
    group of other keys verify in one call as they do one by one."""
    pub_a, shares_a = tpke.deal(4, 2, seed=21)
    pub_b, shares_b = tpke.deal(7, 3, seed=22)
    svc_a = tpke.Tpke(pub_a, **ARMS[backend])
    ct = svc_a.encrypt(b"group-a")
    dss = [svc_a.dec_share(s, ct) for s in shares_a]
    coin = coin_mod.CommonCoin(pub_b, **ARMS[backend])
    cid = b"epoch|0"
    css = [coin.share(s, cid) for s in shares_b]
    # corrupt one share in each group
    dss[1] = tpke.DhShare(dss[1].index, dss[1].d, dss[1].e, dss[1].z + 1)
    css[4] = tpke.DhShare(css[4].index, css[4].d + 1, css[4].e, css[4].z)
    ga = (pub_a, ct.c1, dss, svc_a.context(ct))
    gb = coin.group_params(cid)[:2] + (css, coin.group_params(cid)[2])
    combined = tpke.verify_share_groups([ga, gb], **ARMS[backend])
    singles = [
        tpke.verify_shares(*ga, backend="cpu"),
        tpke.verify_shares(*gb, backend="cpu"),
    ]
    assert combined == singles
    assert combined[0] == [True, False, True, True]
    assert combined[1][4] is False and sum(combined[1]) == 6


class TestSharePool:
    def test_deferred_verdicts_flow(self):
        pub, shares = tpke.deal(4, 2, seed=23)
        svc = tpke.Tpke(pub, **CUDA)
        ct = svc.encrypt(b"pool")
        pool = tpke.SharePool(2)
        for i, s in enumerate(shares[:3]):
            assert pool.add(f"n{i}", svc.dec_share(s, ct))
        assert len(pool) == 3
        assert pool.ready() is None  # nothing verified yet
        senders, shs = pool.collect_pending()
        ok = svc.verify_dec_shares(ct, shs)
        pool.apply_verdicts(senders, ok)
        valid = pool.ready()
        assert valid is not None and len({v.index for v in valid}) >= 2
        # burned sender cannot resubmit after a bad verdict
        pool2 = tpke.SharePool(2)
        bad = tpke.DhShare(1, 2, 3, 4)
        pool2.add("evil", bad)
        s2, sh2 = pool2.collect_pending()
        pool2.apply_verdicts(s2, [False])
        assert not pool2.add("evil", svc.dec_share(shares[0], ct))

    def test_try_verified_compat(self):
        pub, shares = tpke.deal(4, 2, seed=24)
        svc = tpke.Tpke(pub, **CUDA)
        ct = svc.encrypt(b"compat")
        pool = tpke.SharePool(2)
        pool.add("a", svc.dec_share(shares[0], ct))
        assert pool.try_verified(lambda s: svc.verify_dec_shares(ct, s)) is None
        pool.add("b", svc.dec_share(shares[1], ct))
        valid = pool.try_verified(lambda s: svc.verify_dec_shares(ct, s))
        assert valid is not None and len(valid) == 2
