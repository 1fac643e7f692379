"""The port's GJKR DKG (cleisthenes_tpu_torch.ops.dkg) against the
reference's.

tests/test_dkg.py's cases run on the port's two engine arms: ``'cpu'``
(the native host Montgomery kernel) and ``'cuda'`` on a CPU device, where
every ``pow_batch`` runs the modexp kernels' plain PyTorch versions (K7's
for the 256-bit group, K12's wide pow for GROUP384).  Left out:
``test_cluster_runs_on_dkg_keys``, which needs the asynchronous protocol
plane (``SimulatedCluster``, ``setup_keys``, ``NodeKeys``) that the port
does not have yet.

The parity cases run the reference's ``run_dkg`` and the port's at the
same seed, with no fault knob and with each knob, and compare the public
key, every share and the qualified set integer for integer: the seeded
coefficient stream is the same bytes in both packages.  Rosters stay at
n <= 7, so the plain modexp versions take seconds."""

import functools

import pytest
import torch

from cleisthenes_tpu.ops import dkg as ref_dkg
from cleisthenes_tpu_torch.ops import dkg, tpke
from cleisthenes_tpu_torch.ops.coin import CommonCoin
from cleisthenes_tpu_torch.ops.modmath import DEFAULT_GROUP, GROUP384

ARMS = {"cpu": {"backend": "cpu"}, "cuda": {"backend": "cuda", "device": "cpu"}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain modexp versions are ~20 small int64 ops per Montgomery
    product: intra-op threads only add contention (the suite runs
    several workers on the same cores), so these tests run on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=sorted(ARMS))
def arm(request):
    return ARMS[request.param]


def _ints(result):
    """(pub, shares, qualified) as plain integers, group included."""
    pub, shares, qualified = result
    return (
        (pub.n, pub.threshold, pub.master, tuple(pub.verification_keys),
         pub.group.p, pub.group.q, pub.group.g),
        [(s.index, s.value) for s in shares],
        list(qualified),
    )


# -- tests/test_dkg.py, re-pointed at the port -------------------------


def test_dkg_keys_reconstruct_and_decrypt(arm):
    pub, shares, qualified = dkg.run_dkg(n=5, threshold=3, seed=7, **arm)
    assert qualified == [1, 2, 3, 4, 5]
    # verification keys really are g^{x_j}
    gp = pub.group
    for sh in shares:
        assert pow(gp.g, sh.value, gp.p) == pub.verification_keys[sh.index - 1]
    # TPKE end to end on the DKG key set
    svc = tpke.Tpke(pub, **arm)
    ct = svc.encrypt(b"no dealer was harmed in the making of this key")
    dec = [svc.dec_share(sh, ct) for sh in shares[:3]]
    assert all(svc.verify_dec_shares(ct, dec))
    assert (
        svc.combine(ct, dec)
        == b"no dealer was harmed in the making of this key"
    )
    # subset independence: any t shares combine to the same plaintext
    dec2 = [svc.dec_share(sh, ct) for sh in shares[2:]]
    assert svc.combine(ct, dec2) == svc.combine(ct, dec)


def test_dkg_coin_tosses_agree(arm):
    pub, shares, _ = dkg.run_dkg(n=4, threshold=2, seed=9, **arm)
    coin = CommonCoin(pub, **arm)
    cid = b"dkg-coin|0"
    sh = [coin.share(s, cid) for s in shares]
    assert all(coin.verify_shares(cid, sh))
    t1 = coin.toss(cid, sh[:2])
    t2 = coin.toss(cid, sh[2:])
    assert t1 == t2  # any threshold subset yields the network bit


def test_dkg_disqualifies_corrupt_dealer(arm):
    pub, shares, qualified = dkg.run_dkg(
        n=5, threshold=3, seed=11, corrupt_dealers=[4], **arm
    )
    assert qualified == [1, 2, 3, 5]
    svc = tpke.Tpke(pub, **arm)
    ct = svc.encrypt(b"qualified-set key still works")
    dec = [svc.dec_share(sh, ct) for sh in shares[:3]]
    assert svc.combine(ct, dec) == b"qualified-set key still works"


def test_dkg_too_many_corrupt_dealers_fails_loudly(arm):
    with pytest.raises(RuntimeError):
        dkg.run_dkg(n=3, threshold=3, seed=2, corrupt_dealers=[1], **arm)


def test_dkg_share_verification_rejects_tampering(arm):
    d = dkg.DkgDealing(1, 4, 2, seed=5)
    commits = d.commitments(**arm)
    good = d.share_for(2)
    ok = dkg.verify_dealer_shares(
        [(commits, 2, good), (commits, 2, good + 1), (commits, 3, good)],
        **arm,
    )
    assert ok == [True, False, False]  # wrong value / wrong receiver


def test_non_subgroup_commitment_disqualifies_dealer(arm):
    """A commitment with an order-2 component must disqualify its
    dealer deterministically BEFORE exponent arithmetic — otherwise
    the mod-q-reduced verification equation evaluates inconsistently
    across receivers and honest nodes' qualified sets diverge."""
    gp = DEFAULT_GROUP
    d = dkg.DkgDealing(1, 4, 2, seed=5)
    good = d.commitments(**arm)
    # p-1 has order 2: not in the QR subgroup
    assert dkg.validate_commitments([good, [good[0], gp.p - 1]], **arm) == [
        True,
        False,
    ]
    # 0 and 1 are rejected too (identity/degenerate)
    assert dkg.validate_commitments([[1, good[1]], [0, good[1]]], **arm) == [
        False,
        False,
    ]


def test_gjkr_pedersen_generator_in_subgroup():
    gp = DEFAULT_GROUP
    h = dkg.pedersen_generator(gp)
    assert 1 < h < gp.p and h != gp.g
    assert pow(h, gp.q, gp.p) == 1  # order-q element
    # the reference derives the same nothing-up-my-sleeve h
    assert h == ref_dkg.pedersen_generator(ref_dkg.DEFAULT_GROUP)


def test_gjkr_phase1_broadcast_hides_the_secret(arm):
    """Pedersen commitments are not the Feldman ones: the phase-1
    broadcast must not expose g^{a_k} (that exposure is exactly the
    Joint-Feldman rushing-bias channel)."""
    d = dkg.PedersenDealing(1, 4, 3, seed=5)
    ped = d.pedersen_commitments(**arm)
    feld = d.commitments(**arm)
    assert all(e != a for e, a in zip(ped, feld))
    # and the pair verification really binds both polynomials
    s, s2 = d.share_pair_for(2)
    ok = dkg.verify_pedersen_shares(
        [(ped, 2, s, s2), (ped, 2, s + 1, s2), (ped, 2, s, s2 + 1)], **arm
    )
    assert ok == [True, False, False]


def test_gjkr_rushing_adversary_cannot_move_the_key(arm):
    """Once phase one fixes Q, a phase-2 cheater is reconstructed, stays
    in Q, and the final public state is IDENTICAL to the all-honest
    run."""
    honest_pub, honest_shares, honest_q = dkg.run_dkg(
        n=5, threshold=3, seed=13, **arm
    )
    pub, shares, qualified = dkg.run_dkg(
        n=5, threshold=3, seed=13, phase2_cheaters=[5], **arm
    )
    assert qualified == honest_q == [1, 2, 3, 4, 5]  # NOT disqualified
    assert pub == honest_pub  # master key and all vks unmoved
    assert [s.value for s in shares] == [s.value for s in honest_shares]
    # and the reconstructed-key system still decrypts end to end
    svc = tpke.Tpke(pub, **arm)
    ct = svc.encrypt(b"phase-2 abort moves nothing")
    dec = [svc.dec_share(sh, ct) for sh in shares[1:4]]
    assert svc.combine(ct, dec) == b"phase-2 abort moves nothing"


def test_gjkr_false_accuser_cannot_split_q(arm):
    """A Byzantine receiver complains against every dealer; each honest
    dealer reveals the disputed pair and survives, so Q is unchanged."""
    honest_pub, _, _ = dkg.run_dkg(n=5, threshold=3, seed=17, **arm)
    pub, shares, qualified = dkg.run_dkg(
        n=5, threshold=3, seed=17, false_accusers=[2], **arm
    )
    assert qualified == [1, 2, 3, 4, 5]
    assert pub == honest_pub


def test_gjkr_corrupt_dealer_plus_slander_plus_phase2_abort(arm):
    """Dealer 4 cheats in phase 1 (disqualified), receiver 2 slanders
    everyone (ignored), dealer 5 aborts phase 2 (reconstructed)."""
    pub, shares, qualified = dkg.run_dkg(
        n=6,
        threshold=3,
        seed=19,
        corrupt_dealers=[4],
        false_accusers=[2],
        phase2_cheaters=[5],
        **arm,
    )
    assert qualified == [1, 2, 3, 5, 6]
    gp = pub.group
    for sh in shares:
        assert pow(gp.g, sh.value, gp.p) == pub.verification_keys[sh.index - 1]
    svc = tpke.Tpke(pub, **arm)
    ct = svc.encrypt(b"three adversaries, one key")
    dec = [svc.dec_share(sh, ct) for sh in shares[:3]]
    assert all(svc.verify_dec_shares(ct, dec))
    assert svc.combine(ct, dec) == b"three adversaries, one key"


def test_gjkr_wrong_length_opening_reconstructed(arm):
    """A phase-2 opening with t-1 entries hits the length guard and is
    reconstructed like any bad opening; the outcome is the honest one."""
    honest_pub, honest_shares, honest_q = dkg.run_dkg(
        n=5, threshold=3, seed=23, **arm
    )
    pub, shares, qualified = dkg.run_dkg(
        n=5, threshold=3, seed=23, phase2_short_openers=[2], **arm
    )
    assert qualified == honest_q == [1, 2, 3, 4, 5]
    assert pub == honest_pub
    assert [s.value for s in shares] == [s.value for s in honest_shares]


def test_gjkr_group384_xla_matches_cpu(jax_cpu_devices, monkeypatch):
    """The whole two-phase DKG in GROUP384: the reference's 'tpu' arm on
    JAX-CPU (host delegation pinned off, as its own test runs it), the
    port's 'cpu' arm and its 'cuda' arm on a CPU device (K12's wide pow,
    plain version) give the same keys integer for integer."""
    from cleisthenes_tpu.ops.modmath import GROUP384 as REF_GROUP384
    from cleisthenes_tpu.ops.modmath import ModEngine as RefEngine

    monkeypatch.setattr(RefEngine, "host_delegation", False)
    ref = ref_dkg.run_dkg(
        n=4, threshold=2, seed=29, group=REF_GROUP384, backend="tpu"
    )
    pub_c, shares_c, q_c = dkg.run_dkg(
        n=4, threshold=2, seed=29, group=GROUP384, backend="cpu"
    )
    pub_t, shares_t, q_t = dkg.run_dkg(
        n=4, threshold=2, seed=29, group=GROUP384, **ARMS["cuda"]
    )
    assert q_c == q_t and pub_c == pub_t
    assert [s.value for s in shares_c] == [s.value for s in shares_t]
    assert _ints((pub_t, shares_t, q_t)) == _ints(ref)
    svc = tpke.Tpke(pub_t, **ARMS["cuda"])
    ct = svc.encrypt(b"wide-group dkg end to end")
    dec = [svc.dec_share(sh, ct) for sh in shares_t[:2]]
    assert svc.combine(ct, dec) == b"wide-group dkg end to end"


# -- parity with the reference, knob by knob ---------------------------

# one fault knob at a time, each naming its own dealer or receiver
KNOBS = {
    (4, 2): {
        "corrupt_dealers": [2],
        "false_accusers": [3],
        "phase2_cheaters": [4],
        "phase2_short_openers": [1],
    },
    (7, 3): {
        "corrupt_dealers": [4],
        "false_accusers": [2],
        "phase2_cheaters": [5],
        "phase2_short_openers": [6],
    },
}
PARITY = [
    (n, t, knob)
    for (n, t) in sorted(KNOBS)
    for knob in [None] + sorted(KNOBS[(n, t)])
]


@functools.lru_cache(maxsize=None)
def _reference_run(n, t, knob):
    kw = {} if knob is None else {knob: KNOBS[(n, t)][knob]}
    return _ints(ref_dkg.run_dkg(n=n, threshold=t, seed=31 + n, **kw))


@pytest.mark.parametrize("n,t,knob", PARITY)
def test_run_dkg_matches_reference(arm, n, t, knob):
    kw = {} if knob is None else {knob: KNOBS[(n, t)][knob]}
    ours = _ints(dkg.run_dkg(n=n, threshold=t, seed=31 + n, **kw, **arm))
    want = _reference_run(n, t, knob)
    assert ours == want
    if knob == "corrupt_dealers":
        assert KNOBS[(n, t)][knob][0] not in ours[2]
    else:
        assert ours[2] == list(range(1, n + 1))


def test_defaults_need_a_gpu():
    """The defaults (backend='cuda', device='cuda') run on the card: on a
    machine without one, run_dkg and the dealer's engine calls raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default runs there")
    d = dkg.PedersenDealing(1, 4, 2, seed=5)
    for call in (
        lambda: dkg.run_dkg(n=4, threshold=2, seed=1),
        lambda: dkg.run_dkg(n=4, threshold=2, seed=1, backend="cuda"),
        lambda: dkg.run_dkg(n=4, threshold=2, seed=1, group=GROUP384),
        d.commitments,
        d.pedersen_commitments,
        lambda: dkg.validate_commitments([[4, 16]]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
