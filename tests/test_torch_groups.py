"""The crypto-group seam of the port: tests/test_groups.py's engine and
round-trip cases re-pointed at ``ModEngine('cuda')`` on a CPU device,
whose wide groups run the K12 kernels' plain PyTorch versions.

- every wide family (the 384-bit GROUP384, the 768-bit RFC 2409 Oakley
  group 1, the 2048-bit RFC 3526 MODP-14 group) against Python's
  ``pow`` at WIDE_BATCH, edge rows included;
- the plain wide pow and dual pow byte for byte against the reference's
  ``_wide_kernels(lay)`` (JAX on the CPU) on the same packed inputs;
- the full TPKE + coin round-trip under a second 256-bit group,
  GROUP384 and MODP-14;
- rejection past the 2112-bit family.

The reference's ``test_wide_floors_route_by_measured_crossover`` is not
ported: it pins TPU-relay host floors (``WIDE_FLOORS``) that the port
deliberately lacks — every 'cuda' batch goes to the device."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleisthenes_tpu.ops import modmath as ref_mm
from cleisthenes_tpu_torch.ops import modexp_cuda as mx
from cleisthenes_tpu_torch.ops import modmath as mm
from cleisthenes_tpu_torch.ops import tpke
from cleisthenes_tpu_torch.ops.coin import CommonCoin
from cleisthenes_tpu_torch.ops.modmath import GROUP384, GroupParams, get_engine

# Second 256-bit safe prime (the reference's test group), g = 4.
P2 = 0x93A40B764F1F5026ADA7C38AA3EF4EE81E01E89F9FE80837B1E370913DA99F13
GROUP2 = GroupParams(p=P2, q=(P2 - 1) // 2, g=4)

# RFC 3526 group 14: 2048-bit MODP safe prime (well-known constant).
MODP14 = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
GROUP14 = GroupParams(p=MODP14, q=(MODP14 - 1) // 2, g=4)

# RFC 2409 First Oakley Group (768-bit safe prime): the 792-bit family.
OAKLEY1 = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A63A3620FFFFFFFFFFFFFFFF",
    16,
)
GROUP768 = GroupParams(p=OAKLEY1, q=(OAKLEY1 - 1) // 2, g=4)

N, F = 7, 2
WIDE_BATCH = 24
CUDA = {"backend": "cuda", "device": "cpu"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain modexp versions are many small tensor ops: intra-op
    threads only add contention under the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine_kw(engine_backend: str) -> dict:
    return CUDA if engine_backend == "cuda" else {"backend": "cpu"}


def _roundtrip(group: GroupParams, engine_backend: str) -> None:
    """Full threshold-decryption + coin lifecycle under ``group``."""
    kw = _engine_kw(engine_backend)
    pub, shares = tpke.deal(N, F + 1, seed=9, group=group)
    assert pub.group is group
    assert tpke.is_group_element(pub.master, group)
    assert not tpke.is_group_element(group.p - 1, group)  # order-2 elt

    svc = tpke.Tpke(pub, backend=engine_backend)
    msg = b"the woods are lovely, dark and deep" * 3
    ct = svc.encrypt(msg)
    assert tpke.is_group_element(ct.c1, group)
    ctx = svc.context(ct)
    dec = tpke.issue_shares_batch(
        [(shares[i], ct.c1, ctx, pub.verification_keys[i]) for i in range(N)],
        group=group, **kw,
    )
    # a corrupted share must fail CP verification in this group too
    bad = tpke.DhShare(
        index=dec[0].index, d=dec[0].d, e=dec[0].e, z=(dec[0].z + 1) % group.q
    )
    verdicts, values, _ = tpke.verify_and_combine_share_groups(
        [(pub, ct.c1, dec, ctx), (pub, ct.c1, [bad], ctx)], pub.threshold, **kw
    )
    assert verdicts == [[True] * N, [False]]
    # any f+1 subset decrypts identically, fused or unfused combine
    assert svc.combine(ct, dec[: F + 1]) == msg
    assert svc.combine(ct, dec[F + 1 :]) == msg
    tpke._COMBINE_MEMO.clear()
    got = tpke.combine_shares_batch(
        [dec[: F + 1], dec[F + 1 :]], pub.threshold, group=group, **kw
    )
    assert got[0] == got[1] == values[0]

    # the common coin over the same group: identical bit from any
    # threshold subset, shares verifiable
    cpub, cshares = tpke.deal(N, F + 1, seed=10, group=group)
    coin = CommonCoin(cpub, backend=engine_backend)
    cid = b"epoch|instance|round0"
    _pub, base, cctx = coin.group_params(cid)
    cs = tpke.issue_shares_batch(
        [(cshares[i], base, cctx, cpub.verification_keys[i]) for i in range(N)],
        group=group, **kw,
    )
    cverdicts, _, _ = tpke.verify_and_combine_share_groups(
        [(cpub, base, cs, cctx)], cpub.threshold, **kw
    )
    assert cverdicts == [[True] * N]
    bits = {coin.toss(cid, subset) for subset in (cs[: F + 1], cs[F + 1 :])}
    assert len(bits) == 1


def test_second_256bit_prime_cpu_engine():
    _roundtrip(GROUP2, "cpu")


def test_second_256bit_prime_cuda_engine():
    _roundtrip(GROUP2, "cuda")


def test_2048bit_modp14_cpu_only():
    _roundtrip(GROUP14, "cpu")


@pytest.mark.parametrize(
    "group,seed,batch",
    [(GROUP384, 7, WIDE_BATCH), (GROUP768, 6, WIDE_BATCH), (GROUP14, 5, WIDE_BATCH),
     (GROUP384, 8, 1), (GROUP384, 9, 33)],
    ids=["384", "768", "2048", "384-B1", "384-B33"],
)
def test_wide_group_cuda_engine_matches_pow(group, seed, batch):
    """Every wide family on the 'cuda' engine (the K12 plain versions
    on a CPU device) against Python's pow, with edge rows: bases 0, 1,
    p - 1 and unreduced, exponents 0, 1, q, 5 and all-ones, and
    Lagrange-style dual rows (u2 = 1, e2 = 0); and batches that are not
    a multiple of a team, a warp or a block of the kernels (1, 33)."""
    rng = random.Random(seed)
    p, q = group.p, group.q
    eng = get_engine("cuda", group, device="cpu")
    assert eng.backend == "cuda" and eng.device == torch.device("cpu")
    ones = (1 << (8 * mm.layout_for_group(group))) - 1
    bases = [0, 1, p - 1, p + 3, 2][:batch] + [
        rng.randrange(2, p) for _ in range(batch - 5)
    ]
    exps = [0, 1, q, 5, ones][:batch] + [rng.randrange(1, q) for _ in range(batch - 5)]
    assert eng.pow_batch(bases, exps) == [pow(b, e, p) for b, e in zip(bases, exps)]
    h = (batch + 1) // 2
    lag = min(3, h)
    u2 = (bases[h:] + bases)[: h - lag] + [1] * lag
    e2 = (exps[h:] + exps)[: h - lag] + [0] * lag
    got = eng.dual_pow_batch(bases[:h], exps[:h], u2, e2)
    assert got == [
        pow(a, x, p) * pow(b, y, p) % p
        for a, x, b, y in zip(bases[:h], exps[:h], u2, e2)
    ]


@pytest.mark.parametrize("group", [GROUP384, GROUP768], ids=["384", "768"])
def test_wide_plain_matches_reference_wide_kernels(group):
    """The plain K12 pow and dual pow against the reference's
    ``_wide_kernels(lay)`` on the same packed inputs, byte for byte, and
    against Python's ``pow``: bases 0, 1, p - 1; exponents q, 0, 1 and
    all-ones; e2 = 0 beside e1 != 0 and e1 = 0 beside e2 != 0."""
    rng = random.Random(group.p.bit_length())
    lay = ref_mm.layout_for_group(ref_mm.GroupParams(p=group.p, q=group.q, g=group.g))
    vb, b = lay.val_bytes, 12
    assert vb == mm.layout_for_group(group)
    p, q = group.p, group.q
    ones = (1 << (8 * vb)) - 1
    ints = (
        [0, 1, p - 1] + [rng.randrange(p) for _ in range(b - 3)],
        [q, 0, 1, ones] + [rng.randrange(q) for _ in range(b - 4)],
        [rng.randrange(p) for _ in range(b)],
        [0, 5, 0, ones] + [rng.randrange(q) for _ in range(b - 4)],
    )
    u1, u2 = (mm._ints_to_val_bytes(x, vb) for x in ints[::2])
    e1, e2 = (mm._exps_to_bytes_w(x, vb) for x in ints[1::2])
    ref_spec = ref_mm._spec_wide(
        ref_mm.GroupParams(p=group.p, q=group.q, g=group.g), lay
    )
    xla_spec = (
        jnp.asarray(ref_spec[0]), jnp.int32(ref_spec[1]),
        jnp.asarray(ref_spec[2]), jnp.asarray(ref_spec[3]),
    )
    ref_pow, ref_dual = ref_mm._wide_kernels(lay)
    spec = mx.wide_spec(group.p, vb)

    def t(a):
        return torch.from_numpy(np.array(a))

    def as_ints(rows):
        return [int.from_bytes(r.tobytes(), "little") for r in rows]

    want = np.asarray(ref_pow(jnp.asarray(u1), jnp.asarray(e1), *xla_spec))
    got = mx.wide_pow_fused(t(u1), t(e1), spec).numpy()
    assert got.shape == (b, vb) and np.array_equal(got, want)
    assert as_ints(got) == [pow(x, e, p) for x, e in zip(ints[0], ints[1])]
    want = np.asarray(
        ref_dual(jnp.asarray(u1), jnp.asarray(e1), jnp.asarray(u2),
                 jnp.asarray(e2), *xla_spec)
    )
    got = mx.wide_dual_pow_fused(t(u1), t(e1), t(u2), t(e2), spec).numpy()
    assert np.array_equal(got, want)
    assert as_ints(got) == [pow(a, x, p) * pow(c, y, p) % p for a, x, c, y in zip(*ints)]


def test_384bit_group_full_protocol_cuda():
    """The whole TPKE + coin round-trip under the 384-bit group on the
    'cuda' engine."""
    _roundtrip(GROUP384, "cuda")


def test_2048bit_modp14_full_protocol_cuda():
    """... and under the 2048-bit MODP-14 group (the widest family)."""
    _roundtrip(GROUP14, "cuda")


def test_wide_grouped_flattens_to_one_wide_pow(monkeypatch):
    """A wide group's grouped call is one wide pow dispatch (the comb is
    256-bit only), with its bases reduced mod p on the host."""
    eng = mm.ModEngine("cuda", group=GROUP384, device="cpu")
    seen = []
    for name in ("pow_fused_grouped", "pow_fused", "wide_pow_fused"):
        real = getattr(mx, name)
        monkeypatch.setattr(
            mx, name,
            lambda *a, _n=name, _r=real: seen.append((_n, a[0].shape)) or _r(*a),
        )
    rnd = random.Random(3)
    groups = [
        (GROUP384.p + 2, [rnd.randrange(GROUP384.q) for _ in range(40)]),
        (rnd.randrange(2**400), [rnd.randrange(GROUP384.q) for _ in range(30)]),
    ]
    got = eng.pow_batch_grouped(groups)
    assert got == [[pow(b, e, GROUP384.p) for e in exps] for b, exps in groups]
    assert seen == [("wide_pow_fused", (70, 48))]


def test_cuda_engine_family_routing():
    """The smallest family that hosts a modulus, by bit length; the
    257- to 264-bit moduli go to the 384-bit family (csrc/modexp.cu's
    R is 2^256)."""
    def fam(bits):
        p = (1 << (bits - 1)) + 1
        return mm.layout_for_group(GroupParams(p=p, q=(p - 1) // 2, g=4))

    assert fam(2) == fam(256) == mx.MontSpec.val_bytes == 33
    assert fam(257) == fam(384) == 48
    assert fam(385) == fam(792) == 99
    assert fam(793) == fam(2112) == 264
    assert fam(2113) is None
    eng = get_engine("cuda", GROUP384, device="cpu")
    assert eng._spec.nw == 12 and eng._spec.val_bytes == 48
    assert get_engine("cuda", GROUP14, device="cpu")._spec.nw == 66
    assert get_engine("cuda", GROUP768, device="cpu")._spec.nw == 25


def test_cuda_engine_still_rejects_beyond_every_family():
    """Past the widest family a 'cuda' engine raises (a matching-anyway
    bug would silently truncate words); the degraded getter takes the
    host engine."""
    p_huge = (1 << 3000) + 117  # odd, 3001 bits > 2112-bit family
    g_huge = GroupParams(p=p_huge, q=(p_huge - 1) // 2, g=4)
    assert mm.layout_for_group(g_huge) is None and not mm.cuda_capable(g_huge)
    with pytest.raises(ValueError, match="family"):
        get_engine("cuda", g_huge, device="cpu")
    with pytest.raises(ValueError, match="family"):
        mx.wide_spec(p_huge, 264)
    assert mm.get_engine_degraded("cuda", g_huge, device="cpu").backend == "cpu"


def test_wide_spec_words():
    """The K12 kernels' constants: p, -p^-1 mod 2^32, R mod p and
    R^2 mod p for R = 2^(32 nw), in nw little-endian words."""
    for p, vb, nw in ((GROUP384.p, 48, 12), (OAKLEY1, 99, 25), (MODP14, 264, 66)):
        spec = mx.wide_spec(p, vb)
        w = [int(v) for v in spec.words]
        assert spec.nw == nw and len(w) == 3 * nw + 1

        def val(lo, _w=w, _nw=nw):
            return sum(x << (32 * i) for i, x in enumerate(_w[lo : lo + _nw]))

        r = 2 ** (32 * nw)
        assert val(0) == p and (w[nw] * p) % 2**32 == 2**32 - 1
        assert (val(nw + 1), val(2 * nw + 1)) == (r % p, r * r % p)
    for p, vb in ((GROUP384.p, 33), (OAKLEY1, 48), (MODP14 - 1, 264)):
        with pytest.raises(ValueError):
            mx.wide_spec(p, vb)


def test_wide_empty_and_misshapen_inputs():
    spec = mx.wide_spec(GROUP384.p, 48)
    e48 = torch.zeros((0, 48), dtype=torch.uint8)
    assert mx.wide_pow_fused(e48, e48, spec).shape == (0, 48)
    assert mx.wide_dual_pow_fused(e48, e48, e48, e48, spec).shape == (0, 48)
    two = torch.zeros((2, 48), dtype=torch.uint8)
    with pytest.raises(ValueError):
        mx.wide_pow_fused(two, torch.zeros((2, 32), dtype=torch.uint8), spec)
    with pytest.raises(ValueError):
        mx.wide_dual_pow_fused(two, two, two, torch.zeros((3, 48), dtype=torch.uint8), spec)
    with pytest.raises(ValueError):
        mx.wide_pow_fused(two.to(torch.int32), two, spec)


def test_groups_are_isolated():
    """Shares dealt in one group must not verify under a key from
    another (the transcript binds the group via element widths and
    reductions)."""
    pub_a, shares_a = tpke.deal(N, F + 1, seed=9, group=GROUP2)
    pub_b, _ = tpke.deal(N, F + 1, seed=9)  # default group
    svc_a = tpke.Tpke(pub_a, backend="cpu")
    ct = svc_a.encrypt(b"x" * 32)
    share = tpke.issue_shares_batch(
        [(shares_a[0], ct.c1, svc_a.context(ct), None)], group=GROUP2, **CUDA
    )[0]
    verdicts, _, _ = tpke.verify_and_combine_share_groups(
        [(pub_b, ct.c1 % pub_b.group.p, [share], svc_a.context(ct))],
        pub_b.threshold, **CUDA,
    )
    assert verdicts == [[False]]
