"""Distributed key generation: threshold keys without the dealer.

The one trust assumption this framework inherits from the reference's
design docs is the trusted dealer (reference
docs/THRESHOLD_ENCRYPTION-EN.md:33 assumes "SetUp" hands out shares;
ops/tpke.py's ``deal`` implements exactly that).  This module removes
it: GJKR DKG over the same prime-order group, where every participant
acts as a dealer of a random secret and the final key is the sum of
the QUALIFIED dealings.

Per participant i (threshold t, roster 1..n):

  phase 1 (hiding — fixes WHO contributes and hence the secret):
  1. sample f_i(x), f'_i(x) of degree t-1 over Z_q
  2. broadcast Pedersen commitments E_ik = g^{a_ik} h^{b_ik}  (k < t)
  3. send (s_ij, s'_ij) = (f_i(j), f'_i(j)) to j over a private channel
  4. j accepts iff g^{s_ij} h^{s'_ij} == prod_k E_ik^{j^k}; complaints
     are resolved by public dealer reveal (justified complaints); the
     qualified set Q — and therefore x = sum_{i in Q} a_i0 — is fixed

  phase 2 (extraction — reveals g^x without letting anyone change x):
  5. each i in Q opens Feldman commitments A_ik = g^{a_ik}, checked
     against the phase-1 shares; misbehavers are RECONSTRUCTED, not
     dropped.  j's final share is x_j = sum_{i in Q} s_ij, the master
     key y = prod_{i in Q} A_i0, and every verification key
     h_j = prod_{i in Q} prod_k A_ik^{j^k} is PUBLICLY computable —
     so the output is a drop-in ``ThresholdPublicKey`` +
     ``ThresholdSecretShare`` pair for TPKE and the common coin.

Security: ``run_dkg`` implements the GJKR two-phase variant (Gennaro,
Jarecki, Krawczyk, Rabin 1999), not plain Joint-Feldman.  Phase one
deals under PEDERSEN commitments E_k = g^{a_k} h^{b_k} (perfectly
hiding — no function of the secrets leaks), fixes the qualified set Q
through a justified-complaint round, and thereby pins the final secret
x = sum_{i in Q} a_i0 BEFORE any g^{a_i0} is revealed; a rushing
adversary who waits to move last learns nothing it can condition its
dealing on, so the key is uniform.  Phase two extracts y = g^x: each
qualified dealer opens Feldman commitments A_k = g^{a_k}, checked
against the phase-one shares; a dealer who misbehaves HERE is not
disqualified (that would let it bias the key by selective abort) —
its polynomial is reconstructed from the honest receivers' verified
phase-one shares and its contribution included regardless.

Complaints are JUSTIFIED: a complaint alone never disqualifies.  The
accused dealer reveals the disputed share pair publicly; every node
checks the reveal against the broadcast commitments and disqualifies
only on verifiable evidence (invalid reveal / silence), so all honest
nodes derive the IDENTICAL Q — a false accuser cannot split the
qualified set, and an honest-but-accused dealer survives.

The share transport must be private and the commitment/complaint
transport must be a broadcast channel: this module produces and
verifies the protocol's VALUES and leaves carriage to the caller
(tests drive it in-process; a deployment pumps the same steps over
RBC for broadcasts and key-agreed channels for shares).

All verification exponentiations batch through the ModEngine seam —
one ``pow_batch`` for a whole roster's share checks, one for the full
verification-key table — same as every other crypto plane in ops/.

This is the PyTorch port's copy of ``cleisthenes_tpu/ops/dkg.py``.  Its
calls take the engine's ``backend`` and ``device`` beside the
reference's ``mesh``, and default to ``backend='cuda'``, ``device='cuda'``:
every ``pow_batch`` then runs on the card, in the generic pow (K7) for a
256-bit group and the wide pow (K12) for a 257-2112-bit one; on a
machine without a GPU the defaults raise.  A seed gives the same
coefficient stream, hence the same keys, in both packages.
"""

from __future__ import annotations

import hashlib
import secrets as _secrets
from typing import Dict, List, Optional, Sequence, Tuple

import functools

from cleisthenes_tpu_torch.ops.modmath import (
    DEFAULT_GROUP,
    GroupParams,
    get_engine_degraded,
)
from cleisthenes_tpu_torch.ops.tpke import (
    ThresholdPublicKey,
    ThresholdSecretShare,
)


def _sample_coeffs(
    group: GroupParams,
    threshold: int,
    seed: Optional[int],
    dealer_index: int,
    tag: bytes,
) -> List[int]:
    """t coefficients over Z_q: CSPRNG when unseeded, a domain-tagged
    SHA-256 counter stream when seeded (tests/replays).  Excess bytes
    keep the mod-q reduction unbiased."""
    q = group.q
    nb = group.nbytes + 8
    if seed is None:
        rnd = _secrets.token_bytes  # staticcheck: allow[DET001] unseeded DKG keygen
    else:
        ctr = [0]

        def rnd(k: int, _s=seed, _d=dealer_index) -> bytes:
            out = b""
            while len(out) < k:
                ctr[0] += 1
                out += hashlib.sha256(
                    tag + b"|%d|%d|%d" % (_s, _d, ctr[0])
                ).digest()
            return out[:k]

    return [
        int.from_bytes(rnd(nb), "big") % q for _ in range(threshold)
    ]


def _eval_poly(coeffs: Sequence[int], x: int, q: int) -> int:
    """Horner evaluation of sum_k coeffs[k] x^k over Z_q."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % q
    return acc


class DkgDealing:
    """One participant's dealer role: polynomial + commitments + the
    per-receiver shares."""

    def __init__(
        self,
        dealer_index: int,
        n: int,
        threshold: int,
        group: GroupParams = DEFAULT_GROUP,
        seed: Optional[int] = None,
    ) -> None:
        if not (1 <= threshold <= n):
            raise ValueError(f"need 1 <= t <= n, got t={threshold} n={n}")
        self.dealer_index = dealer_index
        self.n = n
        self.threshold = threshold
        self.group = group
        self._coeffs = _sample_coeffs(
            group, threshold, seed, dealer_index, b"dkg"
        )

    def commitments(self, backend: str = "cuda", device="cuda", mesh=None) -> List[int]:
        """Feldman commitments A_k = g^{a_k}.

        Under the GJKR flow these are the PHASE-2 opening: they must
        stay private until the qualified set Q is fixed — broadcasting
        them alongside the phase-1 Pedersen commitments reopens the
        Joint-Feldman rushing-bias channel the two-phase structure
        exists to close.  (Standalone Feldman-VSS uses, e.g. the unit
        tests, may broadcast them immediately.)"""
        gp = self.group
        eng = get_engine_degraded(backend, gp, device, mesh)
        return eng.pow_batch([gp.g] * len(self._coeffs), self._coeffs)

    def share_for(self, receiver_index: int) -> int:
        """s_ij = f_i(j) — send PRIVATELY to participant j (1-based)."""
        if not (1 <= receiver_index <= self.n):
            raise ValueError(f"receiver index {receiver_index} out of roster")
        return _eval_poly(self._coeffs, receiver_index, self.group.q)


class PedersenDealing(DkgDealing):
    """GJKR phase-one dealer role: a second blinding polynomial
    f'_i(x) alongside f_i(x), Pedersen commitments E_k = g^{a_k}
    h^{b_k}, and (s, s') share pairs.  The Feldman opening A_k =
    g^{a_k} (phase two) comes from the inherited ``commitments``."""

    def __init__(
        self,
        dealer_index: int,
        n: int,
        threshold: int,
        group: GroupParams = DEFAULT_GROUP,
        seed: Optional[int] = None,
    ) -> None:
        super().__init__(dealer_index, n, threshold, group, seed=seed)
        self._coeffs2 = _sample_coeffs(
            group, threshold, seed, dealer_index, b"dkg-blind"
        )

    def pedersen_commitments(
        self, backend: str = "cuda", device="cuda",
        mesh=None,
    ) -> List[int]:
        """E_k = g^{a_k} h^{b_k} — the phase-one broadcast.  Perfectly
        hiding: reveals NOTHING about the a_k until phase two."""
        gp = self.group
        h = pedersen_generator(gp)
        eng = get_engine_degraded(backend, gp, device, mesh)
        t = len(self._coeffs)
        pows = eng.pow_batch(
            [gp.g] * t + [h] * t, self._coeffs + self._coeffs2
        )
        return [pows[k] * pows[t + k] % gp.p for k in range(t)]

    def share_pair_for(self, receiver_index: int) -> Tuple[int, int]:
        """(f_i(j), f'_i(j)) — send PRIVATELY to participant j."""
        if not (1 <= receiver_index <= self.n):
            raise ValueError(f"receiver index {receiver_index} out of roster")
        return self.share_for(receiver_index), _eval_poly(
            self._coeffs2, receiver_index, self.group.q
        )


def verify_pedersen_shares(
    items: Sequence[tuple],
    group: GroupParams = DEFAULT_GROUP,
    backend: str = "cuda",
    device="cuda",
    mesh=None,
) -> List[bool]:
    """Batched GJKR phase-one checks: ``items`` is a sequence of
    ``(pedersen_commitments, receiver_index, share, blind_share)`` and
    every g^{s} h^{s'} == prod_k E_k^{j^k} test runs from one batched
    dispatch.  Commitment vectors must be pre-validated
    (validate_commitments) for the same reason as the Feldman path."""
    if not items:
        return []
    gp = group
    h = pedersen_generator(gp)
    eng = get_engine_degraded(backend, gp, device, mesh)
    bases: List[int] = []
    exps: List[int] = []
    spans: List[int] = []
    for commitments, j, share, blind in items:
        t = len(commitments)
        if t == 0:
            spans.append(0)
            continue
        jk = _commit_eval_exps(j, t, gp.q)
        bases.extend(c % gp.p for c in commitments)
        exps.extend(jk)
        bases.append(gp.g)
        exps.append(share % gp.q)
        bases.append(h)
        exps.append(blind % gp.q)
        spans.append(t + 2)
    pows = eng.pow_batch(bases, exps)
    out: List[bool] = []
    off = 0
    for span in spans:
        if span == 0:
            out.append(False)
            continue
        prod = 1
        for v in pows[off : off + span - 2]:
            prod = prod * v % gp.p
        lhs = pows[off + span - 2] * pows[off + span - 1] % gp.p
        off += span
        out.append(lhs == prod)
    return out


def _interpolate_coeffs(
    points: Sequence[Tuple[int, int]], q: int
) -> List[int]:
    """Coefficients of the unique degree-(len(points)-1) polynomial
    through ``points`` over Z_q (Lagrange basis, expanded).  Phase-two
    reconstruction: t verified shares of a misbehaving-but-qualified
    dealer pin its whole polynomial, hence its Feldman opening."""
    t = len(points)
    coeffs = [0] * t
    for m, (xm, ym) in enumerate(points):
        # basis polynomial prod_{l != m} (x - x_l) / (x_m - x_l)
        basis = [1]
        denom = 1
        for l, (xl, _) in enumerate(points):
            if l == m:
                continue
            # multiply basis by (x - xl)
            nxt = [0] * (len(basis) + 1)
            for d, c in enumerate(basis):
                nxt[d] = (nxt[d] - c * xl) % q
                nxt[d + 1] = (nxt[d + 1] + c) % q
            basis = nxt
            denom = denom * (xm - xl) % q
        scale = ym * pow(denom, -1, q) % q
        for d, c in enumerate(basis):
            coeffs[d] = (coeffs[d] + c * scale) % q
    return coeffs


@functools.cache
def pedersen_generator(group: GroupParams = DEFAULT_GROUP) -> int:
    """Second generator h of the order-q subgroup with UNKNOWN dlog_g:
    hash-to-group (SHA-256 counter stream mod p, squared — p = 2q+1 so
    squares are exactly the QR subgroup).  Nothing-up-my-sleeve: anyone
    re-derives h from the group constants, and no one knows log_g(h),
    which is what makes E_k = g^{a_k} h^{b_k} perfectly hiding AND
    binding under DLOG."""
    ctr = 0
    while True:
        ctr += 1
        raw = int.from_bytes(
            hashlib.sha256(
                b"cleisthenes-pedersen-h|%d|%d" % (group.p, ctr)
            ).digest()
            + hashlib.sha256(
                b"cleisthenes-pedersen-h2|%d|%d" % (group.p, ctr)
            ).digest(),
            "big",
        ) % group.p
        h = pow(raw, 2, group.p)
        if h not in (0, 1, group.g, group.p - 1):
            return h


def _commit_eval_exps(
    j: int, threshold: int, q: int
) -> List[int]:
    """[j^k mod q for k < threshold] — the exponents of the commitment
    product at evaluation point j."""
    out = [1]
    for _ in range(threshold - 1):
        out.append(out[-1] * j % q)
    return out


def validate_commitments(
    commitment_sets: Sequence[Sequence[int]],
    group: GroupParams = DEFAULT_GROUP,
    backend: str = "cuda",
    device="cuda",
    mesh=None,
    threshold: Optional[int] = None,
) -> List[bool]:
    """Shape + subgroup membership for whole commitment vectors.

    REQUIRED before any exponent arithmetic on a dealer's broadcast:
    the verification equation reduces exponents mod q, which is sound
    only for order-q elements.  A malicious dealer broadcasting a
    commitment with an order-2 component would otherwise verify
    INCONSISTENTLY across receivers (the reduced exponent's parity
    differs per evaluation point), splitting honest nodes' qualified
    sets — an agreement break, not just a bad key.  Membership is a
    deterministic property of the broadcast bytes, so every honest
    node disqualifies the same dealers.

    ``threshold`` (when given) also pins the vector LENGTH: a wrong-
    length broadcast must disqualify its dealer here, not crash every
    honest verifier downstream (an empty vector is vacuously
    "all-member", and a t' != t vector desynchronizes the flattened
    exponent batches of verify/finalize)."""
    gp = group
    eng = get_engine_degraded(backend, gp, device, mesh)
    flat: List[int] = []
    spans: List[int] = []
    for commits in commitment_sets:
        flat.extend(c % gp.p for c in commits)
        spans.append(len(commits))
    pows = eng.pow_batch(flat, [gp.q] * len(flat))
    out: List[bool] = []
    off = 0
    for (commits, span) in zip(commitment_sets, spans):
        ok = span > 0 and (threshold is None or span == threshold)
        ok = ok and all(
            1 < (c % gp.p) and pows[off + i] == 1
            for i, c in enumerate(commits)
        )
        off += span
        out.append(ok)
    return out


def verify_dealer_shares(
    items: Sequence[tuple],
    group: GroupParams = DEFAULT_GROUP,
    backend: str = "cuda",
    device="cuda",
    mesh=None,
) -> List[bool]:
    """Batched step-4 checks: ``items`` is a sequence of
    ``(commitments, receiver_index, share)`` and every
    g^{s} == prod_k C_k^{j^k} test runs from two batched dispatches.

    Callers must have validated the commitment vectors first
    (validate_commitments) — the j^k exponents here are reduced mod q,
    which assumes order-q elements."""
    if not items:
        return []
    gp = group
    eng = get_engine_degraded(backend, gp, device, mesh)
    bases: List[int] = []
    exps: List[int] = []
    spans: List[int] = []
    for commitments, j, share in items:
        t = len(commitments)
        if t == 0:
            spans.append(0)  # malformed broadcast: verdict False below
            continue
        jk = _commit_eval_exps(j, t, gp.q)
        bases.extend(c % gp.p for c in commitments)
        exps.extend(jk)
        bases.append(gp.g)
        exps.append(share % gp.q)
        spans.append(t + 1)
    pows = eng.pow_batch(bases, exps)
    out: List[bool] = []
    off = 0
    for span in spans:
        if span == 0:
            out.append(False)
            continue
        prod = 1
        for v in pows[off : off + span - 1]:
            prod = prod * v % gp.p
        lhs = pows[off + span - 1]  # g^{share}
        off += span
        out.append(lhs == prod)
    return out


def finalize(
    all_commitments: Dict[int, Sequence[int]],
    my_index: int,
    my_shares: Dict[int, int],
    n: int,
    threshold: int,
    group: GroupParams = DEFAULT_GROUP,
    backend: str = "cuda",
    device="cuda",
    mesh=None,
) -> Tuple[ThresholdPublicKey, ThresholdSecretShare]:
    """Fold the qualified dealings into this node's final key pair.

    ``all_commitments``: dealer index -> its t commitments (the
    qualified set Q — callers exclude disqualified dealers from BOTH
    arguments).  ``my_shares``: dealer index -> s_{i,my_index}.  Every
    correct node derives the IDENTICAL public key because the inputs
    are the broadcast commitments alone."""
    if set(all_commitments) != set(my_shares):
        raise ValueError("commitment/share dealer sets differ")
    if not all_commitments:
        raise ValueError("empty qualified set")
    for i, commits in all_commitments.items():
        if len(commits) != threshold:
            # qualified dealers were length-validated; a mismatch here
            # is a caller bug and must fail loudly, not desync the
            # flattened exponent batches below
            raise ValueError(
                f"dealer {i}: {len(commits)} commitments != t={threshold}"
            )
    gp = group
    eng = get_engine_degraded(backend, gp, device, mesh)
    x_j = sum(my_shares.values()) % gp.q
    master = 1
    for commits in all_commitments.values():
        master = master * (commits[0] % gp.p) % gp.p
    # the full verification-key table h_m = prod_{i,k} C_ik^{m^k},
    # one batched dispatch for all n receivers x |Q| dealers x t terms
    bases: List[int] = []
    exps: List[int] = []
    for m in range(1, n + 1):
        jk = _commit_eval_exps(m, threshold, gp.q)
        for commits in all_commitments.values():
            bases.extend(c % gp.p for c in commits)
            exps.extend(jk)
    pows = eng.pow_batch(bases, exps)
    vks: List[int] = []
    per_m = len(all_commitments) * threshold
    for m in range(n):
        prod = 1
        for v in pows[m * per_m : (m + 1) * per_m]:
            prod = prod * v % gp.p
        vks.append(prod)
    pub = ThresholdPublicKey(
        n=n,
        threshold=threshold,
        master=master,
        verification_keys=tuple(vks),
        group=gp,
    )
    return pub, ThresholdSecretShare(index=my_index, value=x_j)


def run_dkg(
    n: int,
    threshold: int,
    group: GroupParams = DEFAULT_GROUP,
    seed: Optional[int] = None,
    backend: str = "cuda",
    device="cuda",
    mesh=None,
    corrupt_dealers: Sequence[int] = (),
    false_accusers: Sequence[int] = (),
    phase2_cheaters: Sequence[int] = (),
    phase2_short_openers: Sequence[int] = (),
) -> Tuple[ThresholdPublicKey, List[ThresholdSecretShare], List[int]]:
    """Drive the whole GJKR protocol in-process (the test/simulation
    harness; a deployment pumps the same steps over RBC broadcasts and
    private channels).  Fault knobs:

    - ``corrupt_dealers`` hand receiver 1 a tampered share AND double
      down when challenged (reveal the tampered pair) — the justified
      complaint flow must disqualify exactly them;
    - ``false_accusers`` are receivers who complain against every
      dealer regardless of evidence — honest dealers must reveal and
      SURVIVE (Q agreement holds against slander);
    - ``phase2_cheaters`` deal honestly in phase one but broadcast
      garbage Feldman openings in phase two — their contribution must
      be reconstructed, leaving the final key exactly what phase one
      fixed (the rushing-adversary regression);
    - ``phase2_short_openers`` broadcast a WRONG-LENGTH opening
      (t-1 entries) — the length guard must shunt them to the same
      reconstruction path instead of desynchronizing the batched
      exponent layouts (advisor r4 finding).

    Returns (pub, shares, qualified_dealer_indices)."""
    dealings = {
        i: PedersenDealing(i, n, threshold, group, seed=seed)
        for i in range(1, n + 1)
    }
    # -- phase one: Pedersen deal + justified complaints -> Q ---------
    ped = {
        i: d.pedersen_commitments(backend=backend, device=device, mesh=mesh)
        for i, d in dealings.items()
    }
    # commitment subgroup validation first (see validate_commitments:
    # skipping it lets a crafted broadcast split honest qualified sets)
    commit_ok = validate_commitments(
        [ped[i] for i in range(1, n + 1)],
        group=group,
        backend=backend,
        device=device,
        mesh=mesh,
        threshold=threshold,
    )
    bad_commits = {
        i for i, ok in zip(range(1, n + 1), commit_ok) if not ok
    }
    # every (dealer, receiver) share pair, tampered for corrupt dealers
    pairs: Dict[int, Dict[int, Tuple[int, int]]] = {}  # recv -> dealer
    for j in range(1, n + 1):
        pairs[j] = {}
        for i, d in dealings.items():
            s, s2 = d.share_pair_for(j)
            if i in corrupt_dealers and j == 1:
                s = (s + 1) % group.q
            pairs[j][i] = (s, s2)
    # batched verification of all n^2 pairs; any failure = a complaint
    items = []
    order = []
    for j in range(1, n + 1):
        for i in range(1, n + 1):
            if i in bad_commits:
                continue
            s, s2 = pairs[j][i]
            items.append((ped[i], j, s, s2))
            order.append((j, i))
    verdicts = verify_pedersen_shares(
        items, group=group, backend=backend, device=device, mesh=mesh
    )
    complaints = {(j, i) for (j, i), ok in zip(order, verdicts) if not ok}
    for j in false_accusers:
        complaints |= {
            (j, i) for i in range(1, n + 1) if i not in bad_commits
        }
    # justified resolution: the accused dealer reveals the disputed
    # pair PUBLICLY; everyone checks the reveal against the broadcast
    # commitments and disqualifies only on verifiable evidence.  A
    # corrupt dealer doubles down (reveals what it actually sent); an
    # honest-but-slandered dealer reveals the true pair and survives.
    reveal_items = []
    reveal_order = sorted(complaints)
    for (j, i) in reveal_order:
        s, s2 = pairs[j][i]  # what the dealer actually sent
        reveal_items.append((ped[i], j, s, s2))
    reveal_ok = verify_pedersen_shares(
        reveal_items, group=group, backend=backend, device=device, mesh=mesh
    )
    # (receiver, dealer) pairs proven consistent with the dealer's
    # phase-one Pedersen commitments — the ONLY shares phase two may
    # later interpolate from (a receiver lying about its share must
    # not be able to poison a reconstruction)
    ped_verified = {(j, i) for (j, i), ok in zip(order, verdicts) if ok}
    disqualified = set(bad_commits)
    for (j, i), item, ok in zip(reveal_order, reveal_items, reveal_ok):
        if ok:
            # valid reveal: the complaint was slander (or transport
            # corruption); receiver j adopts the now-public pair
            pairs[j][i] = item[2:4]
            ped_verified.add((j, i))
        else:
            disqualified.add(i)
    qualified = sorted(set(range(1, n + 1)) - disqualified)
    if len(qualified) < threshold:
        raise RuntimeError(
            f"only {len(qualified)} qualified dealers < t={threshold}"
        )
    # Q is FIXED here — so is x = sum_{i in Q} f_i(0), while every
    # broadcast so far is perfectly hiding.  Nothing an adversary does
    # from this point can change the key (only how we learn g^x).
    # -- phase two: Feldman opening, reconstruct cheaters -------------
    feld = {}
    for i in qualified:
        if i in phase2_short_openers:
            # wrong-length opening: parses element-wise but must be
            # caught by the length guard before any batch flattening
            feld[i] = [group.g] * (threshold - 1)
        elif i in phase2_cheaters:
            # garbage opening: right length, valid subgroup elements,
            # wrong values — the strongest cheat that still parses
            feld[i] = [group.g] * threshold
        else:
            feld[i] = dealings[i].commitments(backend=backend, device=device, mesh=mesh)
    # length guard BEFORE anything is flattened: a t' != t opening
    # from a real adversary would desynchronize the batched exponent
    # layouts below (see verify_dealer_shares' docstring); such a
    # dealer goes straight to the reconstruction path, mirroring
    # finalize's own guard
    wrong_len = {i for i in qualified if len(feld[i]) != threshold}
    p2_checked = [i for i in qualified if i not in wrong_len]
    feld_ok = validate_commitments(
        [feld[i] for i in p2_checked],
        group=group,
        backend=backend,
        device=device,
        mesh=mesh,
        threshold=threshold,
    )
    # consistency vs the phase-one shares every receiver holds
    p2_items = []
    p2_order = []
    for i in p2_checked:
        for j in range(1, n + 1):
            p2_items.append((feld[i], j, pairs[j][i][0]))
            p2_order.append((i, j))
    p2_verdicts = verify_dealer_shares(
        p2_items, group=group, backend=backend, device=device, mesh=mesh
    )
    bad_openings = (
        wrong_len
        | {i for i, ok in zip(p2_checked, feld_ok) if not ok}
        | {i for (i, j), ok in zip(p2_order, p2_verdicts) if not ok}
    )
    if bad_openings:
        # NOT disqualified: their secrets are already in x.
        # Reconstruct each f_i from t phase-one-verified shares and
        # open it ourselves — all dealers in ONE batched dispatch.
        eng = get_engine_degraded(backend, group, device, mesh)
        recon = sorted(bad_openings)
        all_coeffs: List[int] = []
        for i in recon:
            # interpolate ONLY from shares proven against dealer i's
            # phase-one Pedersen commitments: a Byzantine receiver
            # among the first t broadcasting a lie must not yield a
            # wrong opening that splits honest nodes' keys
            pts = [
                (j, pairs[j][i][0])
                for j in range(1, n + 1)
                if (j, i) in ped_verified
            ][:threshold]
            if len(pts) < threshold:
                raise RuntimeError(
                    f"dealer {i}: only {len(pts)} Pedersen-verified "
                    f"shares < t={threshold} for reconstruction"
                )
            all_coeffs.extend(_interpolate_coeffs(pts, group.q))
        pows = eng.pow_batch(
            [group.g] * len(all_coeffs), all_coeffs
        )
        for idx, i in enumerate(recon):
            feld[i] = pows[idx * threshold : (idx + 1) * threshold]
    q_commits = {i: feld[i] for i in qualified}
    pub = None
    out_shares: List[ThresholdSecretShare] = []
    for j in range(1, n + 1):
        p_j, sh_j = finalize(
            q_commits,
            j,
            {i: pairs[j][i][0] for i in qualified},
            n,
            threshold,
            group=group,
            backend=backend,
            device=device,
            mesh=mesh,
        )
        if pub is None:
            pub = p_j
        else:
            # agreement on the public state is a THEOREM here (pure
            # function of broadcast commitments); assert it anyway
            assert p_j == pub
        out_shares.append(sh_j)
    return pub, out_shares, qualified


__all__ = [
    "DkgDealing",
    "PedersenDealing",
    "pedersen_generator",
    "verify_dealer_shares",
    "verify_pedersen_shares",
    "finalize",
    "run_dkg",
]
