"""Threshold encryption (TPKE) and the generic threshold-DH core.

Implements the four-call API the reference specifies but never codes
(reference docs/THRESHOLD_ENCRYPTION-EN.md:33-36):

  TPKE.SetUp    -> ThresholdDealer / TpkeKeys (master pubkey + n shares)
  TPKE.Encrypt  -> Tpke.encrypt (hashed-ElGamal KEM under the master key)
  TPKE.DecShare -> Tpke.dec_share (share + Chaum-Pedersen validity proof)
  TPKE.Decrypt  -> Tpke.combine (Lagrange over any f+1 verified shares,
                   docs/HONEYBADGER-EN.md:40-42)

Scheme: discrete-log threshold ElGamal in the prime-order QR subgroup
of Z_p* (p a 256-bit safe prime, ops/modmath.py).  The dealer Shamir-
shares a secret s with threshold t = f+1; decryption shares are
d_i = c1^{s_i} carrying a Chaum-Pedersen NIZK (Fiat-Shamir over
SHA-256) that log_g(h_i) = log_{c1}(d_i) — so invalid shares from
Byzantine nodes are rejected before combination.  Share verification
is 2 dual-exponentiations per share, batched across all N shares in
one engine call (the "TPKE-share-verify ops/sec" BASELINE metric).

This is the PyTorch port's copy of ``cleisthenes_tpu/ops/tpke.py``.
The batched share ops take the engine's ``backend``, ``device`` and
``mesh`` (the reference's ``mesh``): with ``'cuda'`` their exponentiations run on the
card's Montgomery kernels (ops/modmath.py); single-shot ops (encrypt,
deal, scalar issue and combine) stay on the host engine, as in the
reference.

Security notes (documented, deliberate): hashed-ElGamal KEM + integrity
tag in the random-oracle model; a production deployment would swap the
group seam for a pairing curve and Baek-Zheng CCA2 or a larger prime —
the API and the batched-verify data flow are unchanged by that swap,
which is the point of the BatchCrypto seam.  The dealer is trusted
(standard for HBBFT test/bench deployments; DKG is a protocol-layer
extension).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import hmac
import secrets
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from cleisthenes_tpu_torch.ops.modmath import (
    DEFAULT_GROUP,
    G,
    GroupParams,
    P,
    Q,
    get_engine_degraded,
    host_pow,
    host_pow_batch,
)


def _hash_to_int(*parts: bytes) -> int:
    # one pre-joined update (identical bytes to per-part updates):
    # this runs once per issued/verified share — millions of times in
    # a big lockstep epoch — and 2 C calls beat 2*len(parts)
    h = hashlib.sha256(
        b"".join(
            len(p_).to_bytes(4, "big") + p_ for p_ in parts
        )
    )
    return int.from_bytes(h.digest(), "big")


def _cp_challenge_batch(
    contexts: Sequence[bytes],
    bases: Sequence[int],
    his: Sequence[int],
    ds: Sequence[int],
    a1s: Sequence[int],
    a2s: Sequence[int],
    group: "GroupParams",
) -> List[int]:
    """All of a wave's CP challenges e = H(cp transcript) mod q in one
    batched native hash — byte-identical to mapping ``_hash_to_int``
    over the items (tests assert the equivalence), but the transcript
    rows are assembled as numpy columns and digested in a single
    ctypes crossing instead of ~m Python hash calls.

    Rows are grouped by context length (field offsets are constant
    within a group); a lockstep wave has a handful of context shapes,
    so this stays a couple of matrix fills."""
    from cleisthenes_tpu_torch.ops.hashrows import ints_to_be_rows, sha256_rows

    m = len(contexts)
    if m == 0:
        return []
    nb, q = group.nbytes, group.q
    if m < 64:
        # matrix assembly costs more than it saves on the live path's
        # small hub flushes; identical bytes either way
        return [
            _hash_to_int(
                b"cp", contexts[i], _ibytes(bases[i], nb),
                _ibytes(his[i], nb), _ibytes(ds[i], nb),
                _ibytes(a1s[i], nb), _ibytes(a2s[i], nb),
            )
            % q
            for i in range(m)
        ]
    cols = [
        ints_to_be_rows(vals, nb)
        for vals in (bases, his, ds, a1s, a2s)
    ]
    head_pfx = (2).to_bytes(4, "big") + b"cp"
    heads = [
        head_pfx + len(c).to_bytes(4, "big") + c for c in contexts
    ]
    by_hl: Dict[int, List[int]] = {}
    for i, h in enumerate(heads):
        by_hl.setdefault(len(h), []).append(i)
    field_pfx = np.frombuffer(nb.to_bytes(4, "big"), dtype=np.uint8)
    out: List[int] = [0] * m
    for hl, idxs in by_hl.items():
        k = len(idxs)
        rows = np.empty((k, hl + 5 * (4 + nb)), dtype=np.uint8)
        rows[:, :hl] = np.frombuffer(
            b"".join(heads[i] for i in idxs), dtype=np.uint8
        ).reshape(k, hl)
        off = hl
        sel = np.asarray(idxs, dtype=np.intp)
        for col in cols:
            rows[:, off : off + 4] = field_pfx
            rows[:, off + 4 : off + 4 + nb] = col[sel]
            off += 4 + nb
        digs = sha256_rows(rows)
        for row, i in zip(digs, idxs):
            out[i] = int.from_bytes(row.tobytes(), "big") % q
    return out


def _ibytes(x: int, nbytes: int = 32) -> bytes:
    return x.to_bytes(nbytes, "big")


def is_group_element(x: int, group: GroupParams = DEFAULT_GROUP) -> bool:
    """Strict membership test for the prime-order QR subgroup:
    ``1 < x < P`` and ``x^Q == 1 (mod P)``.

    Rejects 0, the identity, P-1 (the order-2 element) and every
    non-residue — the inputs a Byzantine proposer could use to make all
    honest decryption shares unverifiable forever (each honest node's
    d_i = c1^{s_i} then fails its own CP proof, burning every honest
    sender in the SharePool and stalling _maybe_commit), or to leak
    share parities via the order-2 component.  One ~256-bit modexp on
    host per check; callers run it once per deserialized ciphertext.
    """
    return 1 < x < group.p and host_pow(x, group.q, group) == 1


def hash_to_group(data: bytes, group: GroupParams = DEFAULT_GROUP) -> int:
    """Map bytes to the QR subgroup with unknown discrete log:
    (H(data) mod p)^2 mod p."""
    x = _hash_to_int(b"h2g", data) % group.p
    if x == 0:
        x = 1
    return pow(x, 2, group.p)


# ---------------------------------------------------------------------------
# Shamir secret sharing over Z_q
# ---------------------------------------------------------------------------


def _shamir_shares(
    secret: int, n: int, threshold: int, rng_bytes, q: int = Q
) -> List[int]:
    """Evaluate a random degree-(threshold-1) polynomial with
    f(0)=secret at x = 1..n."""
    nb = max(32, (q.bit_length() + 7) // 8 + 8)  # excess bits: no bias
    coeffs = [secret] + [
        int.from_bytes(rng_bytes(nb), "big") % q for _ in range(threshold - 1)
    ]
    shares = []
    for x in range(1, n + 1):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % q
        shares.append(acc)
    return shares


@functools.lru_cache(maxsize=4096)
def _lagrange_cached(xs: tuple, q: int) -> tuple:
    out = []
    for i, xi in enumerate(xs):
        num, den = 1, 1
        for j, xj in enumerate(xs):
            if i == j:
                continue
            num = num * xj % q
            den = den * ((xj - xi) % q) % q
        out.append(num * pow(den, -1, q) % q)
    return tuple(out)


def lagrange_coeff_at_zero(xs: Sequence[int], q: int = Q) -> List[int]:
    """lambda_i = prod_{j!=i} x_j / (x_j - x_i) mod q, for interpolation
    at 0 (Shamir recovery, docs/THRESHOLD_ENCRYPTION-EN.md:36).

    Cached by index set: an epoch combines N proposals from largely
    the SAME threshold subset of share indices, and the O(t^2) python
    coefficient loop was measurable at N=64 (t=22)."""
    return list(_lagrange_cached(tuple(xs), q))


# ---------------------------------------------------------------------------
# Generic threshold-DH: keygen, share issuance w/ CP proof, batched verify,
# Lagrange combine.  TPKE and the common coin both instantiate this.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ThresholdPublicKey:
    n: int
    threshold: int
    master: int  # h = g^s
    verification_keys: tuple  # h_i = g^{s_i}, 1-indexed by share x = i+1
    # the group every share op under this key runs in (the modulus
    # seam: a key set carries its own parameters end to end)
    group: GroupParams = DEFAULT_GROUP


@dataclasses.dataclass(frozen=True)
class ThresholdSecretShare:
    index: int  # Shamir x-coordinate (1-based)
    value: int  # s_i


class DhShare(NamedTuple):
    """d = base^{s_i} plus a Chaum-Pedersen proof (e, z) that
    log_g(h_i) == log_base(d).

    A NamedTuple, not a dataclass: a live N=64 epoch creates ~1M of
    these and frozen-dataclass ``__init__`` was a visible profile
    line."""

    index: int
    d: int
    e: int
    z: int


def deal(
    n: int,
    threshold: int,
    seed: Optional[int] = None,
    group: GroupParams = DEFAULT_GROUP,
) -> tuple:
    """Trusted-dealer setup (TPKE.SetUp): master pubkey + n secret
    shares.  Deterministic iff ``seed`` given (tests/benchmarks)."""
    if seed is not None:
        ctr = [0]

        def rng_bytes(k: int) -> bytes:
            out = b""
            while len(out) < k:  # k may exceed one digest (large groups)
                ctr[0] += 1
                out += hashlib.sha256(
                    b"dealer|%d|%d" % (seed, ctr[0])
                ).digest()
            return out[:k]

    else:
        rng_bytes = secrets.token_bytes  # staticcheck: allow[DET001] unseeded dealer keygen
    # 8 excess bytes: the reduction mod q is statistically unbiased
    # (bias < 2^-64), matching _shamir_shares' rule
    s = int.from_bytes(rng_bytes(group.nbytes + 8), "big") % group.q
    shares = _shamir_shares(s, n, threshold, rng_bytes, group.q)
    vks = host_pow_batch([group.g] * (n + 1), [s] + shares, group)
    pub = ThresholdPublicKey(
        n=n,
        threshold=threshold,
        master=vks[0],
        verification_keys=tuple(vks[1:]),
        group=group,
    )
    return pub, [
        ThresholdSecretShare(index=i + 1, value=si)
        for i, si in enumerate(shares)
    ]


def issue_share(
    share: ThresholdSecretShare,
    base: int,
    context: bytes,
    group: GroupParams = DEFAULT_GROUP,
) -> DhShare:
    """d = base^{s_i} with CP proof bound to ``context``."""
    # 8 excess bytes -> unbiased nonce: a biased Schnorr/CP nonce
    # leaks the secret share to a lattice (hidden-number) attack over
    # many observed shares, since z = w + e*s_i is linear in w
    nonce = secrets.token_bytes(  # staticcheck: allow[DET001] CP-proof nonce
        group.nbytes + 8
    )
    w = int.from_bytes(nonce, "big") % group.q
    a1, a2, hi, d = host_pow_batch(
        [group.g, base, group.g, base],
        [w, w, share.value, share.value],
        group,
    )
    nb = group.nbytes
    e = (
        _hash_to_int(
            b"cp", context, _ibytes(base, nb), _ibytes(hi, nb),
            _ibytes(d, nb), _ibytes(a1, nb), _ibytes(a2, nb),
        )
        % group.q
    )
    z = (w + e * share.value) % group.q
    return DhShare(index=share.index, d=d, e=e, z=z)


def issue_shares_batch(
    items: Sequence[tuple],
    group: GroupParams = DEFAULT_GROUP,
    backend: str = "cuda",
    device="cuda",
    mesh=None,
) -> List[DhShare]:
    """Issue MANY shares in one batched exponentiation dispatch.

    ``items``: sequence of ``(share, base, context, vk)`` — ``vk`` is
    the issuer's public verification key g^{s_i} (``None`` recomputes
    it, costing one extra exponentiation per item).  Semantics match
    ``issue_share`` exactly; this is the lockstep executor's path,
    where a synchronous wave issues N^2 coin/decryption shares at once
    (protocol.spmd) instead of one 4-exponentiation batch per share.
    """
    if not items:
        return []
    eng = get_engine_degraded(backend, group, device, mesh)
    q, g = group.q, group.g
    nbytes = group.nbytes
    # Exponentiations grouped by base — a wave shares a handful of
    # bases (the generator g plus one coin base / ciphertext c1 per
    # instance), which is exactly the fixed-base comb kernel's shape
    # (ModEngine.pow_batch_grouped).
    ws = []
    g_exps: List[int] = []
    by_base: Dict[int, List[int]] = {}
    # ONE urandom draw for the whole wave (a lockstep wave issues
    # ~N^2 shares; per-item token_bytes was one syscall each), sliced
    # per item — same unbiased nonce rule (and reason) as issue_share
    stride = nbytes + 8
    nonce_pool = secrets.token_bytes(  # staticcheck: allow[DET001] CP-proof nonces
        stride * len(items)
    )
    off = 0
    for share, base, _context, vk in items:
        w = int.from_bytes(nonce_pool[off : off + stride], "big") % q
        off += stride
        ws.append(w)
        g_exps.append(w)  # a1 = g^w
        if vk is None:
            g_exps.append(share.value)  # h_i = g^{s_i}
        be = by_base.setdefault(base, [])
        be.append(w)  # a2 = base^w
        be.append(share.value)  # d = base^{s_i}
    base_order = list(by_base)
    groups = [(g, g_exps)] + [(b, by_base[b]) for b in base_order]
    pows = eng.pow_batch_grouped(groups)
    g_res = pows[0]
    base_res = {b: res for b, res in zip(base_order, pows[1:])}
    base_off = {b: 0 for b in base_order}
    g_off = 0
    a1s: List[int] = []
    his: List[int] = []
    a2s: List[int] = []
    ds: List[int] = []
    for share, base, _context, vk in items:
        a1s.append(g_res[g_off])
        g_off += 1
        if vk is None:
            his.append(g_res[g_off])
            g_off += 1
        else:
            his.append(vk)
        bo = base_off[base]
        a2s.append(base_res[base][bo])
        ds.append(base_res[base][bo + 1])
        base_off[base] = bo + 2
    es = _cp_challenge_batch(
        [it[2] for it in items],
        [it[1] for it in items],
        his,
        ds,
        a1s,
        a2s,
        group,
    )
    return [
        DhShare(
            index=share.index,
            d=d,
            e=e,
            z=(w + e * share.value) % q,
        )
        for (share, _b, _c, _vk), w, d, e in zip(items, ws, ds, es)
    ]


def combine_shares_batch(
    share_sets: Sequence[Sequence[DhShare]],
    threshold: int,
    group: GroupParams = DEFAULT_GROUP,
    backend: str = "cuda",
    device="cuda",
    mesh=None,
) -> List[int]:
    """Lagrange-combine many independent share sets in ONE
    exponentiation dispatch (each set >= threshold verified shares;
    result order matches input order).  Equivalent to mapping
    ``combine_shares``, and shares its memo."""
    if not share_sets:
        return []
    eng = get_engine_degraded(backend, group, device, mesh)
    results: List[Optional[int]] = [None] * len(share_sets)
    bases_flat: List[int] = []
    exps_flat: List[int] = []
    spans: List[tuple] = []  # (set_idx, memo_key, n_terms)
    for si, shares in enumerate(share_sets):
        if len(shares) < threshold:
            raise ValueError(
                f"need >= {threshold} shares to combine, got {len(shares)}"
            )
        use = sorted(shares, key=lambda s: s.index)[:threshold]
        xs = [s.index for s in use]
        if len(set(xs)) != len(xs):
            raise ValueError("duplicate share indices")
        key = (group, threshold, tuple((s.index, s.d) for s in use))
        hit = _COMBINE_MEMO.get(key)
        if hit is not None:
            results[si] = hit
            continue
        lams = lagrange_coeff_at_zero(xs, group.q)
        bases_flat.extend(sh.d % group.p for sh in use)
        exps_flat.extend(lams)
        spans.append((si, key, threshold))
    if bases_flat:
        pows = eng.pow_batch(bases_flat, exps_flat)
        off = 0
        for si, key, n_terms in spans:
            acc = 1
            for term in pows[off : off + n_terms]:
                acc = acc * term % group.p
            off += n_terms
            if len(_COMBINE_MEMO) >= _COMBINE_MEMO_CAP:
                _COMBINE_MEMO.clear()
            _COMBINE_MEMO[key] = acc
            results[si] = acc
    return results  # type: ignore[return-value]


def verify_share_groups(
    groups: Sequence[tuple],
    backend: str = "cuda",
    device="cuda",
    mesh=None,
) -> List[List[bool]]:
    """Batched CP verification across heterogeneous groups.

    ``groups`` is a sequence of ``(pub, base, shares, context)`` — e.g.
    one group per (proposer ciphertext) or per (BBA instance, round)
    coin — and ALL of their CP proofs run as ONE dual-exponentiation
    dispatch (K8 on the 'cuda' engine): recompute A1 = g^z * h_i^{-e},
    A2 = base^z * d^{-e}, accept iff e == H(transcript).  This is the cross-instance batching
    the protocol hub uses: an epoch's N TPKE ciphertexts and its
    concurrent BBA coins verify together instead of one dispatch per
    instance (the reference's cost model is 4N^2 shares/epoch,
    docs/HONEYBADGER-EN.md:93-94).
    """
    if not groups:
        return []
    # one engine (and one batched dispatch) per distinct GroupParams;
    # in practice a node's TPKE and coin keys share one group, so this
    # stays a single dispatch
    by_gp: Dict[GroupParams, List[int]] = {}
    for gi, (pub, _base, _shares, _context) in enumerate(groups):
        by_gp.setdefault(pub.group, []).append(gi)
    results: Dict[int, List[bool]] = {}
    for gp, idx_list in by_gp.items():
        eng = get_engine_degraded(backend, gp, device, mesh)
        a = _verify_pows_dual(gp, eng, groups, idx_list)
        results.update(_cp_verdicts(gp, groups, idx_list, a))
    return [results[gi] for gi in range(len(groups))]


def _verify_dual_items(gp, groups, idx_list):
    """The (u1, e1, u2, e2) dual-exponentiation lists recomputing
    (A1, A2) for every share of ``idx_list``'s groups — shared by the
    plain and the fused verifiers so the two can never drift."""
    u1, e1, u2, e2 = [], [], [], []
    for gi in idx_list:
        pub, base, shares, _context = groups[gi]
        for sh in shares:
            if not (1 <= sh.index <= pub.n):
                # out-of-roster index: verified vacuously false by
                # pinning to vk=1 (never matches a real transcript)
                hi = 1
            else:
                hi = pub.verification_keys[sh.index - 1]
            neg_e = (-sh.e) % gp.q
            # A1 = g^z * hi^{-e}
            u1.append(gp.g); e1.append(sh.z % gp.q)
            u2.append(hi); e2.append(neg_e)
            # A2 = base^z * d^{-e}
            u1.append(base); e1.append(sh.z % gp.q)
            u2.append(sh.d % gp.p); e2.append(neg_e)
    return u1, e1, u2, e2


def _cp_verdicts(gp, groups, idx_list, a) -> Dict[int, List[bool]]:
    """Verdicts from the recomputed (A1, A2) stream ``a`` (two entries
    per share, idx_list order): assemble every transcript, run ONE
    batched challenge hash, compare — shared by the plain and fused
    verifiers."""
    off = 0
    ctxs: List[bytes] = []
    basel: List[int] = []
    hil: List[int] = []
    dl: List[int] = []
    a1l: List[int] = []
    a2l: List[int] = []
    struct_ok: List[bool] = []
    want_e: List[int] = []
    for gi in idx_list:
        pub, base, shares, context = groups[gi]
        for sh in shares:
            a1, a2 = a[off], a[off + 1]
            off += 2
            ok = (1 <= sh.index <= pub.n) and (0 < sh.d < gp.p)
            hi = pub.verification_keys[sh.index - 1] if ok else 1
            ctxs.append(context)
            basel.append(base)
            hil.append(hi)
            dl.append(sh.d % gp.p)
            a1l.append(a1)
            a2l.append(a2)
            struct_ok.append(ok)
            want_e.append(sh.e % gp.q)
    es = _cp_challenge_batch(ctxs, basel, hil, dl, a1l, a2l, gp)
    results: Dict[int, List[bool]] = {}
    k = 0
    for gi in idx_list:
        _pub, _base, shares, _context = groups[gi]
        res = []
        for _sh in shares:
            res.append(struct_ok[k] and es[k] == want_e[k])
            k += 1
        results[gi] = res
    return results


def _verify_pows_dual(gp, eng, groups, idx_list) -> List[int]:
    """(A1, A2) per share via the fused dual-exponentiation kernel
    (the engine's ``dual_pow_batch``)."""
    u1, e1, u2, e2 = _verify_dual_items(gp, groups, idx_list)
    return eng.dual_pow_batch(u1, e1, u2, e2)


def verify_and_combine_share_groups(
    groups: Sequence[tuple],
    threshold: int,
    backend: str = "cuda",
    combine_only_sets: Sequence[Sequence[DhShare]] = (),
    combine_only_group: Optional[GroupParams] = None,
    device="cuda",
    mesh=None,
) -> Tuple[List[List[bool]], List[Optional[int]], List[int]]:
    """Verify every group's CP proofs AND Lagrange-combine each group's
    first ``threshold`` shares in ONE fused dual-exponentiation
    dispatch (half the device round-trips of verify + combine run
    separately — the lockstep BBA's per-round critical path).

    ``groups`` is ``(pub, base, shares, context)`` as in
    ``verify_share_groups``; returns ``(verdicts, values)`` where
    ``values[i]`` is the combination of group i's shares (``None``
    when the group has fewer than ``threshold`` shares).  Combination
    does not wait for the verdicts — callers must discard the value
    of any group whose verdicts fail (the lockstep executor asserts
    them; the live path uses the unfused ops).  Results seed the
    combine memo, so a later ``combine_shares`` on the same subset is
    a pure host hit.

    ``combine_only_sets`` are additional share sets (same threshold,
    group ``combine_only_group`` — defaults to the first group's) to
    Lagrange-combine WITHOUT verification in the same dispatch: the
    lockstep executor rides its whole optimistic-decrypt wave on BBA
    round 0's device round-trip this way.  Their values are the third
    returned list."""
    if not groups and not combine_only_sets:
        return [], [], []
    by_gp: Dict[GroupParams, List[int]] = {}
    for gi, (pub, _base, _shares, _context) in enumerate(groups):
        by_gp.setdefault(pub.group, []).append(gi)
    co_gp: Optional[GroupParams] = None
    if combine_only_sets:
        if combine_only_group is not None:
            co_gp = combine_only_group
        elif groups:
            co_gp = groups[0][0].group
        else:
            # guessing a group here would produce a well-formed but
            # cryptographically WRONG combination (and memoize it)
            raise ValueError(
                "combine_only_sets without groups requires an "
                "explicit combine_only_group"
            )
        by_gp.setdefault(co_gp, [])
    verdicts: Dict[int, List[bool]] = {}
    values: Dict[int, Optional[int]] = {}
    co_values: List[int] = [0] * len(combine_only_sets)
    for gp, idx_list in by_gp.items():
        eng = get_engine_degraded(backend, gp, device, mesh)
        # verification duals first (2 per share), then combine terms
        # (threshold per set) ride the same dispatch as u2^0 = 1
        # dummy-factor duals
        u1, e1, u2, e2 = _verify_dual_items(gp, groups, idx_list)
        n_dual = len(u1)
        comb_spans: List[tuple] = []  # (store(value), memo_key)

        def queue_combine(shares, store) -> None:
            """Memo-hit now or queue threshold Lagrange terms; the
            post-dispatch loop below routes the product to ``store``.
            One body for both the verified groups and the
            combine-only sets — they cannot drift."""
            use = sorted(shares, key=lambda s: s.index)[:threshold]
            xs = [s.index for s in use]
            if len(set(xs)) != len(xs):
                raise ValueError("duplicate share indices")
            key = (gp, threshold, tuple((s.index, s.d) for s in use))
            hit = _COMBINE_MEMO.get(key)
            if hit is not None:
                store(hit)
                return
            lams = lagrange_coeff_at_zero(xs, gp.q)
            for sh, lam in zip(use, lams):
                u1.append(sh.d % gp.p); e1.append(lam)
                u2.append(1); e2.append(0)
            comb_spans.append((store, key))

        for gi in idx_list:
            pub, _base, shares, _context = groups[gi]
            if len(shares) < threshold:
                values[gi] = None
                continue
            queue_combine(
                shares, lambda v, gi=gi: values.__setitem__(gi, v)
            )
        if gp == co_gp:  # equality, not identity: by_gp keys by value
            for ci, shares in enumerate(combine_only_sets):
                if len(shares) < threshold:
                    raise ValueError(
                        f"need >= {threshold} shares, got {len(shares)}"
                    )
                queue_combine(
                    shares, lambda v, ci=ci: co_values.__setitem__(ci, v)
                )
        a = eng.dual_pow_batch(u1, e1, u2, e2)
        verdicts.update(_cp_verdicts(gp, groups, idx_list, a))
        off = n_dual
        for store, key in comb_spans:
            acc = 1
            for term in a[off : off + threshold]:
                acc = acc * term % gp.p
            off += threshold
            if len(_COMBINE_MEMO) >= _COMBINE_MEMO_CAP:
                _COMBINE_MEMO.clear()
            _COMBINE_MEMO[key] = acc
            store(acc)
    return (
        [verdicts[gi] for gi in range(len(groups))],
        [values[gi] for gi in range(len(groups))],
        co_values,
    )


def verify_shares(
    pub: ThresholdPublicKey,
    base: int,
    shares: Sequence[DhShare],
    context: bytes,
    backend: str = "cuda",
    device="cuda",
    mesh=None,
) -> List[bool]:
    """Single-group convenience over ``verify_share_groups``."""
    if not shares:
        return []
    return verify_share_groups(
        [(pub, base, shares, context)], backend, device, mesh
    )[0]


class SharePool:
    """Sender-keyed pool of DhShares with deferred batched verification.

    One slot per roster sender (an honest node submits exactly one
    share per context), so a Byzantine peer can only ever occupy — and
    then burn — its own slot: a sender whose share fails verification
    is remembered in ``_burned`` and can never resubmit, bounding both
    memory and re-verification work.  Valid shares are deduped by
    Shamir index before combination (a Byzantine sender may replay
    another node's valid share, which must not trip the distinct-
    index requirement of Lagrange interpolation).

    Shares sit in a *pending* set until verification verdicts arrive —
    either via ``try_verified`` (self-contained, one verify call per
    pool) or via ``collect_pending``/``apply_verdicts`` driven by the
    protocol hub, which verifies MANY pools' pending shares in one
    cross-instance dispatch (the reference's protocol.hub.CryptoHub).

    Shared by the BBA common coin and the TPKE decryption path — the
    two consumers of threshold shares in HBBFT.
    """

    __slots__ = ("threshold", "_pending", "_verified", "_burned",
                 "_seen", "_lazy", "_n", "_idx_cover")

    def __init__(self, threshold: int):
        self.threshold = threshold
        self._pending: Dict[str, DhShare] = {}
        self._verified: Dict[str, DhShare] = {}
        self._burned: set = set()
        # one membership set over pending+verified+burned+lazy: the
        # add paths make a single probe instead of three
        self._seen: set = set()
        # lazily-parked (sender, index, d, e, z) rows: the live path's
        # wave handlers park ~N shares per pool but only ~threshold
        # ever get consumed — DhShare objects materialize on first
        # structured access, so arrival cost is probe+append
        self._lazy: List[tuple] = []
        self._n = 0  # pending+verified+lazy (burns decrement)
        # distinct Shamir indices held (pending+verified+lazy) — an
        # upper bound on achievable interpolation coverage, letting
        # lazy row-store pulls stop the moment the threshold is
        # coverable instead of materializing a whole wave (recomputed
        # exactly when a burn invalidates it)
        self._idx_cover: set = set()

    def covered(self) -> int:
        return len(self._idx_cover)

    def add(self, sender: str, share: DhShare) -> bool:
        """First share per non-burned sender wins."""
        if sender in self._seen:
            return False
        self._seen.add(sender)
        self._pending[sender] = share
        self._idx_cover.add(share.index)
        self._n += 1
        return True

    def add_lazy(
        self, sender: str, index: int, d: int, e: int, z: int
    ) -> bool:
        """``add`` without constructing the DhShare: the batched wave
        handlers' per-share fast path."""
        if sender in self._seen:
            return False
        self._seen.add(sender)
        self._lazy.append((sender, index, d, e, z))
        self._idx_cover.add(index)
        self._n += 1
        return True

    def _materialize(self) -> None:
        if self._lazy:
            pending = self._pending
            for sender, index, d, e, z in self._lazy:
                pending[sender] = DhShare(index, d, e, z)
            self._lazy.clear()

    def __len__(self) -> int:
        """Potential size: pending + verified (the threshold trigger)."""
        return self._n

    def collect_pending(
        self, limit: Optional[int] = None
    ) -> Tuple[List[str], List[DhShare]]:
        """Unverified shares for an external batched verify.

        ``limit=None`` returns everything.  The hub passes
        ``need_more()`` instead: only enough pending shares to reach
        the threshold (counting distinct verified indices already
        held), sorted by sender for determinism.  Surplus shares stay
        parked — verifying a full wave's N shares when f+1 suffice is
        pure modexp waste (the round-3 wave-batching regression: ~2.7x
        the CP checks per pool); if a collected share fails, the next
        flush pulls replacements from the parked surplus.
        """
        self._materialize()
        if limit is None:
            senders = list(self._pending)
        else:
            # skip shares whose Shamir index is already covered (a
            # replayed honest share verifies fine but adds no distinct
            # index) — both against the verified set and within the
            # selected slice; skipped shares stay parked as fallback
            have = {s.index for s in self._verified.values()}
            senders = []
            for sender in sorted(self._pending):
                if len(senders) >= max(limit, 0):
                    break
                idx = self._pending[sender].index
                if idx in have:
                    continue
                have.add(idx)
                senders.append(sender)
        return senders, [self._pending[s] for s in senders]

    def need_more(self) -> int:
        """How many additional verified index-distinct shares the
        threshold still needs (0 = ready or no point verifying)."""
        have = len({s.index for s in self._verified.values()})
        return max(self.threshold - have, 0)

    def apply_verdicts(self, senders: Sequence[str], ok: Sequence[bool]) -> None:
        """Record external verification verdicts: valid shares move to
        the verified set, senders of invalid ones burn."""
        burned_any = False
        for sender, good in zip(senders, ok):
            share = self._pending.pop(sender, None)
            if share is None:
                continue
            if good:
                self._verified[sender] = share
            else:
                self._burned.add(sender)
                self._n -= 1
                burned_any = True
        if burned_any:
            # the burned share may have been an index's only holder:
            # recompute the coverage bound exactly (rare path)
            self._idx_cover = {
                s.index for s in self._pending.values()
            } | {s.index for s in self._verified.values()} | {
                row[1] for row in self._lazy
            }

    def ready(self) -> Optional[List[DhShare]]:
        """>= threshold index-distinct verified shares, or None."""
        by_index: Dict[int, DhShare] = {}
        for share in self._verified.values():
            by_index.setdefault(share.index, share)
        if len(by_index) < self.threshold:
            return None
        return list(by_index.values())

    def optimistic_subset(self) -> Optional[List[DhShare]]:
        """Threshold index-distinct shares counting UNVERIFIED ones
        (verified preferred, then pending by sender order), or None.

        For consumers whose combined output is self-authenticating
        (TPKE: the ciphertext tag checks the combined KEM value), an
        optimistic combine on this subset replaces per-share CP
        verification in the honest case entirely; a tag failure means
        some selected share was invalid, and the caller falls back to
        the verified path, which burns the culprit.  NOT safe for the
        common coin — its combined value has no independent check."""
        self._materialize()
        by_index: Dict[int, DhShare] = {}
        for share in self._verified.values():
            by_index.setdefault(share.index, share)
        for sender in sorted(self._pending):
            share = self._pending[sender]
            by_index.setdefault(share.index, share)
        if len(by_index) < self.threshold:
            return None
        return list(by_index.values())

    def try_verified(self, verify_fn) -> Optional[List[DhShare]]:
        """Self-contained threshold check: if >= threshold shares are
        pooled, batch-verify the pending ones (``verify_fn(shares) ->
        List[bool]``, ONE dispatch under 'cuda'), burn invalid senders,
        and return >= threshold index-distinct valid shares — or None
        if not there yet."""
        if len(self) < self.threshold:
            return None
        senders, shares = self.collect_pending()
        if shares:
            self.apply_verdicts(senders, verify_fn(shares))
        return self.ready()


# The combined value is a pure function of (group, threshold, the
# chosen subset's (index, d) pairs) — z/e play no part in combining.
# Every node of a cluster combines the same subset for the same coin
# or ciphertext, so a bounded memo turns N identical ~threshold-sized
# exponentiation batches into one (cleared wholesale at the cap; keys
# carry the share values, so distinct inputs can never collide).
# Entries hold threshold-many group elements (KBs at large N), so the
# cap is deliberately small; a working set is ~2N live combines.
_COMBINE_MEMO: Dict[tuple, int] = {}
_COMBINE_MEMO_CAP = 1 << 12


def combine_shares(
    shares: Sequence[DhShare],
    threshold: int,
    group: GroupParams = DEFAULT_GROUP,
) -> int:
    """Lagrange-combine >= threshold verified shares into base^s."""
    if len(shares) < threshold:
        raise ValueError(
            f"need >= {threshold} shares to combine, got {len(shares)}"
        )
    use = sorted(shares, key=lambda s: s.index)[:threshold]
    xs = [s.index for s in use]
    if len(set(xs)) != len(xs):
        raise ValueError("duplicate share indices")
    key = (group, threshold, tuple((s.index, s.d) for s in use))
    hit = _COMBINE_MEMO.get(key)
    if hit is not None:
        return hit
    lams = lagrange_coeff_at_zero(xs, group.q)
    acc = 1
    for term in host_pow_batch([sh.d % group.p for sh in use], lams, group):
        acc = acc * term % group.p
    if len(_COMBINE_MEMO) >= _COMBINE_MEMO_CAP:
        _COMBINE_MEMO.clear()
    _COMBINE_MEMO[key] = acc
    return acc


# ---------------------------------------------------------------------------
# TPKE proper: hashed-ElGamal KEM over the threshold-DH core
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ciphertext:
    c1: int  # g^r
    c2: bytes  # msg XOR keystream
    tag: bytes  # integrity tag binding (key, c1, c2)


def _keystream(key: bytes, length: int) -> bytes:
    n_blocks = (length + 31) // 32
    if n_blocks >= 16:
        # batch-size payloads (tens of KB per proposer): hash every
        # counter block in one native crossing — byte-identical to
        # the scalar loop below
        from cleisthenes_tpu_torch.ops.hashrows import sha256_rows

        k = len(key)
        rows = np.empty((n_blocks, k + 6), dtype=np.uint8)
        rows[:, :k] = np.frombuffer(key, dtype=np.uint8)
        rows[:, k : k + 4] = (
            np.arange(n_blocks, dtype=">u4")
            .view(np.uint8)
            .reshape(n_blocks, 4)
        )
        rows[:, k + 4] = ord("k")
        rows[:, k + 5] = ord("s")
        return sha256_rows(rows).tobytes()[:length]
    out = []
    ctr = 0
    while 32 * len(out) < length:
        out.append(
            hashlib.sha256(key + ctr.to_bytes(4, "big") + b"ks").digest()
        )
        ctr += 1
    return b"".join(out)[:length]


def _xor_bytes(a: bytes, b: bytes) -> bytes:
    """a ^ b over equal-length byte strings, vectorized: the stream
    cipher runs over whole proposed batches (tens of KB per proposer),
    where a per-byte python loop costs more than the group math."""
    import numpy as np

    return (
        np.frombuffer(a, dtype=np.uint8) ^ np.frombuffer(b, dtype=np.uint8)
    ).tobytes()


class Tpke:
    """Threshold decryption service for one key set."""

    def __init__(
        self, pub: ThresholdPublicKey, backend: str = "cuda", device="cuda",
        mesh=None,
    ):
        self.pub = pub
        self.backend = backend
        # the card the batched share ops run on (a 'cuda' backend's; the
        # engine resolves it, and raises on a machine without a GPU)
        self.device = device
        # the device mesh its batched share ops shard over, or None
        self.mesh = mesh
        self.group = pub.group  # the key set carries its group

    # TPKE.Encrypt (docs/THRESHOLD_ENCRYPTION-EN.md:34)
    def encrypt(self, msg: bytes, rng=secrets) -> Ciphertext:
        gp = self.group
        # 8 excess bytes: unbiased KEM exponent (same rule as
        # _shamir_shares / issue_share)
        r = (
            int.from_bytes(rng.token_bytes(gp.nbytes + 8), "big") % gp.q
        )
        c1, kem = host_pow_batch(
            [gp.g, self.pub.master], [r, r], gp
        )  # g^r, h^r
        key = hashlib.sha256(b"kem" + _ibytes(kem, gp.nbytes)).digest()
        c2 = _xor_bytes(msg, _keystream(key, len(msg)))
        tag = hmac.new(
            key, _ibytes(c1, gp.nbytes) + c2, hashlib.sha256
        ).digest()
        return Ciphertext(c1=c1, c2=c2, tag=tag)

    def context(self, ct: Ciphertext) -> bytes:
        """The CP-proof context binding shares to this ciphertext
        (public: the protocol hub groups cross-instance verifies by
        (pub, base, context))."""
        return (
            b"tpke|"
            + _ibytes(ct.c1, self.group.nbytes)
            + hashlib.sha256(ct.c2).digest()
        )

    _context = context  # internal alias

    # TPKE.DecShare (docs/THRESHOLD_ENCRYPTION-EN.md:35)
    def dec_share(
        self, share: ThresholdSecretShare, ct: Ciphertext
    ) -> DhShare:
        return issue_share(share, ct.c1, self._context(ct), self.group)

    def dec_share_items(
        self, share: ThresholdSecretShare, cts: Sequence[Ciphertext]
    ) -> List[tuple]:
        """The ``(share, base, context, vk)`` rows
        ``issue_shares_batch`` takes for this key set — the ONE place
        the CP-proof context/vk binding is built, shared by
        ``dec_share_batch`` and the CryptoHub's eager dec-share
        column (K-deep pipelining) so the two issue paths can never
        bind different contexts."""
        vk = self.pub.verification_keys[share.index - 1]
        return [(share, ct.c1, self._context(ct), vk) for ct in cts]

    def dec_share_batch(
        self, share: ThresholdSecretShare, cts: Sequence[Ciphertext]
    ) -> List[DhShare]:
        """All of an epoch's decryption shares in ONE batched
        exponentiation dispatch and one CP-nonce entropy draw —
        semantically ``[dec_share(share, ct) for ct in cts]`` (the
        wave-columnar protocol path's issue seam; scalar dec_share
        was N 4-exp calls + N urandom reads per node per epoch)."""
        if not cts:
            return []
        return issue_shares_batch(
            self.dec_share_items(share, cts),
            group=self.group,
            backend=self.backend,
            device=self.device,
            mesh=self.mesh,
        )

    def verify_dec_shares(
        self, ct: Ciphertext, shares: Sequence[DhShare]
    ) -> List[bool]:
        return verify_shares(
            self.pub, ct.c1, shares, self._context(ct), self.backend,
            self.device, self.mesh,
        )

    # TPKE.Decrypt (docs/THRESHOLD_ENCRYPTION-EN.md:36)
    def combine(
        self, ct: Ciphertext, shares: Sequence[DhShare]
    ) -> bytes:
        """Recover the plaintext from >= f+1 *verified* shares.

        Raises ValueError if the integrity tag does not check out —
        deterministically for every correct node, since the combined
        KEM value is independent of which valid share subset was used.
        """
        kem = combine_shares(shares, self.pub.threshold, self.group)
        key = hashlib.sha256(b"kem" + _ibytes(kem, self.group.nbytes)).digest()
        tag = hmac.new(
            key, _ibytes(ct.c1, self.group.nbytes) + ct.c2, hashlib.sha256
        ).digest()
        if not hmac.compare_digest(tag, ct.tag):
            raise ValueError("TPKE integrity check failed")
        return _xor_bytes(ct.c2, _keystream(key, len(ct.c2)))


__all__ = [
    "is_group_element",
    "ThresholdPublicKey",
    "ThresholdSecretShare",
    "DhShare",
    "SharePool",
    "Ciphertext",
    "deal",
    "issue_share",
    "issue_shares_batch",
    "verify_shares",
    "verify_share_groups",
    "verify_and_combine_share_groups",
    "combine_shares",
    "combine_shares_batch",
    "lagrange_coeff_at_zero",
    "hash_to_group",
    "Tpke",
]
