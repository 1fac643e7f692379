"""Dynamic membership: RECONFIG transactions, in-band key resharing,
and the epoch-boundary roster switch.

The roster stops being a construction-time constant here.  A RECONFIG
transaction — ordinary opaque bytes to the consensus core — names the
next roster version: the full member table (ids + dial addresses) and
one enrollment public key per JOINER (operator-provisioned: the same
trusted channel that hands a new validator its identity today).  Once
it settles, the machinery in this module runs a reshare ceremony and
activates the new roster + fresh TPKE/coin/MAC key material at an
epoch boundary anchored on the ordered frontier:

  1. DISCOVERY — every node sees the RECONFIG tx at the same log
     position (settlement is byte-identical across honest nodes).
     Old-roster nodes install pair keys for the joiners (derived
     below), widen their broadcast set to old ∪ new, and start
     serving the joiners CATCHUP from epoch 0.
  2. DEALING — each old-roster member deals a fresh Feldman sharing
     of a random secret over the NEW roster (ops/dkg.py primitives),
     for TPKE and the coin: t' commitments each, plus one encrypted
     share blob per new member.  The dealing broadcasts eagerly as a
     ``ResharePayload`` (the new message kind riding the existing
     transports) AND is submitted as a dealing transaction.
  3. QUALIFIED SET — the first ``f_old + 1`` structurally valid
     dealings in committed-log order form Q.  Log order is agreed, so
     every honest node picks the identical Q with no complaint
     rounds; f+1 dealers guarantee at least one honest dealing, so
     the summed secret is unknown to any f-coalition.  Validity is a
     pure function of the dealing bytes (commitment shape + subgroup
     membership + a blob per new member), so admission never splits.
  4. FINALIZE — when Q completes at the settlement of epoch e, the
     activation epoch is ``e + Config.reconfig_lead`` (strictly more
     than decrypt_lag_max: no epoch at or past the boundary can have
     been ordered under the old roster).  New members decrypt their
     blobs, verify each share against the dealer's commitments, and
     sum; everyone derives the public keys from the commitments alone
     (identical by construction).  An RCFG WAL record makes the
     switch replayable; crash recovery re-derives the whole ceremony
     from the replayed batches and cross-checks it.
  5. ACTIVATION — epochs >= activation_epoch resolve n/f/keys through
     the new ``RosterVersion``.  Joiners participate from there
     (having adopted the log via CATCHUP); retiring nodes order their
     last epoch at the boundary and park.  Once the SETTLED frontier
     crosses the boundary, retired peers' pair keys drop and their
     dial-health state tears down (transport.health.retire).

Share confidentiality and the MAC re-key ride one static-DH
construction with no extra round trips: an old member's DH identity
is its coin share (secret x_i, public vk_i = g^{x_i} — already in the
coin key's verification table); a joiner's is its enrollment keypair
from the RECONFIG tx.  Any pair (a, b) of the new roster derives
k_ab = H(version || g^{x_a x_b} || a || b) — both ends compute it
locally, nothing secret crosses the wire.  EVERY pair of the new
roster gets a fresh version-keyed MAC key — surviving pairs included:
survivors STAGE the next key at discovery (inbound frames verify
under either key), PROMOTE it to the signing key at the activation
boundary, and DROP the old one at retirement teardown (the rotation
half of ``transport.base.HmacAuthenticator``), so a pair key captured
before a reconfig stops authenticating anything once the reconfig
settles.

Reshare blobs are PUBLICLY verifiable (PVSS): each share is encrypted
chunk-wise to the receiver's static-DH key (ElGamal in the exponent,
16-bit chunks) with an aggregated Chaum-Pedersen DLEQ proof binding
the ciphertext to the dealer's OWN Feldman commitments.  Every node —
receiver of the blob or not — verifies every blob before admitting a
dealing to the qualified set, so a dealer that encrypts garbage to
one targeted receiver is excluded deterministically by ALL honest
nodes at the same log position: no complaint round, no divergence,
the ceremony completes from the remaining dealers.  Residual
(documented in docs/FAULTS.md): the DLEQ binds the weighted SUM of
the chunks, not each chunk's 16-bit range, so a malicious dealer can
still emit non-canonical chunks that verify publicly but fail the
receiver's table decode — the receiver fails loudly exactly as
before, but the attack surface narrows from "any garbage bytes" to
that single malformation.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import struct
from typing import Dict, List, Optional, Sequence, Tuple

from cleisthenes_tpu_torch.core.member import Address, Member, RosterVersion
from cleisthenes_tpu_torch.ops.dkg import DkgDealing, validate_commitments
from cleisthenes_tpu_torch.ops.modmath import GroupParams, get_engine_degraded
from cleisthenes_tpu_torch.ops import tpke as tpke_mod
from cleisthenes_tpu_torch.ops.tpke import (
    ThresholdPublicKey,
    ThresholdSecretShare,
)

# Transaction-space tags: a leading NUL byte keeps protocol-internal
# transactions out of any sane application tx namespace, and the
# version digit hard-partitions future format changes.
RECONFIG_TX_PREFIX = b"\x00RCFG1|"
# RDEAL1 -> RDEAL2: the share blobs became PVSS (chunked ElGamal +
# DLEQ) — a different byte format, hard-partitioned by the version
# digit exactly as the tag comment above promises.
DEAL_TX_PREFIX = b"\x00RDEAL2|"

# DoS bounds on decoded tables (mirrors transport.message's caps)
MAX_ROSTER = 4096


def is_protocol_tx(tx: bytes) -> bool:
    """True for reconfig-machinery transactions (RECONFIG + dealing):
    they are node-originated, so invariants like the fuzzer's
    no-foreign-tx exempt them explicitly."""
    return tx.startswith(RECONFIG_TX_PREFIX) or tx.startswith(
        DEAL_TX_PREFIX
    )


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


def _pack_bytes(out: List[bytes], b: bytes) -> None:
    out.append(struct.pack(">I", len(b)))
    out.append(b)


def _pack_str(out: List[bytes], s: str) -> None:
    _pack_bytes(out, s.encode("utf-8"))


class _Reader:
    __slots__ = ("d", "o")

    def __init__(self, data: bytes, offset: int = 0) -> None:
        self.d = data
        self.o = offset

    def u32(self) -> int:
        if self.o + 4 > len(self.d):
            raise ValueError("truncated reconfig blob")
        (v,) = struct.unpack_from(">I", self.d, self.o)
        self.o += 4
        return v

    def bytes_(self) -> bytes:
        n = self.u32()
        if self.o + n > len(self.d):
            raise ValueError("truncated reconfig blob")
        out = self.d[self.o : self.o + n]
        self.o += n
        return out

    def str_(self) -> str:
        return self.bytes_().decode("utf-8")

    def done(self) -> None:
        if self.o != len(self.d):
            raise ValueError("trailing bytes in reconfig blob")


@dataclasses.dataclass(frozen=True)
class ReconfigSpec:
    """A decoded RECONFIG transaction: the next roster version."""

    version: int
    members: Tuple[Tuple[str, str, int], ...]  # (id, ip, port), sorted
    enroll_pubs: Dict[str, int]  # joiner id -> enrollment public key

    @property
    def member_ids(self) -> Tuple[str, ...]:
        return tuple(m[0] for m in self.members)

    @property
    def n(self) -> int:
        return len(self.members)

    @property
    def f(self) -> int:
        return (len(self.members) - 1) // 3

    @property
    def threshold(self) -> int:
        """Both the TPKE decryption threshold and the coin threshold
        under the new roster (f' + 1, matching setup_keys)."""
        return self.f + 1

    def member_tuple(self) -> Tuple[Member, ...]:
        return tuple(
            Member(id=mid, addr=Address(ip, port))
            for mid, ip, port in self.members
        )


def encode_reconfig_tx(
    version: int,
    members: Sequence[Tuple[str, str, int]],
    enroll_pubs: Dict[str, int],
    group: Optional[GroupParams] = None,
) -> bytes:
    """Build the operator-submitted RECONFIG transaction bytes."""
    group = group or tpke_mod.DEFAULT_GROUP
    out: List[bytes] = [RECONFIG_TX_PREFIX, struct.pack(">I", version)]
    ordered = sorted(members)
    out.append(struct.pack(">I", len(ordered)))
    for mid, ip, port in ordered:
        _pack_str(out, mid)
        _pack_str(out, ip)
        out.append(struct.pack(">I", port))
    out.append(struct.pack(">I", len(enroll_pubs)))
    for mid in sorted(enroll_pubs):
        _pack_str(out, mid)
        _pack_bytes(out, enroll_pubs[mid].to_bytes(group.nbytes, "big"))
    return b"".join(out)


def decode_reconfig_tx(
    tx: bytes, group: Optional[GroupParams] = None
) -> ReconfigSpec:
    """Parse + structurally validate a RECONFIG transaction.  Raises
    ValueError on any malformation — validity is a pure function of
    the bytes, so every honest node accepts or rejects identically."""
    group = group or tpke_mod.DEFAULT_GROUP
    if not tx.startswith(RECONFIG_TX_PREFIX):
        raise ValueError("not a RECONFIG transaction")
    r = _Reader(tx, len(RECONFIG_TX_PREFIX))
    version = r.u32()
    n = r.u32()
    if not (1 <= n <= MAX_ROSTER):
        raise ValueError(f"roster size {n} out of range")
    members: List[Tuple[str, str, int]] = []
    for _ in range(n):
        mid = r.str_()
        ip = r.str_()
        port = r.u32()
        members.append((mid, ip, port))
    if members != sorted(members) or len(
        {m[0] for m in members}
    ) != len(members):
        raise ValueError("member table not sorted/unique")
    enroll: Dict[str, int] = {}
    for _ in range(r.u32()):
        mid = r.str_()
        pub = int.from_bytes(r.bytes_(), "big")
        enroll[mid] = pub
    r.done()
    ids = {m[0] for m in members}
    for mid in sorted(enroll):
        if mid not in ids:
            raise ValueError(f"enrollment key for non-member {mid!r}")
        if not tpke_mod.is_group_element(enroll[mid], group):
            raise ValueError(f"enrollment key for {mid!r} not in group")
    return ReconfigSpec(
        version=version,
        members=tuple(members),
        enroll_pubs=enroll,
    )


@dataclasses.dataclass(frozen=True)
class Dealing:
    """A decoded dealing transaction: one dealer's Feldman sharings
    (TPKE + coin) over the new roster."""

    version: int
    dealer: str
    tpke_commits: Tuple[int, ...]
    coin_commits: Tuple[int, ...]
    blobs: Dict[str, bytes]  # receiver id -> encrypted share pair


def encode_dealing_tx(
    version: int,
    dealer: str,
    tpke_commits: Sequence[int],
    coin_commits: Sequence[int],
    blobs: Dict[str, bytes],
    group: Optional[GroupParams] = None,
) -> bytes:
    group = group or tpke_mod.DEFAULT_GROUP
    nb = group.nbytes
    out: List[bytes] = [DEAL_TX_PREFIX, struct.pack(">I", version)]
    _pack_str(out, dealer)
    out.append(struct.pack(">I", len(tpke_commits)))
    for c in tpke_commits:
        _pack_bytes(out, c.to_bytes(nb, "big"))
    for c in coin_commits:
        _pack_bytes(out, c.to_bytes(nb, "big"))
    out.append(struct.pack(">I", len(blobs)))
    for rid in sorted(blobs):
        _pack_str(out, rid)
        _pack_bytes(out, blobs[rid])
    return b"".join(out)


def decode_dealing_tx(tx: bytes) -> Dealing:
    if not tx.startswith(DEAL_TX_PREFIX):
        raise ValueError("not a dealing transaction")
    r = _Reader(tx, len(DEAL_TX_PREFIX))
    version = r.u32()
    dealer = r.str_()
    t = r.u32()
    if not (1 <= t <= MAX_ROSTER):
        raise ValueError(f"commitment count {t} out of range")
    tpke_commits = tuple(
        int.from_bytes(r.bytes_(), "big") for _ in range(t)
    )
    coin_commits = tuple(
        int.from_bytes(r.bytes_(), "big") for _ in range(t)
    )
    blobs: Dict[str, bytes] = {}
    n = r.u32()
    if n > MAX_ROSTER:
        raise ValueError(f"receiver count {n} out of range")
    for _ in range(n):
        rid = r.str_()
        blobs[rid] = r.bytes_()
    r.done()
    return Dealing(
        version=version,
        dealer=dealer,
        tpke_commits=tpke_commits,
        coin_commits=coin_commits,
        blobs=blobs,
    )


# ---------------------------------------------------------------------------
# pairwise-DH key schedule + share blob cipher
# ---------------------------------------------------------------------------


def enrollment_keypair(
    seed: Optional[int] = None, group: Optional[GroupParams] = None
) -> Tuple[int, int]:
    """A joiner's (secret, public) enrollment pair.  Unseeded draws
    the OS CSPRNG (operator provisioning, not protocol scheduling);
    seeded is for tests/fuzz replays only."""
    group = group or tpke_mod.DEFAULT_GROUP
    if seed is None:
        import secrets

        raw = secrets.token_bytes(group.nbytes + 8)  # staticcheck: allow[DET001] enrollment keygen
    else:
        raw = hashlib.sha256(b"rcfg-enroll|%d" % seed).digest() + (
            hashlib.sha256(b"rcfg-enroll2|%d" % seed).digest()
        )
    x = int.from_bytes(raw, "big") % group.q
    if x == 0:
        x = 1
    return x, pow(group.g, x, group.p)


def dh_point(secret: int, peer_pub: int, group: GroupParams) -> int:
    """g^{x_a x_b} from one side's secret and the other's public."""
    return pow(peer_pub, secret, group.p)


def pair_mac_key(
    version: int, dh: int, a: str, b: str, group: GroupParams
) -> bytes:
    """The new pair's envelope-MAC key: both ends derive it locally
    from the shared DH point (unordered pair, like the dealer's
    ``HmacAuthenticator.pair_key`` schedule)."""
    lo, hi = sorted((a.encode("utf-8"), b.encode("utf-8")))
    return hashlib.sha256(
        b"rcfgmac|%d|" % version
        + dh.to_bytes(group.nbytes, "big")
        + b"|" + lo + b"|" + hi
    ).digest()


# ---------------------------------------------------------------------------
# PVSS share blobs: chunked ElGamal-in-the-exponent + aggregated DLEQ
# ---------------------------------------------------------------------------
#
# A share s in Z_q splits into m big-endian 16-bit chunks s_k.  Each
# chunk encrypts to the receiver's static-DH key y as an ElGamal pair
# in the exponent: (A_k, E_k) = (g^{rho_k}, y^{rho_k} * g^{s_k}).
# With weights w_k = 2^{16(m-1-k)}, the products Abar = prod A_k^{w_k}
# and Ebar = prod E_k^{w_k} satisfy Abar = g^{rho}, Ebar = y^{rho} *
# g^{s} for rho = sum rho_k w_k — so a single Chaum-Pedersen DLEQ
# proof over (g, y) for the pair (Abar, Ebar / X_j), where X_j =
# prod C_i^{j^i} is the share's Feldman image, PUBLICLY proves the
# blob decrypts (under the receiver's secret) to the exact share the
# dealer committed to — mod q, up to the non-canonical-chunk residual
# the module docstring describes.  The receiver recovers each g^{s_k}
# as E_k * A_k^{-x} and inverts it through a 2^16-entry table.

PVSS_CHUNK_BITS = 16
PVSS_CHUNK_BASE = 1 << PVSS_CHUNK_BITS


def _pvss_chunk_count(group: GroupParams) -> int:
    return -(-group.q.bit_length() // PVSS_CHUNK_BITS)


def pvss_blob_len(group: GroupParams) -> int:
    """Exact byte length of one receiver's blob: two share sections
    (tpke then coin), each m ciphertext pairs (A_k, E_k) of one group
    element apiece plus the compact DLEQ proof (c: 32 bytes, z: one
    scalar) — a pure function of the group, so malformed lengths
    reject before any group math."""
    nb = group.nbytes
    m = _pvss_chunk_count(group)
    return 2 * (2 * m * nb + 32 + nb)


@functools.lru_cache(maxsize=4)
def _pvss_tables(group: GroupParams):
    """(powers, dlog): g^v for v in [0, 2^16) and the inverse map —
    the chunk codec.  Built once per group (~20 ms, ~4 MB for the
    default 256-bit group)."""
    size = min(PVSS_CHUNK_BASE, group.q)
    powers: List[int] = [0] * size
    dlog: Dict[int, int] = {}
    acc = 1
    for v in range(size):
        powers[v] = acc
        dlog[acc] = v
        acc = acc * group.g % group.p
    return powers, dlog


@functools.lru_cache(maxsize=4)
def _pvss_weights(group: GroupParams) -> Tuple[int, ...]:
    m = _pvss_chunk_count(group)
    return tuple(
        pow(PVSS_CHUNK_BASE, m - 1 - k, group.q) for k in range(m)
    )


def _pvss_engine(group: GroupParams):
    """The batched-modexp engine for PVSS hot loops (the native cpu
    kernel is ~8x builtin pow; the tpu path batches further)."""
    return get_engine_degraded("cpu", group)


def _jacobi(a: int, n: int) -> int:
    """Jacobi symbol (a/n), n odd positive.  For the safe-prime groups
    here (p = 2q + 1) membership in the order-q QR subgroup is exactly
    (a/p) == 1 — a gcd-speed screen, vs a full modexp per element."""
    a %= n
    result = 1
    while a:
        while a % 2 == 0:
            a //= 2
            if n % 8 in (3, 5):
                result = -result
        a, n = n, a
        if a % 4 == 3 and n % 4 == 3:
            result = -result
        a %= n
    return result if n == 1 else 0


def _pvss_scalar(seed: bytes, k: int, q: int) -> int:
    """Deterministic scalar expansion: 512 hash bits mod q (bias
    negligible at these widths); index m doubles as the DLEQ witness
    slot."""
    tag = seed + struct.pack(">I", k)
    v = int.from_bytes(
        hashlib.sha256(tag + b"|a").digest()
        + hashlib.sha256(tag + b"|b").digest(),
        "big",
    ) % q
    return v or 1


def _pvss_ctx(
    version: int,
    dealer: str,
    receiver: str,
    kind: int,
    commits: Sequence[int],
    group: GroupParams,
) -> bytes:
    """The Fiat-Shamir statement prefix: binds the proof to this
    (version, dealer, receiver, share-kind) slot AND the dealer's
    commitment vector, so a proof cannot be replayed across slots or
    against substituted commitments."""
    nb = group.nbytes
    h = hashlib.sha256(
        b"rcfgpvss|%d|" % version
        + dealer.encode("utf-8")
        + b"|"
        + receiver.encode("utf-8")
        + b"|%d|" % kind
    )
    for c in commits:
        h.update(c.to_bytes(nb, "big"))
    return h.digest()


def _pvss_challenge(
    ctx: bytes,
    y: int,
    cipher: Sequence[int],
    t1: int,
    t2: int,
    group: GroupParams,
) -> int:
    nb = group.nbytes
    h = hashlib.sha256(ctx)
    h.update(y.to_bytes(nb, "big"))
    for v in cipher:
        h.update(v.to_bytes(nb, "big"))
    h.update(t1.to_bytes(nb, "big"))
    h.update(t2.to_bytes(nb, "big"))
    return int.from_bytes(h.digest(), "big") % group.q


def pvss_encrypt_share(
    s: int,
    y: int,
    rho_seed: bytes,
    ctx: bytes,
    group: GroupParams,
    eng=None,
) -> bytes:
    """One share -> one blob section: m chunk ciphertexts followed by
    the compact DLEQ proof (c, z).  ``rho_seed`` expands to the m
    chunk randomizers and the proof witness (CSPRNG-derived in
    production, seed-derived in fuzz replays)."""
    p, q, g = group.p, group.q, group.g
    nb = group.nbytes
    m = _pvss_chunk_count(group)
    powers, _ = _pvss_tables(group)
    weights = _pvss_weights(group)
    eng = eng if eng is not None else _pvss_engine(group)
    s %= q
    chunks = [
        (s >> (PVSS_CHUNK_BITS * (m - 1 - k))) & (PVSS_CHUNK_BASE - 1)
        for k in range(m)
    ]
    rhos = [_pvss_scalar(rho_seed, k, q) for k in range(m)]
    w = _pvss_scalar(rho_seed, m, q)
    out = eng.pow_batch(
        [g] * m + [y] * m + [g, y], rhos + rhos + [w, w]
    )
    cipher: List[int] = []
    for k in range(m):
        cipher.append(out[k])  # A_k = g^{rho_k}
        cipher.append(out[m + k] * powers[chunks[k]] % p)  # E_k
    t1, t2 = out[2 * m], out[2 * m + 1]
    rho = sum(r * wk for r, wk in zip(rhos, weights)) % q
    c = _pvss_challenge(ctx, y, cipher, t1, t2, group)
    z = (w + c * rho) % q
    return (
        b"".join(v.to_bytes(nb, "big") for v in cipher)
        + c.to_bytes(32, "big")
        + z.to_bytes(nb, "big")
    )


def _pvss_parse_section(
    blob: bytes, kind: int, group: GroupParams
) -> Tuple[List[int], int, int]:
    nb = group.nbytes
    m = _pvss_chunk_count(group)
    half = pvss_blob_len(group) // 2
    sec = blob[kind * half : (kind + 1) * half]
    cipher = [
        int.from_bytes(sec[i * nb : (i + 1) * nb], "big")
        for i in range(2 * m)
    ]
    off = 2 * m * nb
    c = int.from_bytes(sec[off : off + 32], "big")
    z = int.from_bytes(sec[off + 32 :], "big")
    return cipher, c, z


def pvss_verify_dealing(
    dealing: "Dealing",
    pubs: Dict[str, int],
    group: GroupParams,
    eng=None,
) -> bool:
    """PUBLIC verification of every receiver blob in a dealing against
    the dealer's own commitments — a pure function of (dealing bytes,
    receiver DH public keys), so every honest node admits or excludes
    the dealer identically.  ``pubs`` maps receiver id -> static-DH
    public key in ``sorted(dealing.blobs)`` == new-roster order (the
    1-based Shamir index is the position in that order)."""
    p, q, g = group.p, group.q, group.g
    m = _pvss_chunk_count(group)
    blob_len = pvss_blob_len(group)
    eng = eng if eng is not None else _pvss_engine(group)
    ids = sorted(dealing.blobs)
    entries = []  # (y, X_j, cipher, c, z)
    for j, rid in enumerate(ids, start=1):
        blob = dealing.blobs[rid]
        y = pubs.get(rid)
        if y is None or len(blob) != blob_len:
            return False
        for kind, commits in (
            (0, dealing.tpke_commits),
            (1, dealing.coin_commits),
        ):
            cipher, c, z = _pvss_parse_section(blob, kind, group)
            if not (0 <= c < q and 0 <= z < q):
                return False
            for v in cipher:
                # subgroup screen: QR test at gcd speed
                if not (0 < v < p) or _jacobi(v, p) != 1:
                    return False
            # X_j = prod C_i^{j^i}, Horner in the (small) exponent j
            x_j = commits[-1]
            for cm in reversed(commits[:-1]):
                x_j = pow(x_j, j, p) * cm % p
            ctx = _pvss_ctx(
                dealing.version, dealing.dealer, rid, kind, commits,
                group,
            )
            entries.append((y, x_j, cipher, c, z, ctx))
    # Abar/Ebar via Horner in the chunk base (16 squarings/step beats
    # a full modexp per weight), X^{-1} and the DLEQ legs batched
    aggs = []
    for y, x_j, cipher, c, z, ctx in entries:
        abar, ebar = cipher[0], cipher[1]
        for k in range(1, m):
            abar = pow(abar, PVSS_CHUNK_BASE, p) * cipher[2 * k] % p
            ebar = (
                pow(ebar, PVSS_CHUNK_BASE, p) * cipher[2 * k + 1] % p
            )
        aggs.append((abar, ebar))
    x_invs = eng.pow_batch(
        [e[1] for e in entries], [p - 2] * len(entries)
    )
    bases: List[int] = []
    exps: List[int] = []
    for (y, x_j, cipher, c, z, ctx), (abar, ebar), x_inv in zip(
        entries, aggs, x_invs
    ):
        u = ebar * x_inv % p
        neg_c = (q - c) % q
        bases.extend((g, y, abar, u))
        exps.extend((z, z, neg_c, neg_c))
    legs = eng.pow_batch(bases, exps)
    for i, (y, x_j, cipher, c, z, ctx) in enumerate(entries):
        g_z, y_z, a_negc, u_negc = legs[4 * i : 4 * i + 4]
        t1 = g_z * a_negc % p
        t2 = y_z * u_negc % p
        if _pvss_challenge(ctx, y, cipher, t1, t2, group) != c:
            return False
    return True


def pvss_decrypt_share(
    blob: bytes, kind: int, x: int, group: GroupParams, eng=None
) -> int:
    """Receiver-side decode of one share section under the receiver's
    static-DH secret ``x``.  Raises ValueError when a chunk falls
    outside the canonical 16-bit range — the documented residual a
    publicly-verified dealing can still hit; the caller fails loudly
    rather than diverging."""
    p, q = group.p, group.q
    m = _pvss_chunk_count(group)
    weights = _pvss_weights(group)
    _, dlog = _pvss_tables(group)
    eng = eng if eng is not None else _pvss_engine(group)
    cipher, _c, _z = _pvss_parse_section(blob, kind, group)
    a_inv = eng.pow_batch(cipher[0::2], [(q - x % q) % q] * m)
    s = 0
    for k in range(m):
        v = dlog.get(cipher[2 * k + 1] * a_inv[k] % p)
        if v is None:
            raise ValueError(
                f"PVSS chunk {k} outside the canonical range"
            )
        s = (s + v * weights[k]) % q
    return s


# memo for the (pure) public verification: settled dealing txs are
# re-scanned on WAL replay and by every node of an in-process cluster;
# the verdict is a function of the tx bytes + the (agreed) receiver
# key table, so one computation serves them all
_PVSS_VERDICTS: Dict[bytes, bool] = {}
_PVSS_VERDICT_CAP = 512


def key_material_digest(
    tpke_pub: ThresholdPublicKey, coin_pub: ThresholdPublicKey
) -> bytes:
    """Commitment to a version's public threshold key material — a
    pure function of the agreed ceremony, so byte-identical across
    honest nodes (the fuzzer's key-agreement invariant)."""
    h = hashlib.sha256(b"rcfgkeys|")
    nb = tpke_pub.group.nbytes
    for pub in (tpke_pub, coin_pub):
        h.update(struct.pack(">II", pub.n, pub.threshold))
        h.update(pub.master.to_bytes(nb, "big"))
        for vk in pub.verification_keys:
            h.update(vk.to_bytes(nb, "big"))
    return h.digest()


def finalize_public(
    commit_sets: Sequence[Sequence[int]],
    n: int,
    threshold: int,
    group: GroupParams,
    backend: str = "cpu",
) -> ThresholdPublicKey:
    """The public half of ops.dkg.finalize — master key and the full
    verification-key table from the qualified dealers' commitments
    alone.  Every node (member or not, joiner or retiree) derives the
    identical key because the inputs are committed-log bytes."""
    from cleisthenes_tpu_torch.ops.dkg import finalize

    commits = {i + 1: list(c) for i, c in enumerate(commit_sets)}
    # dkg.finalize computes exactly the public table we need; the
    # zero "shares" exist only to satisfy its signature and the
    # returned (meaningless) share is discarded
    pub, _zero = finalize(
        commits,
        1,
        {i: 0 for i in commits},
        n,
        threshold,
        group=group,
        backend=backend,
    )
    return pub


# ---------------------------------------------------------------------------
# the ceremony state machine
# ---------------------------------------------------------------------------


class _PendingCeremony:
    __slots__ = (
        "spec",
        "discovered_epoch",
        "need",
        "dealings",
        "staged",
        "should_deal",
        "dealt",
        "t0",
    )

    def __init__(
        self, spec: ReconfigSpec, discovered_epoch: int, need: int
    ) -> None:
        self.spec = spec
        self.discovered_epoch = discovered_epoch
        self.need = need  # f_old + 1 qualified dealers
        # dealer id -> Dealing, admission (= committed-log) order
        self.dealings: Dict[str, Dealing] = {}
        # eager gossip staging: dealer id -> dealing tx bytes
        self.staged: Dict[str, bytes] = {}
        self.should_deal = False
        self.dealt = False
        self.t0 = 0.0  # ceremony trace-span start (0 when tracing off)


class ReconfigManager:
    """One node's reconfig plane: discovery, dealing, qualified-set
    tracking, finalize — driven entirely from settled batches (plus
    the eager ``ResharePayload`` gossip), so it is deterministic given
    the committed log.

    Owned by (and coupled to) one HoneyBadger, same pattern as the
    WaveRouter: it never touches the wire or the WAL directly except
    through its owner's seams.
    """

    def __init__(self, hb) -> None:
        self._hb = hb
        self._pending: Optional[_PendingCeremony] = None
        # versions whose gossip already nudged our catch-up chase
        self._nudged: set = set()
        # True while the constructor replays the WAL: suppresses
        # re-broadcasting / re-submitting / re-writing what the log
        # already proves happened
        self.replaying = False

    # -- membership over time ---------------------------------------------

    def known_member(self, sender: str) -> bool:
        """Epoch-unscoped membership (CATCHUP, reshare gossip): any
        version's member — past, active, or pending — is a legitimate
        correspondent during the transition window."""
        hb = self._hb
        if sender in hb.rosters.known_member_ids():
            return True
        p = self._pending
        return p is not None and sender in p.spec.member_ids

    @property
    def pending_version(self) -> Optional[int]:
        p = self._pending
        return None if p is None else p.spec.version

    # -- settled-batch scan (the only consensus-coupled entry) --------------

    def on_batch_settled(self, epoch: int, batch) -> None:
        """Called by the owner for EVERY settled batch, in epoch
        order (live commits, catch-up adoptions, and WAL replay all
        funnel here) — the reconfig plane's whole view of time."""
        for tx in batch.tx_list():
            if tx.startswith(DEAL_TX_PREFIX):
                self._on_deal_tx(epoch, tx)
            elif tx.startswith(RECONFIG_TX_PREFIX):
                self._on_reconfig_tx(epoch, tx)

    def _on_reconfig_tx(self, epoch: int, tx: bytes) -> None:
        hb = self._hb
        if self._pending is not None:
            return  # one ceremony at a time; extras ignored identically
        latest = hb.rosters.latest()
        if epoch < latest.activation_epoch:
            # settled under an older roster than the one already
            # switched to (replay of history): a RECONFIG here was
            # consumed by a ceremony the schedule already carries
            return
        try:
            spec = decode_reconfig_tx(tx, hb.group)
        except ValueError:
            return  # malformed: every honest node drops it identically
        if spec.version != latest.version + 1:
            return
        old_ids = set(latest.member_ids)
        joiners = [m for m in spec.member_ids if m not in old_ids]
        if any(j not in spec.enroll_pubs for j in joiners):
            return  # joiner without an enrollment key cannot be keyed
        pending = _PendingCeremony(
            spec, epoch, need=latest.f + 1
        )
        self._pending = pending
        tr = hb.trace
        if tr is not None:
            pending.t0 = tr.now()
            tr.instant(
                "reconfig",
                "discovered",
                version=spec.version,
                epoch=epoch,
                joiners=len(joiners),
                retiring=len(old_ids - set(spec.member_ids)),
            )
        hb.on_reconfig_discovered(pending.spec, joiners)
        if hb.node_id in old_ids:
            pending.should_deal = True
            if not self.replaying:
                self._deal_now()

    def after_replay(self) -> None:
        """WAL replay finished: re-enter the live protocol.  A dealer
        that crashed mid-ceremony re-deals (its un-committed dealing
        tx died with its mempool; a fresh dealing is just as good —
        the qualified set takes the first f+1 in log order), and the
        re-derived roster schedule is cross-checked against the RCFG
        records the crashed process wrote."""
        self.replaying = False
        hb = self._hb
        if hb.batch_log is not None:
            for (
                version,
                activation,
                _members,
                key_digest,
            ) in hb.batch_log.replay_reconfigs():
                for rv in hb.rosters:
                    if rv.version == version:
                        if (
                            rv.activation_epoch != activation
                            or rv.key_material_digest != key_digest
                        ):
                            raise RuntimeError(
                                f"WAL RCFG v{version} disagrees with "
                                "the ceremony re-derived from the "
                                "replayed log"
                            )
                        break
        p = self._pending
        if (
            p is not None
            and p.should_deal
            and not p.dealt
            and p.dealings.get(hb.node_id) is None
        ):
            self._deal_now()

    # -- dealing ------------------------------------------------------------

    def _dealing_seed(self, kind_offset: int) -> Optional[int]:
        """Deterministic dealing polynomials for seeded runs (fuzz
        replays); None (CSPRNG inside DkgDealing) in production."""
        hb = self._hb
        if hb.config.seed is None:
            return None
        p = self._pending
        h = hashlib.sha256(
            b"rcfgdeal|%d|%d|%d|" % (hb.config.seed, p.spec.version,
                                     kind_offset)
            + hb.node_id.encode("utf-8")
        ).digest()
        return int.from_bytes(h[:8], "big")

    def _blob_seed(self, rid: str, kind: int) -> bytes:
        """Expansion seed for one blob's chunk randomizers + DLEQ
        witness: CSPRNG in production, config-seed-derived in fuzz
        replays (same policy as ``_dealing_seed``)."""
        hb = self._hb
        if hb.config.seed is None:
            import secrets

            return secrets.token_bytes(32)  # staticcheck: allow[DET001] PVSS randomizers
        p = self._pending
        return hashlib.sha256(
            b"rcfgpvssrho|%d|%d|%d|"
            % (hb.config.seed, p.spec.version, kind)
            + hb.node_id.encode("utf-8")
            + b"|"
            + rid.encode("utf-8")
        ).digest()

    def _deal_now(self) -> None:
        hb = self._hb
        p = self._pending
        spec = p.spec
        p.dealt = True
        group = hb.group
        t_new = spec.threshold
        old_view = hb.active_view
        old_index = old_view.member_ids.index(hb.node_id) + 1
        deal_t = DkgDealing(
            old_index, spec.n, t_new, group, seed=self._dealing_seed(0)
        )
        deal_c = DkgDealing(
            old_index, spec.n, t_new, group, seed=self._dealing_seed(1)
        )
        tpke_commits = deal_t.commitments(backend="cpu")
        coin_commits = deal_c.commitments(backend="cpu")
        eng = _pvss_engine(group)
        blobs: Dict[str, bytes] = {}
        for j, rid in enumerate(spec.member_ids, start=1):
            y = self._dh_pub_for(rid)
            parts: List[bytes] = []
            for kind, (deal, commits) in enumerate(
                ((deal_t, tpke_commits), (deal_c, coin_commits))
            ):
                parts.append(
                    pvss_encrypt_share(
                        deal.share_for(j),
                        y,
                        self._blob_seed(rid, kind),
                        _pvss_ctx(
                            spec.version, hb.node_id, rid, kind,
                            commits, group,
                        ),
                        group,
                        eng,
                    )
                )
            blobs[rid] = b"".join(parts)
        tx = encode_dealing_tx(
            spec.version,
            hb.node_id,
            tpke_commits,
            coin_commits,
            blobs,
            group,
        )
        tr = hb.trace
        if tr is not None:
            tr.instant(
                "reconfig", "deal", version=spec.version, bytes=len(tx)
            )
        from cleisthenes_tpu_torch.transport.message import ResharePayload

        hb.out.broadcast(
            ResharePayload(spec.version, hb.node_id, tx)
        )
        hb.add_transaction(tx)
        if hb.auto_propose:
            # the dealing rides the normal tx path, but the epoch
            # drive may have gone quiescent before it was queued (the
            # settle that discovered the RECONFIG postdates the last
            # ordering): kick a proposal so the ceremony makes
            # progress without waiting for client traffic
            hb.start_epoch()

    def _dh_pub_for(self, member_id: str) -> int:
        """A new-roster member's static-DH public key: its enrollment
        key (joiner) or its OLD coin verification key (survivor)."""
        p = self._pending
        pub = p.spec.enroll_pubs.get(member_id)
        if pub is not None:
            return pub
        hb = self._hb
        old_view = hb.active_view
        idx = old_view.member_ids.index(member_id)
        # an old member's view carries its key set; a JOINER's view of
        # the old roster is non-local, but its bootstrap NodeKeys hold
        # the same (public) coin key the operator provisioned
        coin_pub = (
            old_view.keys.coin_pub
            if old_view.keys is not None
            else hb.keys.coin_pub
        )
        return coin_pub.verification_keys[idx]

    def _dh_secret(self) -> int:
        """This node's static-DH secret: its old coin share
        (survivor/retiree) or its enrollment secret (joiner)."""
        hb = self._hb
        old_view = hb.active_view
        if hb.node_id in old_view.member_ids:
            return old_view.keys.coin_share.value
        if hb.keys.enroll_secret is None:
            raise RuntimeError(
                f"{hb.node_id}: joiner without an enrollment secret"
            )
        return hb.keys.enroll_secret

    def joiner_pair_keys(self, spec: ReconfigSpec) -> Dict[str, bytes]:
        """Pair keys between THIS node and every ceremony
        counterparty it does not already share one with (the joiner
        pairs) — installed at discovery on both sides so pre-
        activation CATCHUP authenticates."""
        hb = self._hb
        group = hb.group
        old_ids = set(hb.active_view.member_ids)
        if (
            hb.node_id not in old_ids
            and hb.node_id not in spec.member_ids
        ):
            # pure observer (e.g. a later joiner replaying history
            # from before its own enrollment): no pairs to derive
            return {}
        mine = self._dh_secret()
        out: Dict[str, bytes] = {}
        for rid in spec.member_ids:
            if rid == hb.node_id:
                continue
            if rid in old_ids and hb.node_id in old_ids:
                # surviving pair: its fresh key is STAGED, not
                # installed — see rotation_pair_keys
                continue
            dh = dh_point(mine, self._dh_pub_for(rid), group)
            out[rid] = pair_mac_key(
                spec.version, dh, hb.node_id, rid, group
            )
        return out

    def rotation_pair_keys(self, spec: ReconfigSpec) -> Dict[str, bytes]:
        """Fresh version-keyed MAC keys for this node's SURVIVING
        pairs (both ends in the old AND the new roster) — the MAC
        rotation's key schedule.  Installed via ``stage_peer_key`` at
        discovery (verify-either), promoted to the signing key at the
        activation boundary, with the old key dropped at teardown; a
        hard swap instead would reject every in-flight frame
        straddling the boundary."""
        hb = self._hb
        group = hb.group
        old_ids = set(hb.active_view.member_ids)
        if (
            hb.node_id not in old_ids
            or hb.node_id not in spec.member_ids
        ):
            return {}  # joiners and retirees have no surviving pairs
        mine = self._dh_secret()
        out: Dict[str, bytes] = {}
        for rid in spec.member_ids:
            if rid not in old_ids:
                continue  # joiner pair: installed, not staged
            # the self pair rotates too (loopback frames must track
            # the version's NodeKeys)
            dh = dh_point(mine, self._dh_pub_for(rid), group)
            out[rid] = pair_mac_key(
                spec.version, dh, hb.node_id, rid, group
            )
        return out

    # -- gossip (the ResharePayload message kind) ----------------------------

    def on_reshare_payload(self, sender: str, payload) -> None:
        """Eager dealing distribution + the joiner's bootstrap nudge.
        Staging is best-effort: the committed dealing tx is
        authoritative, so a dropped/forged gossip frame costs nothing
        but latency."""
        hb = self._hb
        p = self._pending
        if p is None or payload.version != p.spec.version:
            latest = hb.rosters.latest().version
            if (
                payload.version > latest
                and payload.version not in self._nudged
            ):
                # a ceremony we have not discovered yet is underway:
                # we are behind the log (the joiner's very first
                # signal) — chase it
                self._nudged.add(payload.version)
                hb._request_catchup(force=True)
            return
        if sender != payload.dealer or sender in p.staged:
            return
        try:
            dealing = decode_dealing_tx(payload.body)
        except ValueError:
            return
        if (
            dealing.version != p.spec.version
            or dealing.dealer != sender
        ):
            return
        p.staged[sender] = payload.body
        tr = hb.trace
        if tr is not None:
            tr.instant(
                "reconfig",
                "staged",
                version=p.spec.version,
                dealer=sender,
            )

    # -- qualified set + finalize -------------------------------------------

    def _on_deal_tx(self, epoch: int, tx: bytes) -> None:
        hb = self._hb
        p = self._pending
        if p is None:
            return
        try:
            dealing = decode_dealing_tx(tx)
        except ValueError:
            return
        spec = p.spec
        if dealing.version != spec.version:
            return
        old_view = hb.active_view
        if dealing.dealer not in old_view.member_ids:
            return
        if dealing.dealer in p.dealings:
            return  # first dealing per dealer wins (log order)
        t_new = spec.threshold
        if (
            len(dealing.tpke_commits) != t_new
            or len(dealing.coin_commits) != t_new
        ):
            return
        if sorted(dealing.blobs) != list(spec.member_ids):
            return  # must key every new member
        blen = pvss_blob_len(hb.group)
        if any(len(b) != blen for b in dealing.blobs.values()):
            return
        ok = validate_commitments(
            [dealing.tpke_commits, dealing.coin_commits],
            group=hb.group,
            backend="cpu",
            threshold=t_new,
        )
        if not all(ok):
            return  # commitment outside the prime-order subgroup
        if not self._pvss_check(tx, dealing, spec):
            # a blob fails public verification (e.g. targeted garbage
            # to one receiver): EVERY honest node rejects this dealing
            # at this log position — the dealer is excluded from Q
            # deterministically, no complaint round needed
            tr = hb.trace
            if tr is not None:
                tr.instant(
                    "reconfig",
                    "pvss_reject",
                    version=dealing.version,
                    dealer=dealing.dealer,
                )
            return
        p.dealings[dealing.dealer] = dealing
        if len(p.dealings) >= p.need:
            self._finalize(epoch)

    def _pvss_check(self, tx: bytes, dealing: Dealing, spec) -> bool:
        """Memoized ``pvss_verify_dealing``: the verdict is a pure
        function of the tx bytes + the version's (agreed) receiver key
        table, and the same settled tx is re-scanned on WAL replay and
        by every node of an in-process cluster."""
        digest = hashlib.sha256(tx).digest()
        verdict = _PVSS_VERDICTS.get(digest)
        if verdict is None:
            group = self._hb.group
            pubs = {
                rid: self._dh_pub_for(rid)
                for rid in spec.member_ids
            }
            verdict = pvss_verify_dealing(
                dealing, pubs, group, _pvss_engine(group)
            )
            while len(_PVSS_VERDICTS) >= _PVSS_VERDICT_CAP:
                _PVSS_VERDICTS.pop(next(iter(_PVSS_VERDICTS)))
            _PVSS_VERDICTS[digest] = verdict
        return verdict

    def _finalize(self, epoch: int) -> None:
        """Q is complete at the settlement of ``epoch``: derive the
        new key material, pick the activation boundary, and install
        the roster version."""
        hb = self._hb
        p = self._pending
        spec = p.spec
        group = hb.group
        t_new = spec.threshold
        activation = epoch + hb.config.reconfig_lead
        dealers = list(p.dealings)  # admission (log) order
        tpke_pub = finalize_public(
            [p.dealings[d].tpke_commits for d in dealers],
            spec.n,
            t_new,
            group,
        )
        coin_pub = finalize_public(
            [p.dealings[d].coin_commits for d in dealers],
            spec.n,
            t_new,
            group,
        )
        digest = key_material_digest(tpke_pub, coin_pub)
        keys = None
        if hb.node_id in spec.member_ids:
            keys = self._derive_member_keys(
                spec, dealers, tpke_pub, coin_pub
            )
        rv = RosterVersion(
            version=spec.version,
            activation_epoch=activation,
            members=spec.member_tuple(),
            key_material_digest=digest,
        )
        tr = hb.trace
        if tr is not None:
            tr.complete(
                "reconfig",
                "ceremony",
                p.t0,
                version=spec.version,
                dealers=len(dealers),
                activation_epoch=activation,
            )
        self._pending = None
        hb.install_roster_version(rv, keys, spec)

    def _derive_member_keys(
        self,
        spec: ReconfigSpec,
        dealers: Sequence[str],
        tpke_pub: ThresholdPublicKey,
        coin_pub: ThresholdPublicKey,
    ):
        """Decrypt, verify and fold this member's shares from every
        qualified dealing, and assemble the version's NodeKeys (MAC
        schedule included)."""
        from cleisthenes_tpu_torch.protocol.honeybadger import NodeKeys
        from cleisthenes_tpu_torch.ops.dkg import verify_dealer_shares

        hb = self._hb
        p = self._pending
        group = hb.group
        my_index = spec.member_ids.index(hb.node_id) + 1
        mine = self._dh_secret()
        eng = _pvss_engine(group)
        s_tpke_total = 0
        s_coin_total = 0
        check_items = []
        for d in dealers:
            dealing = p.dealings[d]
            blob = dealing.blobs[hb.node_id]
            try:
                s_t = pvss_decrypt_share(blob, 0, mine, group, eng)
                s_c = pvss_decrypt_share(blob, 1, mine, group, eng)
            except ValueError as exc:
                # a PUBLICLY verified dealing can only fail here via
                # the non-canonical-chunk residual (module docstring):
                # fail LOUDLY — diverging silently would fork the
                # roster
                raise RuntimeError(
                    f"{hb.node_id}: reshare v{spec.version} blob from "
                    f"dealer {d} failed chunk decode ({exc})"
                ) from exc
            check_items.append((dealing.tpke_commits, my_index, s_t))
            check_items.append((dealing.coin_commits, my_index, s_c))
            s_tpke_total = (s_tpke_total + s_t) % group.q
            s_coin_total = (s_coin_total + s_c) % group.q
        # defense-in-depth sanity: with canonical chunks the DLEQ
        # already pins g^s == X_j, so this can only fire on a bug
        verdicts = verify_dealer_shares(
            check_items, group=group, backend="cpu"
        )
        if not all(verdicts):
            bad = sorted(
                {
                    dealers[i // 2]
                    for i, ok in enumerate(verdicts)
                    if not ok
                }
            )
            raise RuntimeError(
                f"{hb.node_id}: reshare v{spec.version} shares from "
                f"dealers {bad} fail commitment verification"
            )
        # MAC rotation: EVERY pair of the new roster gets a fresh
        # version-keyed MAC key — surviving pairs included (they stage
        # it at discovery and promote at activation; see the module
        # docstring and HmacAuthenticator's rotation half)
        mac_keys: Dict[str, bytes] = {}
        for rid in spec.member_ids:
            dh = dh_point(mine, self._dh_pub_for(rid), group)
            mac_keys[rid] = pair_mac_key(
                spec.version, dh, hb.node_id, rid, group
            )
        return NodeKeys(
            tpke_pub=tpke_pub,
            tpke_share=ThresholdSecretShare(
                index=my_index, value=s_tpke_total
            ),
            coin_pub=coin_pub,
            coin_share=ThresholdSecretShare(
                index=my_index, value=s_coin_total
            ),
            mac_keys=mac_keys,
            enroll_secret=hb.keys.enroll_secret,
        )


def joiner_bootstrap_keys(
    enroll_secret: int,
    version: int,
    old_coin_pub: ThresholdPublicKey,
    old_member_ids: Sequence[str],
    self_id: str,
) -> Dict[str, bytes]:
    """The pair-key map a JOINER boots with: one DH-derived key per
    old-roster member (the counterpart of ``joiner_pair_keys`` on the
    old side), plus its self-pair — enough to authenticate CATCHUP
    before activation.  The operator provisions the joiner with the
    old roster's public coin key; nothing here is secret to the
    operator beyond the joiner's own enrollment secret."""
    group = old_coin_pub.group
    ordered = sorted(old_member_ids)
    out: Dict[str, bytes] = {}
    for i, mid in enumerate(ordered):
        if mid == self_id:
            continue
        dh = dh_point(
            enroll_secret, old_coin_pub.verification_keys[i], group
        )
        out[mid] = pair_mac_key(version, dh, self_id, mid, group)
    self_pub = pow(group.g, enroll_secret, group.p)
    out[self_id] = pair_mac_key(
        version,
        dh_point(enroll_secret, self_pub, group),
        self_id,
        self_id,
        group,
    )
    return out


__all__ = [
    "RECONFIG_TX_PREFIX",
    "DEAL_TX_PREFIX",
    "ReconfigSpec",
    "Dealing",
    "ReconfigManager",
    "is_protocol_tx",
    "encode_reconfig_tx",
    "decode_reconfig_tx",
    "encode_dealing_tx",
    "decode_dealing_tx",
    "enrollment_keypair",
    "joiner_bootstrap_keys",
    "pair_mac_key",
    "dh_point",
    "key_material_digest",
    "finalize_public",
    "pvss_blob_len",
    "pvss_encrypt_share",
    "pvss_verify_dealing",
    "pvss_decrypt_share",
]
