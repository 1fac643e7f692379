"""Simulated-TEE attestation plane: the attested sender log.

"Efficient BFT using TEE" (arxiv 2102.01970) and "Proof of Trusted
Execution" (arxiv 2512.09409) reduce asynchronous BFT's roster
requirement from n >= 3f+1 to n >= 2f+1 by removing ONE capability
from the adversary: equivocation.  A trusted component that binds a
strictly monotonic counter + a sealed MAC to every outbound message
makes "say A to half the roster, B to the other half" produce
cryptographic evidence instead of a fork, and with equivocation gone,
any two (n-f)-quorums of an n >= 2f+1 roster intersect in at least
one NON-EQUIVOCATING node — which is all the quorum-intersection
arguments in RBC/BBA ever needed from the 2f+1-of-3f+1 arithmetic.

This module is that trusted component, SIMULATED:

- ``AttestationVault`` — one per node, the "TEE".  It keeps the
  monotonic (incarnation, sequence) counter pair and a registry of
  protocol SLOTS it has already attested: (epoch, instance, message
  type) -> digest.  Asked to attest a payload whose slot it has seen
  with a DIFFERENT digest, it REFUSES — the stamp it issues carries a
  ``refused`` flag it cannot be talked out of.  An equivocating
  sender therefore ships self-incriminating frames: honest receivers
  record the counter-fork evidence and reject exactly those frames,
  so at most one variant per slot is ever accepted network-wide and
  equivocation degrades to omission OF THE FORKED STATEMENTS ONLY.
  The sender's non-equivocated traffic (refused=0) keeps flowing on
  purpose: at n = 2f+1 the quorum arithmetic needs every vote the
  adversary did not actually lie about, and dropping a caught
  equivocator's honest frames wholesale starves the very receivers
  that detected it of quorum (observed as a liveness stall in the
  reduced-quorum fuzz band).  Roster-level eviction from the
  accumulated evidence is a reconfig-plane decision, not an ingress
  filter.
- ``AttestationDirectory`` — the cluster-held "TEE NVRAM": vault
  state (counters + slot registry) survives process restarts, so a
  crash-restart cannot launder a second dealing of an already
  attested slot under a fresh counter; restarts bump the incarnation
  instead.  It also aggregates the fork evidence receivers report —
  the surface the fuzzer's reduced-quorum invariants inspect.
- ``AttestingAuthenticator`` — the egress/ingress seam.  It extends
  the pairwise-MAC ``HmacAuthenticator``: every frame leaving
  ``sign``/``sign_wire_many``/``sign_wire_wave`` gains an attestation
  trailer (incarnation, seq, refused, MAC over the frame's signing
  prefix under a key derived from — and rotating with — the pair MAC
  key), one vault pass per egress flush on the columnar wave path;
  every frame entering ``verify_wire``/``verify_wire_many`` must
  carry a valid trailer, with counter regressions (old incarnations,
  replayed or below-window sequence numbers) and refused stamps
  rejected loudly.

What the simulation does and does not model (docs/FAULTS.md "Trust
models"): the seal is STRUCTURAL, not physical.  The semantic-
adversary seam (``protocol.byzantine.Behavior``) rewrites payloads
between the protocol plane and the coalescer — BELOW it, the vault
sees every variant at sign time and the behavior API simply has no
handle on the authenticator, which is exactly the interposition a
hardware TEE enforces.  A fully compromised process that bypasses
its own authenticator is out of model here, as a compromised TEE is
out of model in the papers.
"""

from __future__ import annotations

import hashlib
import hmac
import struct
from typing import Callable, Dict, List, Optional, Set, Tuple

from cleisthenes_tpu_torch.transport.base import (
    HmacAuthenticator,
    _hmac_sha256_fn,
)
from cleisthenes_tpu_torch.transport.message import (
    ATTEST_TAG,
    BbaBatchPayload,
    BbaPayload,
    BbaType,
    BundlePayload,
    EchoBatchPayload,
    Message,
    RbcPayload,
    RbcType,
    ReadyBatchPayload,
    attach_signature,
    signing_bytes,
    signing_bytes_shared,
)

# attestation trailer body: ">IQB" header (incarnation u32, seq u64,
# refused u8) + 32-byte HMAC-SHA256
_ATT_HEADER = struct.Struct(">IQB")
ATTEST_LEN = _ATT_HEADER.size + 32

# Bounded per-link seen-sequence window: within it, out-of-order
# delivery (the fuzzer's reorder/delay/WAN faults are honest-path
# behavior) is accepted and exact duplicates (replay) are rejected;
# below it, everything is rejected as a counter regression.
SEQ_WINDOW = 4096

# domain tag separating attestation MACs from envelope MACs
_ATT_DOMAIN = b"att|"


def attest_key(pair_mac_key: bytes) -> bytes:
    """The sealed attestation key for one (sender, receiver) pair,
    derived from — never equal to — the pair's envelope MAC key.
    Deriving keeps the attestation plane on the existing key schedule
    (reconfig MAC rotation rotates attestation keys for free) while
    the domain tag keeps a valid envelope MAC useless as an
    attestation MAC and vice versa."""
    return hashlib.sha256(b"attest|" + pair_mac_key).digest()


# -- slot extraction --------------------------------------------------------
#
# A SLOT names one protocol statement a correct node makes at most
# once; the digest is the statement's content.  Equivocation == two
# digests for one slot.  Slot choice is deliberately conservative:
#
# - RBC VAL/ECHO/READY bind the Merkle ROOT per (epoch, proposer,
#   type): the per-receiver branch/shard legitimately differ across
#   receivers of one honest broadcast, the root never does.  The type
#   lives IN the slot because a node's READY may legally amplify a
#   quorum root different from the VAL/ECHO root it relayed.
# - BBA AUX/TERM bind the vote value per (epoch, proposer, round,
#   type).  BVAL is deliberately NOT slotted: broadcasting BVAL(0)
#   and BVAL(1) in one round is honest Bracha behavior (both values
#   enter bin_values), so there is no single-statement slot to bind.
# - Coin and decryption shares carry Chaum-Pedersen validity proofs;
#   a forged share is rejected by the proof, and the share value per
#   (instance, index) is deterministic — nothing to equivocate.
# - Catchup/reshare/ingress bodies are either quorum-validated
#   (f+1 byte-identical copies) or anchored by the committed log, so
#   the attested log adds nothing there.


def payload_slots(
    payload, out: List[Tuple[tuple, bytes]]
) -> None:
    """Append the (slot, digest) statements ``payload`` makes."""
    t = type(payload)
    if t is RbcPayload:
        out.append(
            (
                ("rbc", payload.epoch, payload.proposer, int(payload.type)),
                payload.root_hash,
            )
        )
    elif t is BbaPayload:
        if payload.type is not BbaType.BVAL:
            out.append(
                (
                    (
                        "bba",
                        payload.epoch,
                        payload.proposer,
                        payload.round,
                        int(payload.type),
                    ),
                    b"\x01" if payload.value else b"\x00",
                )
            )
    elif t is ReadyBatchPayload:
        for proposer, root in zip(payload.proposers, payload.roots):
            out.append(
                (
                    ("rbc", payload.epoch, proposer, int(RbcType.READY)),
                    root,
                )
            )
    elif t is EchoBatchPayload:
        for proposer, root in zip(payload.proposers, payload.roots):
            out.append(
                (
                    ("rbc", payload.epoch, proposer, int(RbcType.ECHO)),
                    root,
                )
            )
    elif t is BbaBatchPayload:
        if payload.type is not BbaType.BVAL:
            digest = b"\x01" if payload.value else b"\x00"
            for proposer in payload.proposers:
                out.append(
                    (
                        (
                            "bba",
                            payload.epoch,
                            proposer,
                            payload.round,
                            int(payload.type),
                        ),
                        digest,
                    )
                )
    elif t is BundlePayload:
        for item in payload.items:
            payload_slots(item, out)
    # every other payload kind: no attested slots (see block comment)


class _VaultState:
    """One node's persistent TEE state (lives in the directory)."""

    __slots__ = ("incarnation", "seq", "slots", "refusals")

    def __init__(self) -> None:
        self.incarnation = 0
        self.seq = 0
        self.slots: Dict[tuple, bytes] = {}
        self.refusals = 0


class AttestationDirectory:
    """The simulated TEE NVRAM + evidence aggregator (cluster-held).

    ``attach(node_id)`` hands out the node's vault state, bumping the
    incarnation — a restarted process resumes the same slot registry
    under a fresh incarnation, so replays of its pre-crash frames are
    recognizably old and re-attesting a forked slot stays refused.
    ``fork_reports`` maps accused sender -> [(reporter, incarnation,
    seq)] — the counter-fork evidence honest receivers recorded."""

    def __init__(self) -> None:
        self._states: Dict[str, _VaultState] = {}
        self.fork_reports: Dict[str, List[Tuple[str, int, int]]] = {}

    def attach(self, node_id: str) -> "AttestationVault":
        st = self._states.get(node_id)
        if st is None:
            st = _VaultState()
            self._states[node_id] = st
        st.incarnation += 1
        return AttestationVault(node_id, st, self)

    def report_fork(
        self, accused: str, reporter: str, incarnation: int, seq: int
    ) -> None:
        self.fork_reports.setdefault(accused, []).append(
            (reporter, incarnation, seq)
        )

    @property
    def accused(self) -> Set[str]:
        """Senders any honest receiver holds fork evidence against."""
        return set(self.fork_reports)


class AttestationVault:
    """The per-node simulated TEE: monotonic counters + the attested
    slot registry.  ``observe`` registers a payload's statements and
    returns whether ANY of them forks an already attested slot (the
    first digest per slot wins and is never overwritten); ``stamp``
    issues the next (incarnation, seq) pair.  The vault never blocks
    a send — it marks it.  Refusing to emit at all would turn the
    attestation plane into a crash fault injector; emitting with
    ``refused=1`` makes the equivocation attempt self-evident to every
    receiver, which is the detectable-and-excludable contract."""

    __slots__ = ("node_id", "_st", "_dir")

    def __init__(
        self, node_id: str, state: _VaultState, directory: AttestationDirectory
    ) -> None:
        self.node_id = node_id
        self._st = state
        self._dir = directory

    @property
    def incarnation(self) -> int:
        return self._st.incarnation

    @property
    def refusals(self) -> int:
        return self._st.refusals

    def observe(self, payload) -> bool:
        """Register ``payload``'s slots; True iff attestation is
        REFUSED (some slot already holds a different digest)."""
        slots: List[Tuple[tuple, bytes]] = []
        payload_slots(payload, slots)
        st = self._st
        refused = False
        for slot, digest in slots:
            prev = st.slots.get(slot)
            if prev is None:
                st.slots[slot] = digest
            elif prev != digest:
                refused = True
        if refused:
            st.refusals += 1
        return refused

    def stamp(self, refused: bool) -> bytes:
        """Issue the next attestation header (the MAC is appended by
        the authenticator, which holds the per-pair sealed keys)."""
        st = self._st
        st.seq += 1
        return _ATT_HEADER.pack(st.incarnation, st.seq, 1 if refused else 0)

    def report_fork(self, accused: str, incarnation: int, seq: int) -> None:
        self._dir.report_fork(accused, self.node_id, incarnation, seq)


class _LinkState:
    """Per-(sender -> this receiver) counter state: highest sequence
    seen, a bounded recent-sequence set (replay rejection that still
    admits honest reordering), and the gap tally."""

    __slots__ = ("incarnation", "max_seq", "seen")

    def __init__(self) -> None:
        self.incarnation = 0
        self.max_seq = 0
        self.seen: Set[int] = set()


class AttestingAuthenticator(HmacAuthenticator):
    """HmacAuthenticator + the attested sender log (Config.attested_log).

    Outbound: every frame gains the tagged attestation trailer —
    ``header(incarnation, seq, refused) || HMAC(attest_key(pair_key),
    "att|" || header || sha256(signing_prefix))`` — one vault pass per
    payload per egress flush on the columnar ``sign_wire_wave`` path.
    Inbound: frames without a valid trailer are rejected exactly like
    bad envelope MACs; a ``refused`` stamp is counter-fork evidence —
    the receiver reports it to the directory, accuses the sender, and
    rejects THAT frame (the sender's refused=0 traffic still verifies:
    per-statement omission preserves quorum liveness at n = 2f+1, and
    eviction from evidence is the reconfig plane's call, not the
    ingress filter's).  Counter policy per link: old
    incarnations rejected, duplicate sequences rejected (anti-replay),
    sequences older than ``SEQ_WINDOW`` below the high-water mark
    rejected, out-of-order arrivals inside the window accepted (the
    transports legitimately reorder), gaps tallied loudly in
    ``attest_stats``."""

    def __init__(
        self,
        self_id: str,
        peer_keys: "Dict[str, bytes]",
        vault: AttestationVault,
    ):
        super().__init__(self_id, peer_keys)
        if vault.node_id != self_id:
            raise ValueError(
                f"vault of {vault.node_id!r} cannot attest for {self_id!r}"
            )
        self.vault = vault
        self._links: Dict[str, _LinkState] = {}
        self._accused: Set[str] = set()
        # attestation-MAC schedules, cached per pair KEY BYTES so the
        # rotation machinery (primary/alt swaps in the base class)
        # needs no mirroring here
        self._att_fns: Dict[bytes, Callable[[bytes], bytes]] = {}
        # loud-rejection tallies (surfaced by transports' debug dumps
        # and the fuzzer's invariant checks)
        self.attest_stats = {
            "missing": 0,       # frame without a trailer
            "bad_mac": 0,       # trailer MAC failed both pair keys
            "regressions": 0,   # old incarnation / replay / below window
            "gaps": 0,          # sequence holes (dropped frames upstream)
            "forks": 0,         # refused stamps seen (fork evidence);
                                # every one is rejected, never delivered
        }

    # -- key plumbing ------------------------------------------------

    def _att_fn(self, pair_key: bytes) -> Callable[[bytes], bytes]:
        fn = self._att_fns.get(pair_key)
        if fn is None:
            if len(self._att_fns) > 4 * (len(self._peer_keys) + 1):
                self._att_fns.clear()  # bound: rotations retire keys
            fn = _hmac_sha256_fn(attest_key(pair_key))
            self._att_fns[pair_key] = fn
        return fn

    # -- egress ------------------------------------------------------

    def _attestation_for(
        self, header: bytes, prefix_digest: bytes, pair_key: bytes
    ) -> bytes:
        mac = self._att_fn(pair_key)(_ATT_DOMAIN + header + prefix_digest)
        return header + mac

    def sign(self, msg: Message, receiver_id: Optional[str] = None) -> Message:
        signed = super().sign(msg, receiver_id)
        refused = self.vault.observe(msg.payload)
        header = self.vault.stamp(refused)
        digest = hashlib.sha256(signing_bytes(msg)).digest()
        return Message(
            sender_id=signed.sender_id,
            timestamp=signed.timestamp,
            payload=signed.payload,
            signature=signed.signature,
            attestation=self._attestation_for(
                header, digest, self._peer_keys[receiver_id]
            ),
        )

    def sign_wire_many(self, msg: Message, receiver_ids) -> "Dict[str, bytes]":
        frames = super().sign_wire_many(  # staticcheck: allow[DET006] scalar arm
            msg, receiver_ids
        )
        refused = self.vault.observe(msg.payload)
        digest = hashlib.sha256(signing_bytes(msg)).digest()
        out: Dict[str, bytes] = {}
        for rid, frame in frames.items():
            att = self._attestation_for(
                self.vault.stamp(refused), digest, self._peer_keys[rid]
            )
            out[rid] = frame + struct.pack(">BI", ATTEST_TAG, len(att)) + att
        return out

    def sign_wire_wave(self, items, memo=None) -> "List[Dict[str, bytes]]":
        """One attestation pass per egress flush: the wave's envelope
        bodies encode once through the shared memo (unchanged), the
        vault observes each item's payload once, and every receiver
        frame gets its own (seq, MAC) stamp."""
        vault = self.vault
        self_id = self._self_id
        macs = self._macs
        keys = self._peer_keys
        out: "List[Dict[str, bytes]]" = []
        for msg, rids in items:
            if msg.sender_id != self_id:
                raise ValueError(
                    f"cannot sign as {msg.sender_id!r}: this "
                    f"authenticator holds the keys of {self_id!r}"
                )
            sb = (
                signing_bytes_shared(msg, memo)
                if memo is not None
                else signing_bytes(msg)
            )
            digest = hashlib.sha256(sb).digest()
            refused = vault.observe(msg.payload)
            frames: Dict[str, bytes] = {}
            for rid in rids:
                mac_fn = macs.get(rid)
                if mac_fn is None:
                    raise ValueError(f"no pair key with {rid!r}")
                att = self._attestation_for(
                    vault.stamp(refused), digest, keys[rid]
                )
                frames[rid] = attach_signature(sb, mac_fn(sb), att)
            out.append(frames)
        return out

    # -- ingress -----------------------------------------------------

    def _check_attestation(self, msg: Message, prefix_digest: bytes) -> bool:
        sender = msg.sender_id
        stats = self.attest_stats
        att = msg.attestation
        if len(att) != ATTEST_LEN:
            stats["missing"] += 1
            return False
        header, mac = att[: _ATT_HEADER.size], att[_ATT_HEADER.size :]
        body = _ATT_DOMAIN + header + prefix_digest
        key = self._peer_keys.get(sender)
        ok = key is not None and hmac.compare_digest(
            self._att_fn(key)(body), mac
        )
        if not ok:
            alt = self._alt_keys.get(sender)
            ok = alt is not None and hmac.compare_digest(
                self._att_fn(alt)(body), mac
            )
        if not ok:
            stats["bad_mac"] += 1
            return False
        incarnation, seq, refused = _ATT_HEADER.unpack(header)
        if refused:
            # counter-fork evidence: the sender's own vault refused to
            # attest this statement.  Record the accusation and reject
            # the lied statement — and ONLY it.  Dropping the sender's
            # refused=0 traffic too would starve the detecting
            # receivers of quorum at n = 2f+1 (the equivocator's
            # honest votes — its READY relays, coin shares — are load-
            # bearing there), turning detection into a self-inflicted
            # liveness failure.
            stats["forks"] += 1
            self._accused.add(sender)
            self.vault.report_fork(sender, incarnation, seq)
            return False
        link = self._links.get(sender)
        if link is None:
            link = self._links[sender] = _LinkState()
        if incarnation < link.incarnation:
            stats["regressions"] += 1  # pre-restart replay
            return False
        if incarnation > link.incarnation:
            link.incarnation = incarnation
            link.max_seq = 0
            link.seen.clear()
        if seq in link.seen or seq + SEQ_WINDOW <= link.max_seq:
            stats["regressions"] += 1  # replay or below-window
            return False
        link.seen.add(seq)
        if seq > link.max_seq:
            if link.max_seq and seq > link.max_seq + 1:
                stats["gaps"] += seq - link.max_seq - 1
            link.max_seq = seq
            if len(link.seen) > SEQ_WINDOW:
                floor = link.max_seq - SEQ_WINDOW
                link.seen = {s for s in link.seen if s > floor}
        return True

    def accused_senders(self) -> Set[str]:
        """Senders this node holds counter-fork evidence against.
        Evidence, not a frame filter: their refused=0 traffic still
        verifies (test/fuzz inspection surface; roster eviction from
        this evidence belongs to the reconfig plane)."""
        return set(self._accused)

    def verify(self, msg: Message) -> bool:
        if not super().verify(msg):
            return False
        return self._check_attestation(
            msg, hashlib.sha256(signing_bytes(msg)).digest()
        )

    def verify_wire(self, msg: Message, signing_prefix: bytes) -> bool:
        if not super().verify_wire(msg, signing_prefix):
            return False
        return self._check_attestation(
            msg, hashlib.sha256(signing_prefix).digest()
        )

    def verify_wire_many(self, msgs, signing_prefixes) -> "List[bool]":
        base = super().verify_wire_many(msgs, signing_prefixes)
        return [
            ok
            and self._check_attestation(
                msg, hashlib.sha256(prefix).digest()
            )
            for ok, msg, prefix in zip(base, msgs, signing_prefixes)
        ]


__all__ = [
    "ATTEST_LEN",
    "SEQ_WINDOW",
    "attest_key",
    "payload_slots",
    "AttestationDirectory",
    "AttestationVault",
    "AttestingAuthenticator",
]
