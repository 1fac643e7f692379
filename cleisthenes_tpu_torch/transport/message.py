"""Wire format: the message envelope and typed payloads.

Mirrors reference pb/message.proto: an envelope
``Message{signature, timestamp, oneof payload{RBC, BBA}}``
(message.proto:11-23) with ``RBC{payload bytes, type VAL|ECHO|READY}``
(message.proto:25-35) and ``BBA{payload bytes, type BVAL|AUX}``
(message.proto:37-46).  Inner request structs are marshalled into the
``payload`` field exactly as the reference notes ("marshaled data by
type", message.proto:27).

Payload kinds are added beyond the reference's proto — ``COIN``
(threshold common-coin shares, specified at docs/BBA-EN.md:163-181 but
never given a wire format), ``DEC`` (TPKE decryption shares,
docs/THRESHOLD_ENCRYPTION-EN.md:33-36), and the crash-recovery
``CATCHUP_REQ``/``CATCHUP_RESP`` pair (state transfer for rejoining
nodes) — because the reference never reached the point of needing
them on the wire.

The codec is a deliberate, self-contained binary framing (tag-length-
value with fixed-width ints) rather than generated protobuf: it keeps
the wire format dependency-free, deterministic byte-for-byte (needed
for envelope MACs and replay tests), and trivially portable to the C++
runtime.  The gRPC transport wraps these bytes in a single
``bytes``-typed stream method, preserving the reference's
one-bidi-stream-per-peer topology (message.proto:7-9).
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import struct
from typing import List, NamedTuple, Optional, Tuple, Union

from cleisthenes_tpu_torch.utils.memo import BoundedFifoMemo

_MAGIC = b"CLTP"  # cleisthenes-tpu wire magic
_VERSION = 1

# Hard cap on a decoded frame's declared sizes: a Byzantine peer must
# not be able to make us allocate unbounded memory from a length field.
MAX_FIELD_BYTES = 64 * 1024 * 1024


class RbcType(enum.IntEnum):
    """Reference pb/message.proto:29-34 (RBC.Type)."""

    VAL = 0
    ECHO = 1
    READY = 2


class BbaType(enum.IntEnum):
    """Reference pb/message.proto:39-43 (BBA.Type), extended with TERM.

    TERM is the Bracha-style termination gadget the reference's spec
    needs but never wires (docs/BBA-EN.md stops at the coin): a decided
    node broadcasts TERM(b) once; f+1 TERM(b) lets an undecided node
    adopt b; 2f+1 TERM(b) lets anyone halt the instance for good.
    """

    BVAL = 0
    AUX = 1
    TERM = 2


class RbcPayload(NamedTuple):
    """Reference pb/message.proto:25-35 + rbc/request.go:9-21.

    ``proposer``: which RBC instance (one per proposing validator,
    docs/HONEYBADGER-EN.md:85-89).  ``epoch``: HBBFT epoch.
    VAL/ECHO carry (root_hash, branch, shard, shard_index)
    (rbc/request.go:9-17); READY carries root_hash only
    (rbc/request.go:19-21).

    Payloads are NamedTuples, not dataclasses: a wave delivers
    O(N^2) of them per epoch and tuple construction is ~4x cheaper
    than a frozen dataclass's object.__setattr__ per field.
    """

    type: RbcType
    proposer: str
    epoch: int
    root_hash: bytes = b""
    branch: Tuple[bytes, ...] = ()
    shard: bytes = b""
    shard_index: int = 0


class BbaPayload(NamedTuple):
    """Reference pb/message.proto:37-46 + bba/request.go:6-13.

    ``proposer``: which BBA instance.  ``round``: the internal BBA
    round (bba/bba.go:45-46 keeps both epoch and round).  ``value``:
    the binary (bvalRequest.Value / auxRequest.Value).
    """

    type: BbaType
    proposer: str
    epoch: int
    round: int
    value: bool


class CoinPayload(NamedTuple):
    """Threshold common-coin share for one (instance, epoch, round)
    (docs/BBA-EN.md:163-181; no reference wire format exists).

    (index, d, e, z) is an ops.tpke.DhShare: share value plus its
    Chaum-Pedersen validity proof.
    """

    proposer: str
    epoch: int
    round: int
    index: int
    d: int
    e: int
    z: int


class DecSharePayload(NamedTuple):
    """TPKE decryption share for one proposer's ciphertext in one epoch
    (docs/THRESHOLD_ENCRYPTION-EN.md:35, docs/HONEYBADGER-EN.md:61-65).
    """

    proposer: str
    epoch: int
    index: int
    d: int
    e: int
    z: int


class CatchupReqPayload(NamedTuple):
    """CATCHUP request from a lagging/restarted node: "send me every
    committed batch from ``from_epoch`` on" (the state-transfer step
    HBBFT itself does not define; SURVEY.md §5.3-5.4 recovery story).
    Peers answer with a RUN of CatchupResp payloads — one per missed
    epoch they hold, up to a serving cap — so one round trip recovers
    a whole outage window instead of one epoch per round trip."""

    from_epoch: int


class CatchupRespPayload(NamedTuple):
    """One peer's committed batch for ``epoch`` (ledger body bytes,
    core.ledger.encode_batch_body).  A node adopts an epoch only after
    f+1 distinct senders return byte-identical bodies — at least one
    of them is honest, so the batch is the true committed one — and
    only in epoch order at its own commit frontier."""

    epoch: int
    body: bytes


class CatchupOrdPayload(NamedTuple):
    """One peer's ciphertext-ORDERED commit for ``epoch`` (COrd body
    bytes, core.ledger.encode_ordered_body) — the two-frontier twin of
    CatchupRespPayload (Config.order_then_settle).  A peer that has
    ordered but not yet settled an epoch cannot serve its plaintext,
    but CAN serve the agreed ciphertext ordering, so a lagging node
    advances its ordered frontier (and rejoins live epochs) without
    waiting for the roster's trailing decryption.  Adoption mirrors
    the CLOG rule: f+1 byte-identical bodies, in order, at the
    adopter's ORDERED frontier."""

    epoch: int
    body: bytes


class IngressStatus(enum.IntEnum):
    """Admission verdict carried in an IngressAckPayload.

    The backpressure contract (docs/ARCHITECTURE.md "Ingress plane"):
    a submit is never silently dropped — every frame gets exactly one
    ack, and the non-OK verdicts are distinguishable so a client knows
    whether to give up (REJECTED), wait (RETRY_AFTER, with a hint), or
    stop resending (DUPLICATE: the tx is already pending or settled).
    """

    OK = 0
    DUPLICATE = 1
    REJECTED = 2
    RETRY_AFTER = 3


class IngressSubmitPayload(NamedTuple):
    """One client transaction submission (the ingress plane's front
    door, transport/ingress.py).  ``client_id`` names the submitting
    client for per-client backpressure accounting; ``nonce`` is the
    client's own sequence number, echoed in the ack so a pipelining
    client can match acks to submits; ``fee`` is the priority bid the
    mempool orders and evicts by (core/mempool.py)."""

    client_id: str
    nonce: int
    fee: int
    tx: bytes


class IngressAckPayload(NamedTuple):
    """The admitting node's answer to one IngressSubmitPayload:
    verdict plus the node's two commit frontiers at admission time
    (ordered_epoch / settled_epoch — the two-frontier split), so
    a client can bound when its tx can first appear in a batch.
    ``retry_after_ms`` is nonzero only with status RETRY_AFTER."""

    client_id: str
    nonce: int
    status: int
    ordered_epoch: int
    settled_epoch: int
    retry_after_ms: int


class IngressSubscribePayload(NamedTuple):
    """Open a committed-batch subscription: "stream me every settled
    batch from ``from_epoch`` on".  Epochs already settled replay from
    the node's committed history (the same state the BatchLog restores
    at startup); later epochs arrive as a live tail at the settled
    frontier."""

    from_epoch: int


class IngressBatchPayload(NamedTuple):
    """One settled batch streamed to a subscriber (ledger body bytes,
    core.ledger.encode_batch_body — the same canonical body CATCHUP
    serves, so subscribers and rejoining validators read one format).
    """

    epoch: int
    body: bytes


class ResharePayload(NamedTuple):
    """One dealer's reshare dealing for a pending RECONFIG (dynamic
    membership, protocol.reconfig).

    ``body`` is the full serialized dealing (Feldman commitments for
    the new TPKE and coin keys plus the per-receiver encrypted share
    blobs) — the exact bytes the dealer also submits as its dealing
    transaction.  The broadcast is the EAGER in-band distribution
    path: live nodes stage and pre-verify dealings while the old
    roster keeps committing, and a joiner receiving one learns a
    ceremony is underway and (re)starts its CATCHUP bootstrap.  The
    authoritative copy — the one qualified-set selection is judged on
    — is the committed dealing transaction, so a lost broadcast costs
    latency, never agreement."""

    version: int
    dealer: str
    body: bytes


class BundlePayload(NamedTuple):
    """Several protocol payloads in ONE authenticated envelope.

    HBBFT's per-epoch traffic is O(N^2) broadcast waves where a node
    emits one small payload per concurrent instance (N ECHOs, N BBA
    votes, N dec-shares...) to the same receiver within one handler
    turn.  Bundling them amortizes the envelope + MAC + frame decode
    to one per (sender, receiver, wave) instead of one per payload —
    the message-coalescing lever the reference never needed at its
    unimplemented scale (its cost model: docs/HONEYBADGER-EN.md:93-96).
    Nesting is rejected at both encode and decode.
    """

    items: Tuple["Payload", ...]


class LanePayload(NamedTuple):
    """One protocol payload addressed to a consensus lane.

    Horizontal shard-out runs S independent HBBFT lane instances over
    one roster; lanes > 0 wrap every outbound payload in this frame so
    lane traffic rides the SAME coalesced bundles, delivery waves and
    MAC passes as lane 0 — the receiver demuxes by ``lane`` before the
    epoch demux.  Lane 0 never wraps (S=1 wire streams stay
    byte-identical to the pre-lane build).  A LanePayload may appear
    inside a bundle; a bundle or another LanePayload may NOT appear
    inside a LanePayload (the lane axis is outermost-but-one, framing
    stays non-recursive).
    """

    lane: int
    inner: "Payload"


# -- columnar wave payloads -------------------------------------------------
#
# Within one wave a node emits the SAME logical vote across many
# concurrent instances: N BVALs that differ only in proposer, N coin
# shares differing in (proposer, d, e, z), N dec shares, N READYs.
# The coalescer merges such runs into ONE columnar payload per
# (receiver, key): the shared fields encode once and the per-instance
# fields are packed columns, so both the wire size and the per-item
# decode/dispatch cost drop by ~the instance count.  Receivers unpack
# straight into the instance handlers' scalar entry points.


class BbaBatchPayload(NamedTuple):
    """One BVAL/AUX/TERM vote replicated across many instances:
    (type, epoch, round, value) shared, proposers columnar."""

    type: BbaType
    epoch: int
    round: int
    value: bool
    proposers: Tuple[str, ...]


class CoinBatchPayload(NamedTuple):
    """One sender's coin shares for many instances of (epoch, round):
    share index shared, (proposer, d, e, z) columnar."""

    epoch: int
    round: int
    index: int
    proposers: Tuple[str, ...]
    d: Tuple[int, ...]
    e: Tuple[int, ...]
    z: Tuple[int, ...]


class DecShareBatchPayload(NamedTuple):
    """One sender's TPKE decryption shares for many proposers of one
    epoch: share index shared, (proposer, d, e, z) columnar."""

    epoch: int
    index: int
    proposers: Tuple[str, ...]
    d: Tuple[int, ...]
    e: Tuple[int, ...]
    z: Tuple[int, ...]


class ReadyBatchPayload(NamedTuple):
    """One sender's RBC READYs for many instances of one epoch:
    (proposer, root) columnar."""

    epoch: int
    proposers: Tuple[str, ...]
    roots: Tuple[bytes, ...]


class EchoBatchPayload(NamedTuple):
    """One sender's RBC ECHOes for many instances of one epoch: the
    sender's shard slot (``shard_index``) is shared — a node echoes
    the VAL it received, which always carries its own tree position
    (docs/RBC-EN.md:34) — while (proposer, root, branch, shard) are
    columnar.  The last of the O(N^2)-per-epoch payload classes to go
    columnar: at N=64 the scalar ECHO chain was ~262k handler calls
    per epoch (profiled)."""

    epoch: int
    shard_index: int
    proposers: Tuple[str, ...]
    roots: Tuple[bytes, ...]
    branches: Tuple[Tuple[bytes, ...], ...]
    shards: Tuple[bytes, ...]


Payload = Union[
    RbcPayload,
    BbaPayload,
    CoinPayload,
    DecSharePayload,
    CatchupReqPayload,
    CatchupRespPayload,
    CatchupOrdPayload,
    ResharePayload,
    BundlePayload,
    BbaBatchPayload,
    CoinBatchPayload,
    DecShareBatchPayload,
    ReadyBatchPayload,
    EchoBatchPayload,
    IngressSubmitPayload,
    IngressAckPayload,
    IngressSubscribePayload,
    IngressBatchPayload,
    LanePayload,
]

# oneof discriminants (reference message.proto:18-22 has rbc=3, bba=4;
# we keep those two numbers and extend).  This block is the WIRE
# REGISTRY the whole-program analyzer indexes (staticcheck WIRE001):
# every kind must carry a unique number, an encode and a parse branch
# below, and either a pb-adapter slot (transport/pb_adapter.py) or a
# pragma saying why the capability stays native-only.
_KIND_RBC = 3
_KIND_BBA = 4
_KIND_COIN = 5  # staticcheck: allow[WIRE001] native-only: the reference oneof has no coin slot
_KIND_DEC = 6  # staticcheck: allow[WIRE001] native-only: the reference oneof has no dec-share slot
_KIND_CATCHUP_REQ = 7
_KIND_CATCHUP_RESP = 8
_KIND_BUNDLE = 9  # staticcheck: allow[WIRE001] native-only coalescing envelope (no pb slot)
_KIND_BBA_BATCH = 10  # staticcheck: allow[WIRE001] native-only columnar kind (wave coalescing)
_KIND_COIN_BATCH = 11  # staticcheck: allow[WIRE001] native-only columnar kind (wave coalescing)
_KIND_DEC_BATCH = 12  # staticcheck: allow[WIRE001] native-only columnar kind (wave coalescing)
_KIND_READY_BATCH = 13  # staticcheck: allow[WIRE001] native-only columnar kind (wave coalescing)
_KIND_ECHO_BATCH = 14  # staticcheck: allow[WIRE001] native-only columnar kind (wave coalescing)
_KIND_CATCHUP_ORD = 15
_KIND_RESHARE = 16
# client ingress plane (transport/ingress.py): submit/subscribe frames
# exchanged with UNTRUSTED clients.  They ride the same TLV codec (and
# pb extension slots, for stock-decoder interop) but a different frame
# magic (_INGRESS_MAGIC) with no envelope MAC: clients hold no roster
# keys, and admission control — not authentication — is the guard.
# Ingress frames therefore never enter the validator-to-validator
# dispatch path (VERIFY001's decode->verify->serve discipline).
_KIND_INGRESS_SUBMIT = 17
_KIND_INGRESS_ACK = 18
_KIND_INGRESS_SUB = 19
_KIND_INGRESS_BATCH = 20
_KIND_LANE = 21  # staticcheck: allow[WIRE001] native-only lane shard-out framing (no pb slot)

# DoS bound on per-instance columns (a roster is <= 256 under the
# GF(2^8) shard cap; 4096 leaves margin for multi-round merges)
MAX_BATCH_ITEMS = 4096

# DoS bound on sub-payloads per bundle (each item is >= 2 bytes on the
# wire, and the frame itself is capped by MAX_FIELD_BYTES)
MAX_BUNDLE_ITEMS = 1 << 20


@dataclasses.dataclass(frozen=True)
class Message:
    """The envelope (reference pb/message.proto:11-23).

    ``signature`` authenticates (sender_id, timestamp, payload) — the
    field the reference declares (message.proto:14) but never checks
    (conn.go:134-137 TODO); here it is a real MAC, see
    transport.base.Authenticator.  ``sender_id`` is carried explicitly
    because unlike the reference we authenticate it (the reference
    trusts the connection's uuid, comm.go:46).
    """

    sender_id: str
    timestamp: float
    payload: Payload
    signature: bytes = b""
    # Simulated-TEE attestation trailer (Config.attested_log,
    # protocol/attest.py): an opaque blob appended AFTER the signature
    # — (incarnation, sender counter, refused flag, attestation MAC)
    # issued by the sender's AttestationVault.  Empty on the baseline
    # arm, where the frame bytes are identical to the pre-attestation
    # wire format.  Not covered by the envelope MAC (it carries its
    # own MAC binding the signing prefix), so the codec treats it as
    # an optional TLV trailer.
    attestation: bytes = b""


# ---------------------------------------------------------------------------
# binary codec
# ---------------------------------------------------------------------------


def _pack_bytes(out: List[bytes], b: bytes) -> None:
    out.append(struct.pack(">I", len(b)))
    out.append(b)


def _pack_str(out: List[bytes], s: str) -> None:
    _pack_bytes(out, s.encode("utf-8"))


def _pack_int(out: List[bytes], x: int) -> None:
    """Arbitrary-precision non-negative int (group elements are 256-bit)."""
    if x < 0:
        raise ValueError("negative int on wire")
    b = x.to_bytes((x.bit_length() + 7) // 8 or 1, "big")
    _pack_bytes(out, b)


class _Reader:
    def __init__(self, data: bytes):
        self._d = data
        self._o = 0

    def bytes_(self) -> bytes:
        if self._o + 4 > len(self._d):
            raise ValueError("truncated frame")
        (n,) = struct.unpack_from(">I", self._d, self._o)
        if n > MAX_FIELD_BYTES:
            raise ValueError(f"field length {n} exceeds cap")
        self._o += 4
        if self._o + n > len(self._d):
            raise ValueError("truncated frame")
        out = self._d[self._o : self._o + n]
        self._o += n
        return out

    def str_(self) -> str:
        return self.bytes_().decode("utf-8")

    def int_(self) -> int:
        return int.from_bytes(self.bytes_(), "big")

    def u8(self) -> int:
        if self._o + 1 > len(self._d):
            raise ValueError("truncated frame")
        v = self._d[self._o]
        self._o += 1
        return v

    def u32(self) -> int:
        if self._o + 4 > len(self._d):
            raise ValueError("truncated frame")
        (v,) = struct.unpack_from(">I", self._d, self._o)
        self._o += 4
        return v

    def u64(self) -> int:
        if self._o + 8 > len(self._d):
            raise ValueError("truncated frame")
        (v,) = struct.unpack_from(">Q", self._d, self._o)
        self._o += 8
        return v

    def f64(self) -> float:
        if self._o + 8 > len(self._d):
            raise ValueError("truncated frame")
        (v,) = struct.unpack_from(">d", self._d, self._o)
        self._o += 8
        return v

    def done(self) -> bool:
        return self._o == len(self._d)


def _encode_payload(p: Payload) -> Tuple[int, bytes]:
    out: List[bytes] = []
    if isinstance(p, RbcPayload):
        out.append(struct.pack(">B", int(p.type)))
        _pack_str(out, p.proposer)
        out.append(struct.pack(">Q", p.epoch))
        _pack_bytes(out, p.root_hash)
        out.append(struct.pack(">I", len(p.branch)))
        for b in p.branch:
            _pack_bytes(out, b)
        _pack_bytes(out, p.shard)
        out.append(struct.pack(">I", p.shard_index))
        return _KIND_RBC, b"".join(out)
    if isinstance(p, BbaPayload):
        out.append(struct.pack(">B", int(p.type)))
        _pack_str(out, p.proposer)
        out.append(struct.pack(">QQB", p.epoch, p.round, int(p.value)))
        return _KIND_BBA, b"".join(out)
    if isinstance(p, CoinPayload):
        _pack_str(out, p.proposer)
        out.append(struct.pack(">QQI", p.epoch, p.round, p.index))
        _pack_int(out, p.d)
        _pack_int(out, p.e)
        _pack_int(out, p.z)
        return _KIND_COIN, b"".join(out)
    if isinstance(p, DecSharePayload):
        _pack_str(out, p.proposer)
        out.append(struct.pack(">QI", p.epoch, p.index))
        _pack_int(out, p.d)
        _pack_int(out, p.e)
        _pack_int(out, p.z)
        return _KIND_DEC, b"".join(out)
    if isinstance(p, CatchupReqPayload):
        out.append(struct.pack(">Q", p.from_epoch))
        return _KIND_CATCHUP_REQ, b"".join(out)
    if isinstance(p, CatchupRespPayload):
        out.append(struct.pack(">Q", p.epoch))
        _pack_bytes(out, p.body)
        return _KIND_CATCHUP_RESP, b"".join(out)
    if isinstance(p, CatchupOrdPayload):
        out.append(struct.pack(">Q", p.epoch))
        _pack_bytes(out, p.body)
        return _KIND_CATCHUP_ORD, b"".join(out)
    if isinstance(p, ResharePayload):
        out.append(struct.pack(">I", p.version))
        _pack_str(out, p.dealer)
        _pack_bytes(out, p.body)
        return _KIND_RESHARE, b"".join(out)
    if isinstance(p, IngressSubmitPayload):
        _pack_str(out, p.client_id)
        out.append(struct.pack(">QQ", p.nonce, p.fee))
        _pack_bytes(out, p.tx)
        return _KIND_INGRESS_SUBMIT, b"".join(out)
    if isinstance(p, IngressAckPayload):
        _pack_str(out, p.client_id)
        out.append(
            struct.pack(
                ">QBQQI",
                p.nonce,
                int(p.status),
                p.ordered_epoch,
                p.settled_epoch,
                p.retry_after_ms,
            )
        )
        return _KIND_INGRESS_ACK, b"".join(out)
    if isinstance(p, IngressSubscribePayload):
        out.append(struct.pack(">Q", p.from_epoch))
        return _KIND_INGRESS_SUB, b"".join(out)
    if isinstance(p, IngressBatchPayload):
        out.append(struct.pack(">Q", p.epoch))
        _pack_bytes(out, p.body)
        return _KIND_INGRESS_BATCH, b"".join(out)
    if isinstance(p, LanePayload):
        if not (0 <= p.lane <= 255):
            raise ValueError(f"lane {p.lane} out of wire range")
        kind, body = _encode_payload(p.inner)
        if kind in (_KIND_BUNDLE, _KIND_LANE):
            raise ValueError(
                "bundle/lane payloads are not allowed inside a lane frame"
            )
        out.append(struct.pack(">IB", p.lane, kind))
        _pack_bytes(out, body)
        return _KIND_LANE, b"".join(out)
    if isinstance(p, BundlePayload):
        if len(p.items) > MAX_BUNDLE_ITEMS:
            raise ValueError(f"bundle of {len(p.items)} items exceeds cap")
        out.append(struct.pack(">I", len(p.items)))
        for item in p.items:
            kind, body = _encode_payload(item)
            if kind == _KIND_BUNDLE:
                raise ValueError("nested bundles are not allowed")
            out.append(struct.pack(">B", kind))
            _pack_bytes(out, body)
        return _KIND_BUNDLE, b"".join(out)
    if isinstance(p, BbaBatchPayload):
        _check_batch_len(len(p.proposers))
        out.append(struct.pack(">BQQB", int(p.type), p.epoch, p.round,
                               int(p.value)))
        out.append(struct.pack(">I", len(p.proposers)))
        for s in p.proposers:
            _pack_str(out, s)
        return _KIND_BBA_BATCH, b"".join(out)
    if isinstance(p, CoinBatchPayload):
        _check_batch_len(len(p.proposers), len(p.d), len(p.e), len(p.z))
        out.append(struct.pack(">QQI", p.epoch, p.round, p.index))
        _pack_share_columns(out, p.proposers, p.d, p.e, p.z)
        return _KIND_COIN_BATCH, b"".join(out)
    if isinstance(p, DecShareBatchPayload):
        _check_batch_len(len(p.proposers), len(p.d), len(p.e), len(p.z))
        out.append(struct.pack(">QI", p.epoch, p.index))
        _pack_share_columns(out, p.proposers, p.d, p.e, p.z)
        return _KIND_DEC_BATCH, b"".join(out)
    if isinstance(p, ReadyBatchPayload):
        _check_batch_len(len(p.proposers), len(p.roots))
        out.append(struct.pack(">Q", p.epoch))
        out.append(struct.pack(">I", len(p.proposers)))
        for i, s in enumerate(p.proposers):
            _pack_str(out, s)
            _pack_bytes(out, p.roots[i])
        return _KIND_READY_BATCH, b"".join(out)
    if isinstance(p, EchoBatchPayload):
        _check_batch_len(
            len(p.proposers), len(p.roots), len(p.branches), len(p.shards)
        )
        out.append(struct.pack(">QI", p.epoch, p.shard_index))
        out.append(struct.pack(">I", len(p.proposers)))
        for i, s in enumerate(p.proposers):
            _pack_str(out, s)
            _pack_bytes(out, p.roots[i])
            br = p.branches[i]
            out.append(struct.pack(">I", len(br)))
            for b in br:
                _pack_bytes(out, b)
            _pack_bytes(out, p.shards[i])
        return _KIND_ECHO_BATCH, b"".join(out)
    raise TypeError(f"unknown payload type {type(p)!r}")


def _pack_share_columns(out, proposers, dcol, ecol, zcol) -> None:
    """(proposer, d, e, z) columns — shared by the coin and dec-share
    batch payloads so their framings cannot drift apart."""
    out.append(struct.pack(">I", len(proposers)))
    for i, s in enumerate(proposers):
        _pack_str(out, s)
        _pack_int(out, dcol[i])
        _pack_int(out, ecol[i])
        _pack_int(out, zcol[i])


def _check_batch_len(*lens: int) -> None:
    if not lens or min(lens) != max(lens):
        raise ValueError("columnar payload with ragged columns")
    if lens[0] == 0 or lens[0] > MAX_BATCH_ITEMS:
        raise ValueError(f"batch of {lens[0]} items out of range")


# Prebound structs: the payload decoder is the receive hot path (a
# wave delivers O(N^2) items per epoch), so field parsing is inlined
# offset arithmetic rather than _Reader method calls (~2.5x).
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_F64 = struct.Struct(">d")
_QQB = struct.Struct(">QQB")
_QQI = struct.Struct(">QQI")
_QI = struct.Struct(">QI")


def _parse_share_columns(d: bytes, o: int, end: int, count: int):
    """Inverse of _pack_share_columns; returns (proposers, d, e, z, o')."""
    proposers, dv, ev, zv = [], [], [], []
    for _ in range(count):
        s, o = _field(d, o, end)
        proposers.append(s.decode("utf-8"))
        x, o = _field(d, o, end)
        dv.append(int.from_bytes(x, "big"))
        x, o = _field(d, o, end)
        ev.append(int.from_bytes(x, "big"))
        x, o = _field(d, o, end)
        zv.append(int.from_bytes(x, "big"))
    return tuple(proposers), tuple(dv), tuple(ev), tuple(zv), o


def _check_batch_count(count: int) -> None:
    if count == 0 or count > MAX_BATCH_ITEMS:
        raise ValueError(f"batch count {count} out of range")


def _field(d: bytes, o: int, end: int):
    """One length-prefixed field within d[..end); returns (bytes, o')."""
    if o + 4 > end:
        raise ValueError("truncated frame")
    (n,) = _U32.unpack_from(d, o)
    if n > MAX_FIELD_BYTES:
        raise ValueError(f"field length {n} exceeds cap")
    o += 4
    if o + n > end:
        raise ValueError("truncated frame")
    return d[o : o + n], o + n


def _parse_payload(d: bytes, o: int, end: int, kind: int):
    """Parse one payload from d[o:end); returns (payload, offset after).
    The caller checks the offset against ``end`` where canonical
    (exactly-consumed) bodies are required."""
    if kind == _KIND_BBA:
        if o + 1 > end:
            raise ValueError("truncated frame")
        t = BbaType(d[o])
        proposer, o = _field(d, o + 1, end)
        if o + 17 > end:
            raise ValueError("truncated frame")
        epoch, rnd, val = _QQB.unpack_from(d, o)
        return (
            BbaPayload(t, proposer.decode("utf-8"), epoch, rnd, bool(val)),
            o + 17,
        )
    if kind == _KIND_COIN:
        proposer, o = _field(d, o, end)
        if o + 20 > end:
            raise ValueError("truncated frame")
        epoch, rnd, idx = _QQI.unpack_from(d, o)
        dv, o = _field(d, o + 20, end)
        ev, o = _field(d, o, end)
        zv, o = _field(d, o, end)
        return (
            CoinPayload(
                proposer.decode("utf-8"), epoch, rnd, idx,
                int.from_bytes(dv, "big"), int.from_bytes(ev, "big"),
                int.from_bytes(zv, "big"),
            ),
            o,
        )
    if kind == _KIND_DEC:
        proposer, o = _field(d, o, end)
        if o + 12 > end:
            raise ValueError("truncated frame")
        epoch, idx = _QI.unpack_from(d, o)
        dv, o = _field(d, o + 12, end)
        ev, o = _field(d, o, end)
        zv, o = _field(d, o, end)
        return (
            DecSharePayload(
                proposer.decode("utf-8"), epoch, idx,
                int.from_bytes(dv, "big"), int.from_bytes(ev, "big"),
                int.from_bytes(zv, "big"),
            ),
            o,
        )
    if kind == _KIND_RBC:
        if o + 1 > end:
            raise ValueError("truncated frame")
        t = RbcType(d[o])
        proposer, o = _field(d, o + 1, end)
        if o + 8 > end:
            raise ValueError("truncated frame")
        (epoch,) = _U64.unpack_from(d, o)
        root, o = _field(d, o + 8, end)
        if o + 4 > end:
            raise ValueError("truncated frame")
        (nbr,) = _U32.unpack_from(d, o)
        if nbr > 64:  # Merkle depth cap: 2^64 leaves is beyond any N
            raise ValueError(f"branch length {nbr} exceeds cap")
        o += 4
        branch = []
        for _ in range(nbr):
            b, o = _field(d, o, end)
            branch.append(b)
        shard, o = _field(d, o, end)
        if o + 4 > end:
            raise ValueError("truncated frame")
        (idx,) = _U32.unpack_from(d, o)
        return (
            RbcPayload(
                t, proposer.decode("utf-8"), epoch, root, tuple(branch),
                shard, idx,
            ),
            o + 4,
        )
    if kind == _KIND_BBA_BATCH:
        if o + 22 > end:
            raise ValueError("truncated frame")
        t = BbaType(d[o])
        epoch, rnd, val = _QQB.unpack_from(d, o + 1)
        (count,) = _U32.unpack_from(d, o + 18)
        _check_batch_count(count)
        o += 22
        proposers = []
        for _ in range(count):
            s, o = _field(d, o, end)
            proposers.append(s.decode("utf-8"))
        return (
            BbaBatchPayload(t, epoch, rnd, bool(val), tuple(proposers)),
            o,
        )
    if kind == _KIND_COIN_BATCH:
        if o + 24 > end:
            raise ValueError("truncated frame")
        epoch, rnd, idx = _QQI.unpack_from(d, o)
        (count,) = _U32.unpack_from(d, o + 20)
        _check_batch_count(count)
        proposers, dv, ev, zv, o = _parse_share_columns(d, o + 24, end, count)
        return (
            CoinBatchPayload(epoch, rnd, idx, proposers, dv, ev, zv),
            o,
        )
    if kind == _KIND_DEC_BATCH:
        if o + 16 > end:
            raise ValueError("truncated frame")
        epoch, idx = _QI.unpack_from(d, o)
        (count,) = _U32.unpack_from(d, o + 12)
        _check_batch_count(count)
        proposers, dv, ev, zv, o = _parse_share_columns(d, o + 16, end, count)
        return (
            DecShareBatchPayload(epoch, idx, proposers, dv, ev, zv),
            o,
        )
    if kind == _KIND_READY_BATCH:
        if o + 12 > end:
            raise ValueError("truncated frame")
        (epoch,) = _U64.unpack_from(d, o)
        (count,) = _U32.unpack_from(d, o + 8)
        _check_batch_count(count)
        o += 12
        proposers, roots = [], []
        for _ in range(count):
            s, o = _field(d, o, end)
            proposers.append(s.decode("utf-8"))
            r, o = _field(d, o, end)
            roots.append(r)
        return (
            ReadyBatchPayload(epoch, tuple(proposers), tuple(roots)),
            o,
        )
    if kind == _KIND_ECHO_BATCH:
        if o + 16 > end:
            raise ValueError("truncated frame")
        (epoch,) = _U64.unpack_from(d, o)
        (sidx,) = _U32.unpack_from(d, o + 8)
        (count,) = _U32.unpack_from(d, o + 12)
        _check_batch_count(count)
        o += 16
        proposers, roots, branches, shards = [], [], [], []
        for _ in range(count):
            s, o = _field(d, o, end)
            proposers.append(s.decode("utf-8"))
            r, o = _field(d, o, end)
            roots.append(r)
            if o + 4 > end:
                raise ValueError("truncated frame")
            (nbr,) = _U32.unpack_from(d, o)
            if nbr > 64:  # same Merkle depth cap as _KIND_RBC
                raise ValueError(f"branch length {nbr} exceeds cap")
            o += 4
            br = []
            for _ in range(nbr):
                b, o = _field(d, o, end)
                br.append(b)
            branches.append(tuple(br))
            sh, o = _field(d, o, end)
            shards.append(sh)
        return (
            EchoBatchPayload(
                epoch,
                sidx,
                tuple(proposers),
                tuple(roots),
                tuple(branches),
                tuple(shards),
            ),
            o,
        )
    if kind == _KIND_CATCHUP_REQ:
        if o + 8 > end:
            raise ValueError("truncated frame")
        (from_epoch,) = _U64.unpack_from(d, o)
        return CatchupReqPayload(from_epoch), o + 8
    if kind == _KIND_CATCHUP_RESP:
        if o + 8 > end:
            raise ValueError("truncated frame")
        (epoch,) = _U64.unpack_from(d, o)
        body, o = _field(d, o + 8, end)
        return CatchupRespPayload(epoch, body), o
    if kind == _KIND_CATCHUP_ORD:
        if o + 8 > end:
            raise ValueError("truncated frame")
        (epoch,) = _U64.unpack_from(d, o)
        body, o = _field(d, o + 8, end)
        return CatchupOrdPayload(epoch, body), o
    if kind == _KIND_RESHARE:
        if o + 4 > end:
            raise ValueError("truncated frame")
        (version,) = _U32.unpack_from(d, o)
        dealer, o = _field(d, o + 4, end)
        body, o = _field(d, o, end)
        return ResharePayload(version, dealer.decode("utf-8"), body), o
    if kind == _KIND_INGRESS_SUBMIT:
        client, o = _field(d, o, end)
        if o + 16 > end:
            raise ValueError("truncated frame")
        (nonce,) = _U64.unpack_from(d, o)
        (fee,) = _U64.unpack_from(d, o + 8)
        tx, o = _field(d, o + 16, end)
        return (
            IngressSubmitPayload(client.decode("utf-8"), nonce, fee, tx),
            o,
        )
    if kind == _KIND_INGRESS_ACK:
        client, o = _field(d, o, end)
        if o + 29 > end:
            raise ValueError("truncated frame")
        (nonce,) = _U64.unpack_from(d, o)
        status = IngressStatus(d[o + 8])
        (ordered,) = _U64.unpack_from(d, o + 9)
        (settled,) = _U64.unpack_from(d, o + 17)
        (retry_ms,) = _U32.unpack_from(d, o + 25)
        return (
            IngressAckPayload(
                client.decode("utf-8"), nonce, status, ordered, settled,
                retry_ms,
            ),
            o + 29,
        )
    if kind == _KIND_INGRESS_SUB:
        if o + 8 > end:
            raise ValueError("truncated frame")
        (from_epoch,) = _U64.unpack_from(d, o)
        return IngressSubscribePayload(from_epoch), o + 8
    if kind == _KIND_INGRESS_BATCH:
        if o + 8 > end:
            raise ValueError("truncated frame")
        (epoch,) = _U64.unpack_from(d, o)
        body, o = _field(d, o + 8, end)
        return IngressBatchPayload(epoch, body), o
    if kind == _KIND_LANE:
        if o + 9 > end:
            raise ValueError("truncated frame")
        (lane,) = _U32.unpack_from(d, o)
        if lane > 255:
            raise ValueError(f"lane {lane} out of wire range")
        k = d[o + 4]
        if k in (_KIND_BUNDLE, _KIND_LANE):
            raise ValueError(
                "bundle/lane payloads are not allowed inside a lane frame"
            )
        (ln,) = _U32.unpack_from(d, o + 5)
        if ln > MAX_FIELD_BYTES:
            raise ValueError(f"field length {ln} exceeds cap")
        o += 9
        item_end = o + ln
        if item_end > end:
            raise ValueError("truncated frame")
        inner, consumed = _parse_payload(d, o, item_end, k)
        if consumed != item_end:
            # canonical-or-reject: the MAC covers these bytes
            raise ValueError("trailing bytes in payload body")
        return LanePayload(lane, inner), item_end
    if kind == _KIND_BUNDLE:
        if o + 4 > end:
            raise ValueError("truncated frame")
        (count,) = _U32.unpack_from(d, o)
        if count > MAX_BUNDLE_ITEMS:
            raise ValueError(f"bundle count {count} exceeds cap")
        o += 4
        items = []
        append = items.append
        for _ in range(count):
            if o + 5 > end:
                raise ValueError("truncated frame")
            k = d[o]
            if k == _KIND_BUNDLE:
                raise ValueError("nested bundles are not allowed")
            (ln,) = _U32.unpack_from(d, o + 1)
            if ln > MAX_FIELD_BYTES:
                raise ValueError(f"field length {ln} exceeds cap")
            o += 5
            item_end = o + ln
            if item_end > end:
                raise ValueError("truncated frame")
            item, consumed = _parse_payload(d, o, item_end, k)
            if consumed != item_end:
                # canonical-or-reject: the MAC covers these bytes
                raise ValueError("trailing bytes in payload body")
            append(item)
            o = item_end
        return BundlePayload(tuple(items)), o
    raise ValueError(f"unknown payload kind {kind}")


def _decode_payload(kind: int, data: bytes) -> Payload:
    out, consumed = _parse_payload(data, 0, len(data), kind)
    if consumed != len(data):
        # reject non-canonical bodies: the MAC covers the re-encoded
        # canonical form, so trailing junk would make frames malleable
        raise ValueError("trailing bytes in payload body")
    return out


def signing_bytes(msg: Message) -> bytes:
    """The byte string the envelope MAC covers: everything except the
    signature itself (the reference's intended-but-absent semantics,
    message.proto:14, conn.go:134-137)."""
    kind, body = _encode_payload(msg.payload)
    return _assemble_signing(msg, kind, body)


def _assemble_signing(msg: Message, kind: int, body: bytes) -> bytes:
    out: List[bytes] = [_MAGIC, struct.pack(">BB", _VERSION, kind)]
    _pack_str(out, msg.sender_id)
    out.append(struct.pack(">d", msg.timestamp))
    _pack_bytes(out, body)
    return b"".join(out)


class FrameEncodeMemo(BoundedFifoMemo):
    """Shared outbound payload-encode memo (Config.egress_columnar) —
    the encode twin of ``FrameDecodeMemo``.

    One egress wave's per-receiver frames are mostly re-encodings of
    SHARED payload objects: a mixed flush folds the wave's broadcast
    run into each receiver's bundle, so N receiver bundles carry the
    same sub-payload objects and the scalar path re-encoded each of
    them once per receiver.  Keying the encoded ``(kind, body)`` on
    the payload OBJECT collapses those to one encode + N joins.

    The decode memo keys on the wire prefix's SHA-256 digest because
    the bytes already exist on arrival; on the send side the bytes are
    the memo's PRODUCT, so the pre-encode name of the content is the
    immutable payload object itself — entries pin the object (and hits
    re-check identity), so id reuse after GC can never alias, the same
    pin-the-inputs discipline as the hub's id-slot branch dedup.
    Eviction is the shared BoundedFifoMemo FIFO discipline (oldest
    insertion first, never clear-all).  ``hits``/``misses`` feed the
    transport egress metrics (``encode_memo_hit_rate`` in the bench
    sections); a miss is a payload body actually encoded — the
    ``frames_encoded`` counter's unit on both egress arms."""

    __slots__ = ("hits", "misses")

    def __init__(self, cap: int = 4096):
        super().__init__(cap)
        self.hits = 0
        self.misses = 0


def encode_payload_shared(
    p: Payload, memo: FrameEncodeMemo
) -> Tuple[int, bytes]:
    """(kind, body) for one NON-BUNDLE payload through the memo."""
    key = id(p)
    ent = memo.map.get(key)
    if ent is not None and ent[0] is p:
        memo.hits += 1
        return ent[1], ent[2]
    memo.misses += 1
    kind, body = _encode_payload(p)
    memo.put(key, (p, kind, body))
    return kind, body


def signing_bytes_shared(msg: Message, memo: FrameEncodeMemo) -> bytes:
    """``signing_bytes`` through the FrameEncodeMemo — byte-identical
    output (tests assert it), but a BundlePayload's sub-items and any
    repeated top-level payload encode once per distinct OBJECT across
    the wave instead of once per receiver frame."""
    p = msg.payload
    if isinstance(p, BundlePayload):
        if len(p.items) > MAX_BUNDLE_ITEMS:
            raise ValueError(f"bundle of {len(p.items)} items exceeds cap")
        out: List[bytes] = [struct.pack(">I", len(p.items))]
        for item in p.items:
            kind, body = encode_payload_shared(item, memo)
            if kind == _KIND_BUNDLE:
                raise ValueError("nested bundles are not allowed")
            out.append(struct.pack(">B", kind))
            _pack_bytes(out, body)
        return _assemble_signing(msg, _KIND_BUNDLE, b"".join(out))
    kind, body = encode_payload_shared(p, memo)
    return _assemble_signing(msg, kind, body)


def payload_body_count(p: Payload) -> int:
    """Payload bodies one envelope encode touches (bundle items, or
    1): the ``frames_encoded`` counter's unit on the SCALAR egress arm
    — the columnar arm counts FrameEncodeMemo misses, which probe per
    body, so both arms tally the same work unit."""
    return len(p.items) if isinstance(p, BundlePayload) else 1


# Tag byte opening the optional attestation trailer
# (``signing || len(sig) || sig || TAG || len(att) || att``).  A
# distinct tag keeps the trailer self-describing: a frame ending at
# the signature is the baseline arm, anything else must be exactly
# one tagged attestation blob (canonical-or-reject).
ATTEST_TAG = 0xA7


def attach_signature(
    signing: bytes, signature: bytes, attestation: bytes = b""
) -> bytes:
    """Complete a frame from its pre-computed signing bytes: the wire
    layout is ``signing_bytes || len(sig) || sig`` plus, when the
    attested-log arm is on, the tagged attestation trailer — so a
    broadcast can encode the envelope once and append a per-receiver
    MAC (and per-receiver attestation)."""
    frame = signing + struct.pack(">I", len(signature)) + signature
    if attestation:
        frame += (
            struct.pack(">BI", ATTEST_TAG, len(attestation)) + attestation
        )
    return frame


def encode_message(msg: Message) -> bytes:
    return attach_signature(
        signing_bytes(msg), msg.signature, msg.attestation
    )


class FrameDecodeMemo(BoundedFifoMemo):
    """Shared-prefix inbound decode memo (Config.delivery_columnar).

    A broadcast's N receiver frames are ``signing_bytes || len || MAC``
    (attach_signature) and differ ONLY in the 32-byte MAC — the
    signing prefix (sender, timestamp, payload body) is byte-identical
    across all N.  Keying the decoded (sender, ts, kind, payload)
    tuple on the SHA-256 digest of that prefix collapses N identical
    decodes to 1 decode + N cheap MAC checks, and shares the envelope
    fields too (the old (kind, body)-keyed payload memo still decoded
    sender/timestamp and copied the body bytes per frame).

    Two frames with equal digests but different prefix bytes would be
    a SHA-256 collision (a second preimage against honest traffic), so
    aliasing is cryptographically excluded — see docs/ARCHITECTURE.md
    "Delivery plane".

    Eviction is the shared BoundedFifoMemo discipline (oldest
    insertion first, utils.memo — the hub memo hoisted), NEVER
    clear-all: a hot wave sitting at the cap loses one stale entry
    per fresh one instead of periodically re-decoding its whole
    working set.  ``hits``/``misses`` feed the transport metrics
    (decode_memo_hit_rate in the bench sections).
    """

    __slots__ = ("hits", "misses")

    def __init__(self, cap: int = 4096):
        super().__init__(cap)
        self.hits = 0
        self.misses = 0


def decode_frame_shared(
    data: bytes, memo: FrameDecodeMemo
) -> Tuple[Message, "memoryview"]:
    """Decode a frame through the shared-prefix memo (the columnar
    delivery arm of ``decode_frame``).

    The envelope is walked as OFFSETS over ``data`` — no body slice,
    no signing-prefix copy — and the returned signing prefix is a
    zero-copy ``memoryview`` (hashlib/hmac consume buffers directly).
    On a memo hit the entire payload decode is skipped and the shared
    immutable payload object is reused; per-frame work is then one
    digest + one dict probe + the Message envelope."""
    n = len(data)
    if n < 6 or data[:4] != _MAGIC:
        raise ValueError("bad magic")
    version, kind = data[4], data[5]
    if version != _VERSION:
        raise ValueError(f"unsupported wire version {version}")
    o = 6
    if o + 4 > n:
        raise ValueError("truncated frame")
    (sender_len,) = _U32.unpack_from(data, o)
    if sender_len > MAX_FIELD_BYTES:
        raise ValueError(f"field length {sender_len} exceeds cap")
    sender_off = o + 4
    o = sender_off + sender_len
    if o + 8 + 4 > n:
        raise ValueError("truncated frame")
    ts_off = o
    (body_len,) = _U32.unpack_from(data, o + 8)
    if body_len > MAX_FIELD_BYTES:
        raise ValueError(f"field length {body_len} exceeds cap")
    body_off = o + 12
    prefix_end = body_off + body_len
    if prefix_end + 4 > n:
        raise ValueError("truncated frame")
    (sig_len,) = _U32.unpack_from(data, prefix_end)
    if sig_len > MAX_FIELD_BYTES:
        raise ValueError(f"field length {sig_len} exceeds cap")
    sig_off = prefix_end + 4
    sig_end = sig_off + sig_len
    if sig_end > n:
        raise ValueError("truncated frame")
    attestation = b""
    if sig_end != n:
        # optional attested-log trailer: exactly one tagged blob
        if sig_end + 5 > n or data[sig_end] != ATTEST_TAG:
            raise ValueError("trailing bytes in frame")
        (att_len,) = _U32.unpack_from(data, sig_end + 1)
        if att_len > MAX_FIELD_BYTES:
            raise ValueError(f"field length {att_len} exceeds cap")
        att_off = sig_end + 5
        if att_off + att_len != n:
            raise ValueError(
                "truncated frame" if att_off + att_len > n
                else "trailing bytes in frame"
            )
        attestation = data[att_off:]
    view = memoryview(data)
    prefix = view[:prefix_end]
    digest = hashlib.sha256(prefix).digest()
    ent = memo.map.get(digest)
    if ent is None:
        memo.misses += 1
        sender = bytes(view[sender_off : sender_off + sender_len]).decode(
            "utf-8"
        )
        (ts,) = _F64.unpack_from(data, ts_off)
        payload, consumed = _parse_payload(data, body_off, prefix_end, kind)
        if consumed != prefix_end:
            # canonical-or-reject, same as _decode_payload: the MAC
            # covers these bytes and trailing junk is malleability
            raise ValueError("trailing bytes in payload body")
        ent = (sender, ts, payload)
        memo.put(digest, ent)
    else:
        memo.hits += 1
        sender, ts, payload = ent
    return (
        Message(
            sender_id=sender,
            timestamp=ts,
            payload=payload,
            signature=data[sig_off:sig_end],
            attestation=attestation,
        ),
        prefix,
    )


def decode_frame(
    data: bytes, payload_memo: Optional[dict] = None
) -> Tuple[Message, bytes]:
    """Decode a frame into (Message, signing_prefix).

    The wire layout is ``signing_bytes || len(sig) || sig``
    (attach_signature), so the exact byte string the MAC covers is a
    PREFIX of the frame — returning it lets authenticators verify
    without re-encoding the payload (at N=64 the re-encode was ~1/5 of
    the whole epoch's wall clock).

    ``payload_memo``: optional (kind, body) -> payload cache for
    transports that deliver one broadcast's IDENTICAL body bytes to
    many local receivers (the in-proc ChannelNetwork): the body parses
    once and the immutable payload object (NamedTuple / frozen
    dataclass) is shared.  Keyed on the exact bytes, so two distinct
    frames can never alias; per-receiver envelope fields (sender, ts,
    signature) are still decoded per frame, and MACs still verify per
    (sender, receiver) pair."""
    if len(data) < 6 or data[:4] != _MAGIC:
        raise ValueError("bad magic")
    version, kind = data[4], data[5]
    if version != _VERSION:
        raise ValueError(f"unsupported wire version {version}")
    r = _Reader(data[6:])
    sender = r.str_()
    ts = r.f64()
    body = r.bytes_()
    signing_prefix = data[: 6 + r._o]
    sig = r.bytes_()
    attestation = b""
    if not r.done():
        # optional attested-log trailer: exactly one tagged blob
        if r.u8() != ATTEST_TAG:
            raise ValueError("trailing bytes in frame")
        attestation = r.bytes_()
        if not r.done():
            raise ValueError("trailing bytes in frame")
    if payload_memo is None:
        payload = _decode_payload(kind, body)
    else:
        key = (kind, body)
        payload = payload_memo.get(key)
        if payload is None:
            payload = _decode_payload(kind, body)
            if len(payload_memo) >= _PAYLOAD_MEMO_CAP:
                payload_memo.clear()
            payload_memo[key] = payload
    return (
        Message(
            sender_id=sender,
            timestamp=ts,
            payload=payload,
            signature=sig,
            attestation=attestation,
        ),
        signing_prefix,
    )


# One wave's broadcast bodies stay hot; the cap bounds memory and a
# wholesale clear keeps lookups O(1) (bodies recur only within a wave,
# so eviction costs at most one re-parse per live body).
_PAYLOAD_MEMO_CAP = 4096


def decode_message(data: bytes) -> Message:
    return decode_frame(data)[0]


# ---------------------------------------------------------------------------
# client ingress frames
# ---------------------------------------------------------------------------

_INGRESS_MAGIC = b"CLIN"  # cleisthenes-tpu ingress (client) magic

# the only kinds a client frame may carry, in either direction; any
# validator-plane kind inside an ingress frame is rejected at decode,
# so a client can never smuggle protocol payloads past the MAC layer
_INGRESS_KINDS = frozenset(
    (
        _KIND_INGRESS_SUBMIT,
        _KIND_INGRESS_ACK,
        _KIND_INGRESS_SUB,
        _KIND_INGRESS_BATCH,
    )
)


def encode_client_frame(p: Payload) -> bytes:
    """One unauthenticated client<->validator ingress frame:
    ``CLIN | version | kind | TLV body``.  No envelope MAC — clients
    hold no roster keys; the mempool's admission control (dedup,
    per-client caps, priority eviction) is the abuse guard, and the
    gRPC stream supplies the length delimiting."""
    kind, body = _encode_payload(p)
    if kind not in _INGRESS_KINDS:
        raise ValueError(
            f"payload kind {kind} is not a client ingress kind"
        )
    return _INGRESS_MAGIC + struct.pack(">BB", _VERSION, kind) + body


def decode_client_frame(data: bytes) -> Payload:
    """Inverse of ``encode_client_frame``; canonical-or-reject like the
    validator codec, and restricted to the ingress kind set."""
    if len(data) < 6 or data[:4] != _INGRESS_MAGIC:
        raise ValueError("bad ingress magic")
    version, kind = data[4], data[5]
    if version != _VERSION:
        raise ValueError(f"unsupported wire version {version}")
    if kind not in _INGRESS_KINDS:
        raise ValueError(f"payload kind {kind} is not a client ingress kind")
    payload, consumed = _parse_payload(data, 6, len(data), kind)
    if consumed != len(data):
        raise ValueError("trailing bytes in ingress frame")
    return payload


__all__ = [
    "Message",
    "Payload",
    "RbcPayload",
    "BbaPayload",
    "CoinPayload",
    "DecSharePayload",
    "CatchupReqPayload",
    "CatchupRespPayload",
    "CatchupOrdPayload",
    "ResharePayload",
    "BundlePayload",
    "BbaBatchPayload",
    "CoinBatchPayload",
    "DecShareBatchPayload",
    "ReadyBatchPayload",
    "EchoBatchPayload",
    "IngressSubmitPayload",
    "IngressAckPayload",
    "IngressSubscribePayload",
    "IngressBatchPayload",
    "LanePayload",
    "IngressStatus",
    "RbcType",
    "BbaType",
    "encode_client_frame",
    "decode_client_frame",
    "encode_message",
    "decode_message",
    "decode_frame",
    "decode_frame_shared",
    "FrameDecodeMemo",
    "FrameEncodeMemo",
    "encode_payload_shared",
    "payload_body_count",
    "signing_bytes",
    "signing_bytes_shared",
    "attach_signature",
    "ATTEST_TAG",
    "MAX_FIELD_BYTES",
]
