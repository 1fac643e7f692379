"""Adapter for the reference's protobuf wire contract.

The reference's transport speaks proto3 ``pb.Message`` over one bidi
stream (reference pb/message.proto:7-46): an envelope
``Message{signature=1 bytes, timestamp=2 google.protobuf.Timestamp,
oneof payload{rbc=3 RBC, bba=4 BBA}}`` where ``RBC``/``BBA`` carry one
``payload=1 bytes`` field holding the marshalled inner request and
declare their type enums (VAL/ECHO/READY, BVAL/AUX).  The inner
marshalling format is unspecified at v0 (the skeleton never serialized
a request — "marshaled data by type", message.proto:27), so true
interop ends at the envelope; this adapter makes "same capabilities"
checkable AT THAT LAYER: our typed payloads round-trip through
byte-exact proto3 frames a stock protobuf decoder accepts.

Hand-rolled proto3 wire format (varints + length-delimited fields) —
no generated stubs, no protobuf dependency, byte-compatible with the
canonical encoder for this schema.  Inner requests are carried as our
deterministic TLV payload bodies (transport.message._encode_payload),
declared in an ``x-cleisthenes-tlv`` comment sense: a Go peer decodes
the envelope and the RBC/BBA type enum and sees the inner bytes
opaquely, exactly as the reference code would have.

This is deliberately an ADAPTER, not the native wire format: the
native codec (transport/message.py) stays the deterministic TLV
framing the MAC layer depends on (its rationale at message.py:17-24).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from cleisthenes_tpu_torch.transport.message import (
    BbaPayload,
    CatchupOrdPayload,
    CatchupReqPayload,
    CatchupRespPayload,
    IngressAckPayload,
    IngressBatchPayload,
    IngressSubmitPayload,
    IngressSubscribePayload,
    Message,
    Payload,
    RbcPayload,
    ResharePayload,
    _KIND_BBA,
    _KIND_CATCHUP_ORD,
    _KIND_CATCHUP_REQ,
    _KIND_CATCHUP_RESP,
    _KIND_INGRESS_ACK,
    _KIND_INGRESS_BATCH,
    _KIND_INGRESS_SUB,
    _KIND_INGRESS_SUBMIT,
    _KIND_RBC,
    _KIND_RESHARE,
    _encode_payload,
    _decode_payload,
)

_WT_VARINT = 0
_WT_LEN = 2

# The reference oneof numbers its rbc/bba slots 3 and 4
# (message.proto:18-22) and our native kind registry deliberately
# keeps the SAME numbers (message.py:300-302), so the oneof tags ARE
# the kind constants — spelled by name here so the wire registry
# analyzer (staticcheck WIRE001) sees the coverage and a renumbering
# on either side cannot drift silently.
_PB_TAG_RBC = _KIND_RBC
_PB_TAG_BBA = _KIND_BBA

# Extension slots beyond the reference's oneof (message.proto stops at
# bba=4): the crash-recovery CATCHUP pair rides high tag numbers as
# length-delimited messages carrying our TLV body in field 1.  A stock
# decoder built from the unextended schema skips them per proto3
# unknown-field semantics, so extended and stock peers interoperate —
# a reference peer simply cannot serve catch-up.
_PB_TAG_CATCHUP_REQ = 15
_PB_TAG_CATCHUP_RESP = 16
# ciphertext-ordered catch-up (Config.order_then_settle): same TLV-in-
# field-1 extension shape, next free tag
_PB_TAG_CATCHUP_ORD = 17
# dynamic membership: the reshare-dealing gossip kind (same field-1
# extension shape)
_PB_TAG_RESHARE = 18
# client ingress plane (transport/ingress.py): submit/ack/subscribe/
# batch-event frames, same TLV-in-field-1 extension shape — a stock
# decoder skips them as unknown fields, so a reference peer simply has
# no client door (the capability its skeleton never reached)
_PB_TAG_INGRESS_SUBMIT = 19
_PB_TAG_INGRESS_ACK = 20
_PB_TAG_INGRESS_SUB = 21
_PB_TAG_INGRESS_BATCH = 22
# attested sender log (protocol/attest.py): the envelope-level
# attestation trailer — NOT a payload kind, it rides beside the
# signature on every frame when Config.attested_log is armed.  Raw
# blob, next free tag; a stock decoder skips it per proto3
# unknown-field semantics, so a reference peer interoperates on the
# baseline arm and simply cannot join an attested roster (its frames
# carry no stamp and fail attestation verify — by design).
_PB_TAG_ATTEST = 23

# A Byzantine frame must not make us allocate from a length varint.
MAX_PB_FIELD = 64 * 1024 * 1024


def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(d: bytes, o: int) -> Tuple[int, int]:
    x = 0
    shift = 0
    while True:
        if o >= len(d) or shift > 63:
            raise ValueError("truncated/overlong varint")
        b = d[o]
        o += 1
        x |= (b & 0x7F) << shift
        if not (b & 0x80):
            return x, o
        shift += 7


def _len_field(tag: int, body: bytes) -> bytes:
    return _varint((tag << 3) | _WT_LEN) + _varint(len(body)) + body


def _varint_field(tag: int, value: int) -> bytes:
    if value == 0:  # proto3 default: omitted
        return b""
    return _varint((tag << 3) | _WT_VARINT) + _varint(value)


def _timestamp_body(ts: float) -> bytes:
    seconds = math.floor(ts)
    nanos = int(round((ts - seconds) * 1e9))
    if nanos >= 1_000_000_000:
        seconds += 1
        nanos = 0
    return _varint_field(1, seconds) + _varint_field(2, nanos)


def _parse_timestamp(body: bytes) -> float:
    seconds = nanos = 0
    o = 0
    while o < len(body):
        key, o = _read_varint(body, o)
        tag, wt = key >> 3, key & 7
        if wt != _WT_VARINT:
            raise ValueError("unexpected wire type in Timestamp")
        val, o = _read_varint(body, o)
        if tag == 1:
            seconds = val
        elif tag == 2:
            nanos = val
    return seconds + nanos / 1e9


def _inner_body(kind_tag: int, payload: Payload) -> bytes:
    """RBC/BBA message body: payload=1 bytes (our TLV bytes) +
    type as field 2 varint (the enum the reference declares)."""
    _tlv_kind, tlv = _encode_payload(payload)
    return _len_field(1, tlv) + _varint_field(2, int(payload.type))


def encode_pb_message(msg: Message) -> bytes:
    """Our envelope -> reference pb.Message bytes.

    Only RBC and BBA payloads exist in the reference's oneof
    (message.proto:19-22); other kinds raise — they are capabilities
    the reference never reached, with no slot in its contract."""
    p = msg.payload
    if isinstance(p, RbcPayload):
        one = _len_field(_PB_TAG_RBC, _inner_body(_PB_TAG_RBC, p))
    elif isinstance(p, BbaPayload):
        one = _len_field(_PB_TAG_BBA, _inner_body(_PB_TAG_BBA, p))
    elif isinstance(p, CatchupReqPayload):
        _k, tlv = _encode_payload(p)
        one = _len_field(_PB_TAG_CATCHUP_REQ, _len_field(1, tlv))
    elif isinstance(p, CatchupRespPayload):
        _k, tlv = _encode_payload(p)
        one = _len_field(_PB_TAG_CATCHUP_RESP, _len_field(1, tlv))
    elif isinstance(p, CatchupOrdPayload):
        _k, tlv = _encode_payload(p)
        one = _len_field(_PB_TAG_CATCHUP_ORD, _len_field(1, tlv))
    elif isinstance(p, ResharePayload):
        _k, tlv = _encode_payload(p)
        one = _len_field(_PB_TAG_RESHARE, _len_field(1, tlv))
    elif isinstance(p, IngressSubmitPayload):
        _k, tlv = _encode_payload(p)
        one = _len_field(_PB_TAG_INGRESS_SUBMIT, _len_field(1, tlv))
    elif isinstance(p, IngressAckPayload):
        _k, tlv = _encode_payload(p)
        one = _len_field(_PB_TAG_INGRESS_ACK, _len_field(1, tlv))
    elif isinstance(p, IngressSubscribePayload):
        _k, tlv = _encode_payload(p)
        one = _len_field(_PB_TAG_INGRESS_SUB, _len_field(1, tlv))
    elif isinstance(p, IngressBatchPayload):
        _k, tlv = _encode_payload(p)
        one = _len_field(_PB_TAG_INGRESS_BATCH, _len_field(1, tlv))
    else:
        raise ValueError(
            f"{type(p).__name__} has no slot in the reference's oneof"
        )
    att = (
        _len_field(_PB_TAG_ATTEST, msg.attestation)
        if msg.attestation
        else b""
    )
    return (
        _len_field(1, msg.signature)
        + _len_field(2, _timestamp_body(msg.timestamp))
        + one
        + att
    )


def decode_pb_message(data: bytes, sender_id: str = "") -> Message:
    """Reference pb.Message bytes -> our envelope.

    ``sender_id`` must come from the connection (the reference trusts
    the stream's uuid, comm.go:46 — its envelope has no sender field).
    """
    signature = b""
    attestation = b""
    ts = 0.0
    payload: Optional[Payload] = None
    o = 0
    while o < len(data):
        key, o = _read_varint(data, o)
        tag, wt = key >> 3, key & 7
        if wt != _WT_LEN:
            # unknown scalar fields skip per proto3 semantics (forward
            # compatibility); the KNOWN tags are all length-delimited
            if tag in (
                1, 2, _PB_TAG_RBC, _PB_TAG_BBA,
                _PB_TAG_CATCHUP_REQ, _PB_TAG_CATCHUP_RESP,
                _PB_TAG_CATCHUP_ORD, _PB_TAG_RESHARE,
                _PB_TAG_INGRESS_SUBMIT, _PB_TAG_INGRESS_ACK,
                _PB_TAG_INGRESS_SUB, _PB_TAG_INGRESS_BATCH,
                _PB_TAG_ATTEST,
            ):
                raise ValueError(
                    f"wire type {wt} for known tag {tag} (expected LEN)"
                )
            if wt == _WT_VARINT:
                _v, o = _read_varint(data, o)
            elif wt == 1:  # fixed64
                o += 8
            elif wt == 5:  # fixed32
                o += 4
            else:
                raise ValueError(f"unsupported wire type {wt}")
            if o > len(data):
                raise ValueError("truncated pb field")
            continue
        ln, o = _read_varint(data, o)
        if ln > MAX_PB_FIELD or o + ln > len(data):
            raise ValueError("truncated/oversized pb field")
        body = data[o : o + ln]
        o += ln
        if tag == 1:
            signature = body
        elif tag == 2:
            ts = _parse_timestamp(body)
        elif tag in (_PB_TAG_RBC, _PB_TAG_BBA):
            payload = _parse_inner(tag, body)
        elif tag in (
            _PB_TAG_CATCHUP_REQ, _PB_TAG_CATCHUP_RESP,
            _PB_TAG_CATCHUP_ORD, _PB_TAG_RESHARE,
            _PB_TAG_INGRESS_SUBMIT, _PB_TAG_INGRESS_ACK,
            _PB_TAG_INGRESS_SUB, _PB_TAG_INGRESS_BATCH,
        ):
            payload = _parse_catchup(tag, body)
        elif tag == _PB_TAG_ATTEST:
            attestation = body
        # unknown LEN fields are skipped, per proto3 semantics
    if payload is None:
        raise ValueError("pb.Message carries no rbc/bba payload")
    return Message(
        sender_id=sender_id, timestamp=ts, payload=payload,
        signature=signature, attestation=attestation,
    )


def _parse_catchup(tag: int, body: bytes) -> Payload:
    """Extension slots: TLV body in field 1, no type enum."""
    tlv = b""
    o = 0
    while o < len(body):
        key, o = _read_varint(body, o)
        ftag, wt = key >> 3, key & 7
        if wt != _WT_LEN:
            raise ValueError(f"unexpected wire type {wt} in Catchup")
        ln, o = _read_varint(body, o)
        if ln > MAX_PB_FIELD or o + ln > len(body):
            raise ValueError("truncated/oversized pb field")
        if ftag == 1:
            tlv = body[o : o + ln]
        o += ln
    if tag == _PB_TAG_CATCHUP_REQ:
        kind = _KIND_CATCHUP_REQ
    elif tag == _PB_TAG_CATCHUP_RESP:
        kind = _KIND_CATCHUP_RESP
    elif tag == _PB_TAG_RESHARE:
        kind = _KIND_RESHARE
    elif tag == _PB_TAG_INGRESS_SUBMIT:
        kind = _KIND_INGRESS_SUBMIT
    elif tag == _PB_TAG_INGRESS_ACK:
        kind = _KIND_INGRESS_ACK
    elif tag == _PB_TAG_INGRESS_SUB:
        kind = _KIND_INGRESS_SUB
    elif tag == _PB_TAG_INGRESS_BATCH:
        kind = _KIND_INGRESS_BATCH
    else:
        kind = _KIND_CATCHUP_ORD
    return _decode_payload(kind, tlv)


def _parse_inner(tag: int, body: bytes) -> Payload:
    tlv = b""
    o = 0
    while o < len(body):
        key, o = _read_varint(body, o)
        ftag, wt = key >> 3, key & 7
        if wt == _WT_LEN:
            ln, o = _read_varint(body, o)
            if ln > MAX_PB_FIELD or o + ln > len(body):
                raise ValueError("truncated/oversized pb field")
            if ftag == 1:
                tlv = body[o : o + ln]
            o += ln
        elif wt == _WT_VARINT:
            _val, o = _read_varint(body, o)  # type enum: informational
        else:
            raise ValueError(f"unexpected wire type {wt} in RBC/BBA")
    kind = _KIND_RBC if tag == _PB_TAG_RBC else _KIND_BBA
    payload = _decode_payload(kind, tlv)
    return payload


__all__ = ["encode_pb_message", "decode_pb_message"]
