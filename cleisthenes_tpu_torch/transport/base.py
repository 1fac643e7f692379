"""The Connection / Broadcaster / Handler seam + message authentication.

Mirrors reference conn.go: ``Handler.ServeRequest(msg)`` (conn.go:27-29),
the ``Connection`` interface ``{Send, Ip, Id, Close, Start, Handle}``
(conn.go:31-38), ``Broadcaster`` (conn.go:182-184) and
``ConnectionPool.{GetAll, Broadcast, Add, Remove}`` (conn.go:186-216).
Two deliberate upgrades over the reference:

- ``ConnectionPool`` is lock-guarded — the reference's pool map is the
  one shared structure it forgot to lock (SURVEY.md §5.2 "known gap",
  conn.go:186-216).
- ``verify`` is real: the reference's envelope has a ``signature``
  field but its check is a TODO returning true (conn.go:134-137);
  here an ``Authenticator`` seam MACs the envelope
  (HMAC-SHA256 over transport.message.signing_bytes).
"""

from __future__ import annotations

import abc
import hashlib
import hmac
from typing import Callable, Dict, List, Optional, Protocol, runtime_checkable

from cleisthenes_tpu_torch.transport.message import (
    Message,
    attach_signature,
    signing_bytes,
)
from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_rlock


@runtime_checkable
class Handler(Protocol):
    """Reference conn.go:27-29."""

    def serve_request(self, msg: Message) -> None: ...


@runtime_checkable
class Connection(Protocol):
    """Reference conn.go:31-38.  ``send`` is fire-and-forget with
    optional delivery callbacks (conn.go:66-77)."""

    def send(
        self,
        msg: Message,
        on_success: Optional[Callable[[Message], None]] = None,
        on_err: Optional[Callable[[Exception], None]] = None,
    ) -> None: ...

    def id(self) -> str: ...

    def close(self) -> None: ...

    def start(self) -> None: ...

    def handle(self, handler: Handler) -> None: ...


class Broadcaster(Protocol):
    """Reference conn.go:182-184 — the only transport dependency the
    protocol layer has (rbc/rbc.go:35, bba/bba.go:60)."""

    def broadcast(self, msg: Message) -> None: ...

    def send_to(self, conn_id: str, msg: Message) -> None: ...


def wire_idle_hooks(handler):
    """The transport-manages-idle handshake, in one place.

    Returns ``(flush_outbound, on_idle)`` — the handler's optional
    transport hooks (None when absent) — and, IFF the handler exposes
    ``on_idle``, notifies it via ``transport_manages_idle()`` that this
    transport COMMITS to calling ``on_idle`` at every quiescence point.
    The promise is load-bearing: a notified handler defers batched
    crypto and outbound bundling to those callbacks, so a transport
    must only call this if it will deliver them (ChannelNetwork.run's
    idle phase; SerialDispatcher's empty-mailbox check).
    """
    flush_outbound = getattr(handler, "flush_outbound", None)
    on_idle = getattr(handler, "on_idle", None)
    notify = getattr(handler, "transport_manages_idle", None)
    if on_idle is not None and callable(notify):
        notify()
    return flush_outbound, on_idle


# ---------------------------------------------------------------------------
# Authentication (the implemented version of conn.go:134-137's TODO)
# ---------------------------------------------------------------------------


def _hmac_sha256_fn(key: bytes) -> Callable[[bytes], bytes]:
    """Precomputed HMAC-SHA256 for one pair key (RFC 2104).

    ``hmac.new`` re-runs the key schedule — two full SHA-256 block
    compressions over the padded key — on EVERY call; at N=64 that is
    ~280k schedules per epoch (one per signed + one per verified
    frame) for a roster of 63 fixed keys.  Here the inner/outer pad
    contexts initialize once per pair key and each MAC is two context
    copies + updates.  Byte-for-byte identical output to
    ``hmac.new(key, msg, hashlib.sha256).digest()`` (asserted by
    tests/test_transport.py); comparisons still go through
    ``hmac.compare_digest``.
    """
    if len(key) > 64:  # SHA-256 block size
        key = hashlib.sha256(key).digest()
    key = key.ljust(64, b"\x00")
    inner = hashlib.sha256(bytes(b ^ 0x36 for b in key))
    outer = hashlib.sha256(bytes(b ^ 0x5C for b in key))

    def mac(msg: bytes, _inner=inner, _outer=outer) -> bytes:
        h = _inner.copy()
        h.update(msg)
        o = _outer.copy()
        o.update(h.digest())
        return o.digest()

    return mac


class Authenticator(abc.ABC):
    """Signs and verifies envelope MACs.

    ``sign`` takes the intended receiver because MAC keys are scoped to
    the (sender, receiver) pair — a broadcast is N individually-MACed
    frames, not one frame fanned out.
    """

    @abc.abstractmethod
    def sign(self, msg: Message, receiver_id: Optional[str] = None) -> Message:
        """Return a copy of ``msg`` with the signature field filled."""

    @abc.abstractmethod
    def verify(self, msg: Message) -> bool: ...

    def verify_wire(self, msg: Message, signing_prefix: bytes) -> bool:
        """Verify using the frame's own signing-bytes prefix (from
        transport.message.decode_frame) — MAC backends override to
        skip the payload re-encode that ``verify`` must do."""
        return self.verify(msg)

    def verify_wire_many(self, msgs, signing_prefixes) -> "List[bool]":
        """Verdicts for one inbound wave's frames in ONE call
        (Config.delivery_columnar): the transports buffer frames per
        message wave and verify them together, so per-frame python
        dispatch amortizes across the batch.  Default: loop
        verify_wire.  MAC backends override to hoist the per-sender
        key-schedule lookup out of the loop (the _hmac_sha256_fn
        contexts are per-pair constants — one dict probe per DISTINCT
        sender per wave instead of one per frame)."""
        return [
            self.verify_wire(m, p) for m, p in zip(msgs, signing_prefixes)
        ]

    def sign_wire_many(self, msg: Message, receiver_ids) -> "Dict[str, bytes]":
        """receiver_id -> complete wire frame, for broadcasts.

        Default: sign+encode per receiver.  Pairwise-MAC backends
        override to encode the envelope once and append per-receiver
        MACs (the broadcast hot path is N frames that differ only in
        the 32-byte signature).
        """
        from cleisthenes_tpu_torch.transport.message import encode_message

        return {
            rid: encode_message(self.sign(msg, rid))
            for rid in receiver_ids
        }

    def sign_wire_wave(self, items, memo=None) -> "List[Dict[str, bytes]]":
        """One EGRESS wave's frames in ONE call (Config.egress_columnar)
        — the send-side twin of ``verify_wire_many``.

        ``items`` is ``[(msg, receiver_ids)]``: everything one
        coalescer flush ships (one folded bundle per receiver, or one
        shared bundle for a pure broadcast wave).  Returns one
        ``{receiver_id: wire frame}`` dict per item, byte-identical to
        looping ``sign_wire_many`` (tests/test_egress_equivalence.py
        asserts it).  ``memo`` is the caller's FrameEncodeMemo
        (transport.message): a wave's per-receiver bundles mostly
        re-encode SHARED payload objects, so the memo collapses those
        to one encode + joins.  Default: loop sign_wire_many; MAC
        backends override to run the whole wave's HMACs as one batched
        pass over the precomputed key schedules."""
        return [
            self.sign_wire_many(m, rids)
            for m, rids in items
        ]


def sign_wave_counted(auth: "Authenticator", items, memo):
    """One egress wave through ``auth.sign_wire_wave`` with the
    counter attribution both transports share: ``(frames_list,
    memo_hits, memo_misses, payload_bodies_encoded)``.

    ``payload_bodies_encoded`` (the ``frames_encoded`` counter's
    unit) is the FrameEncodeMemo's miss delta when the signer
    consulted the memo (Hmac/Null always probe at least once per
    item); a backend whose wave path ignores the memo (the ABC's
    per-item default) falls back to the scalar arm's unit — payload
    bodies per entry — WITHOUT inventing memo misses for probes that
    never happened, so the memo stat surfaces stay truthful and the
    perfgate-gated counter never silently reads zero."""
    from cleisthenes_tpu_torch.transport.message import payload_body_count

    h0 = memo.hits if memo is not None else 0
    m0 = memo.misses if memo is not None else 0
    frames_list = auth.sign_wire_wave(items, memo)
    hits = (memo.hits - h0) if memo is not None else 0
    misses = (memo.misses - m0) if memo is not None else 0
    if hits or misses:
        return frames_list, hits, misses, misses
    bodies = sum(payload_body_count(m.payload) for m, _rids in items)
    return frames_list, 0, 0, bodies


class NullAuthenticator(Authenticator):
    """Reference-faithful stand-in: accept everything
    (conn.go:134-137 behavior, for benchmarks isolating crypto cost)."""

    def sign(self, msg: Message, receiver_id: Optional[str] = None) -> Message:
        return msg

    def verify(self, msg: Message) -> bool:
        return True

    def sign_wire_many(self, msg: Message, receiver_ids) -> "Dict[str, bytes]":
        """No MAC, so every receiver's frame is the same bytes object:
        one encode per broadcast."""
        from cleisthenes_tpu_torch.transport.message import encode_message

        wire = encode_message(msg)
        return {rid: wire for rid in receiver_ids}

    def verify_wire_many(self, msgs, signing_prefixes) -> "List[bool]":
        return [True] * len(msgs)

    def sign_wire_wave(self, items, memo=None) -> "List[Dict[str, bytes]]":
        """No MAC: each item's frame is its signing bytes + an empty
        signature, encoded once per distinct payload via the memo."""
        from cleisthenes_tpu_torch.transport.message import (
            attach_signature,
            signing_bytes_shared,
        )

        out: "List[Dict[str, bytes]]" = []
        for msg, rids in items:
            sb = (
                signing_bytes_shared(msg, memo)
                if memo is not None
                else signing_bytes(msg)
            )
            wire = attach_signature(sb, msg.signature)
            out.append({rid: wire for rid in rids})
        return out


class HmacAuthenticator(Authenticator):
    """HMAC-SHA256 over the envelope with per-ordered-pair keys.

    Node i holds ONLY the pair keys ``k_{i,j}`` for pairs it belongs
    to: it signs a message to j with ``k_{i,j}`` and verifies an
    inbound claim "from j" with ``k_{j,i}`` (= ``k_{i,j}``, unordered).
    Because a third roster member c never holds ``k_{i,j}``, c cannot
    forge envelopes between honest i and j — which is the quorum-
    intersection property RBC/BBA/ACS need from the reference's empty
    ``verify`` TODO (conn.go:134-137).  What a Byzantine j CAN still do
    is lie to each peer separately (equivocate) — the protocol's
    Byzantine tolerance, not the MAC layer, covers that.

    The dealer derives pair keys from a master secret it never
    distributes (``protocol.honeybadger.setup_keys``); each node
    receives just its own key map.  ``derive`` reproduces the dealer's
    schedule for tests that hold the master themselves.
    """

    def __init__(self, self_id: str, peer_keys: "Dict[str, bytes]"):
        self._self_id = self_id
        self._peer_keys = dict(peer_keys)
        # per-peer precomputed HMAC key schedules (the roster changes
        # only at reconfig boundaries; see _hmac_sha256_fn)
        self._macs: "Dict[str, Callable[[bytes], bytes]]" = {
            peer: _hmac_sha256_fn(key)
            for peer, key in self._peer_keys.items()
        }
        # MAC rotation (protocol.reconfig): the SECONDARY verify map.
        # A surviving pair's next-version key is STAGED here at
        # reconfig discovery (verification accepts either key, signing
        # stays on the old one), PROMOTED to primary at the activation
        # boundary (the old key drops into this map so in-flight
        # frames still verify), and the leftover alternate is dropped
        # at retirement teardown — after which a stale pre-rotation
        # key no longer authenticates anything.
        self._alt_keys: "Dict[str, bytes]" = {}
        self._alt_macs: "Dict[str, Callable[[bytes], bytes]]" = {}

    def set_peer_key(self, peer_id: str, key: bytes) -> None:
        """Install (or rotate) one pair key — the dynamic-membership
        seam: a RECONFIG ceremony derives fresh pair keys for joiner
        pairs and installs them here the moment the roster change is
        discovered, so a joiner's CATCHUP traffic authenticates before
        its activation epoch.  Single-assignment per peer per call;
        in-flight frames MAC'd under a replaced key are rejected, the
        same fate as any stale-roster frame."""
        self._peer_keys[peer_id] = key
        self._macs[peer_id] = _hmac_sha256_fn(key)

    def stage_peer_key(self, peer_id: str, key: bytes) -> None:
        """Stage a SURVIVING pair's next-version key for verification
        only (MAC rotation step 1, at reconfig discovery): inbound
        frames verify under the current OR the staged key, outbound
        frames keep signing under the current one.  Nodes cross the
        activation boundary at different instants, so a hard swap
        would reject every in-flight frame straddling it; staging at
        discovery — the earliest log position all survivors share —
        makes the handover seamless in both directions."""
        if key == self._peer_keys.get(peer_id):
            return  # same-key "rotation" (e.g. replay): nothing staged
        self._alt_keys[peer_id] = key
        self._alt_macs[peer_id] = _hmac_sha256_fn(key)

    def promote_staged_key(self, peer_id: str) -> None:
        """Switch signing to the staged key (MAC rotation step 2, at
        the activation boundary): the staged key becomes primary and
        the OLD key drops into the secondary verify map, so frames
        MAC'd just before the boundary still verify until teardown."""
        key = self._alt_keys.get(peer_id)
        if key is None:
            return
        old_key = self._peer_keys.get(peer_id)
        old_fn = self._macs.get(peer_id)
        self._peer_keys[peer_id] = key
        self._macs[peer_id] = self._alt_macs[peer_id]
        if old_key is not None:
            self._alt_keys[peer_id] = old_key
            self._alt_macs[peer_id] = old_fn
        else:
            del self._alt_keys[peer_id]
            del self._alt_macs[peer_id]

    def drop_alt_key(self, peer_id: str) -> None:
        """Forget the secondary key (MAC rotation step 3, at
        retirement teardown): from here a frame MAC'd under the
        pre-rotation key is rejected — the stale-key regression the
        rotation exists to create."""
        self._alt_keys.pop(peer_id, None)
        self._alt_macs.pop(peer_id, None)

    def drop_peer(self, peer_id: str) -> None:
        """Retire one pair key: frames to/from the peer no longer
        sign or verify (the MAC-layer half of peer retirement —
        transport.health tears down the dial half)."""
        self._peer_keys.pop(peer_id, None)
        self._macs.pop(peer_id, None)
        self._alt_keys.pop(peer_id, None)
        self._alt_macs.pop(peer_id, None)

    @staticmethod
    def pair_key(master_secret: bytes, a: str, b: str) -> bytes:
        """The dealer's derivation: unordered-pair key
        ``H("macpair" || master || min(a,b) || max(a,b))``."""
        lo, hi = sorted((a.encode("utf-8"), b.encode("utf-8")))
        return hashlib.sha256(
            b"macpair|" + master_secret + b"|" + lo + b"|" + hi
        ).digest()

    @classmethod
    def key_map(
        cls, master_secret: bytes, self_id: str, roster_ids
    ) -> "Dict[str, bytes]":
        """The dealer's key schedule for one node: every pair key
        ``self_id`` belongs to (the single source both ``derive`` and
        ``protocol.honeybadger.setup_keys`` use)."""
        return {
            peer: cls.pair_key(master_secret, self_id, peer)
            for peer in roster_ids
        }

    @classmethod
    def derive(
        cls, master_secret: bytes, self_id: str, roster_ids
    ) -> "HmacAuthenticator":
        """Build node ``self_id``'s authenticator from the dealer's
        master (test/dealer-side convenience)."""
        return cls(self_id, cls.key_map(master_secret, self_id, roster_ids))

    def _key_with(self, peer_id: str) -> Optional[bytes]:
        return self._peer_keys.get(peer_id)

    def sign(self, msg: Message, receiver_id: Optional[str] = None) -> Message:
        if msg.sender_id != self._self_id:
            # a mismatch would produce messages every receiver silently
            # rejects (pair key involves self_id, verified by sender_id)
            raise ValueError(
                f"cannot sign as {msg.sender_id!r}: this authenticator "
                f"holds the keys of {self._self_id!r}"
            )
        if receiver_id is None:
            raise ValueError(
                "pairwise MAC needs the receiver id at sign time"
            )
        mac_fn = self._macs.get(receiver_id)
        if mac_fn is None:
            raise ValueError(f"no pair key with {receiver_id!r}")
        return Message(
            sender_id=msg.sender_id,
            timestamp=msg.timestamp,
            payload=msg.payload,
            signature=mac_fn(signing_bytes(msg)),
        )

    def verify(self, msg: Message) -> bool:
        mac_fn = self._macs.get(msg.sender_id)
        if mac_fn is None:  # not a roster member we share a key with
            return False
        sb = signing_bytes(msg)
        if hmac.compare_digest(mac_fn(sb), msg.signature):
            return True
        alt_fn = self._alt_macs.get(msg.sender_id)
        return alt_fn is not None and hmac.compare_digest(
            alt_fn(sb), msg.signature
        )

    def verify_wire(self, msg: Message, signing_prefix: bytes) -> bool:
        """MAC the frame's signing prefix directly.

        The security argument: the MAC binds the RECEIVED bytes, and
        only the two pair-key holders can produce a valid MAC over any
        byte string, so acceptance here implies the claimed sender
        authenticated exactly these bytes.  This is strictly
        byte-binding — stronger than re-encode-verify for attackers
        without the key.  Where it can differ from ``verify``: a frame
        whose payload was encoded NON-canonically (e.g. an int field
        with a leading zero byte) yet MAC'd by the key holder itself
        would pass here and fail re-encode-verify — but our encoder is
        canonical, so honest peers never emit such frames, and a
        Byzantine key holder gains nothing it couldn't send anyway
        (no component deduplicates or compares raw frame bytes)."""
        mac_fn = self._macs.get(msg.sender_id)
        if mac_fn is None:
            return False
        if hmac.compare_digest(mac_fn(signing_prefix), msg.signature):
            return True
        alt_fn = self._alt_macs.get(msg.sender_id)
        return alt_fn is not None and hmac.compare_digest(
            alt_fn(signing_prefix), msg.signature
        )

    def verify_wire_many(self, msgs, signing_prefixes) -> "List[bool]":
        """Wave verify fast path: the per-sender MAC context resolves
        once per run of same-sender frames (an inbound wave is mostly
        runs — each peer's bundle fan-in arrives together), and each
        verdict is two SHA-256 context copies + a compare_digest."""
        macs = self._macs
        alt_macs = self._alt_macs
        out: List[bool] = []
        last_sender: Optional[str] = None
        mac_fn = None
        alt_fn = None
        for msg, prefix in zip(msgs, signing_prefixes):
            sender = msg.sender_id
            if sender != last_sender:
                mac_fn = macs.get(sender)
                alt_fn = alt_macs.get(sender) if alt_macs else None
                last_sender = sender
            if mac_fn is None:
                out.append(False)
                continue
            out.append(
                hmac.compare_digest(mac_fn(prefix), msg.signature)
                or (
                    alt_fn is not None
                    and hmac.compare_digest(alt_fn(prefix), msg.signature)
                )
            )
        return out

    def sign_wire_many(self, msg: Message, receiver_ids) -> "Dict[str, bytes]":
        """Broadcast fast path: one payload encode, one MAC per peer."""
        if msg.sender_id != self._self_id:
            raise ValueError(
                f"cannot sign as {msg.sender_id!r}: this authenticator "
                f"holds the keys of {self._self_id!r}"
            )
        sb = signing_bytes(msg)
        macs = self._macs
        out: Dict[str, bytes] = {}
        for rid in receiver_ids:
            mac_fn = macs.get(rid)
            if mac_fn is None:
                raise ValueError(f"no pair key with {rid!r}")
            out[rid] = attach_signature(sb, mac_fn(sb))
        return out

    def sign_wire_wave(self, items, memo=None) -> "List[Dict[str, bytes]]":
        """Egress wave fast path (Config.egress_columnar): the whole
        flush's envelope bodies encode once per distinct payload
        OBJECT through the caller's FrameEncodeMemo — a mixed wave's
        per-receiver bundles share their broadcast run's sub-payloads,
        so N receiver bundles cost one encode each plus joins — and
        every frame's HMAC runs in one batched pass over the
        precomputed per-pair key schedules (two SHA-256 context copies
        per MAC, one dict probe per receiver).  Output byte-identical
        to looping ``sign_wire_many`` over the items."""
        from cleisthenes_tpu_torch.transport.message import signing_bytes_shared

        macs = self._macs
        self_id = self._self_id
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
            frames: Dict[str, bytes] = {}
            for rid in rids:
                mac_fn = macs.get(rid)
                if mac_fn is None:
                    raise ValueError(f"no pair key with {rid!r}")
                frames[rid] = attach_signature(sb, mac_fn(sb))
            out.append(frames)
        return out


# ---------------------------------------------------------------------------
# ConnectionPool
# ---------------------------------------------------------------------------


@guarded_by("_lock", "_conns")
class ConnectionPool:
    """id -> Connection map with broadcast (reference conn.go:186-216),
    lock-guarded (fixing the reference's unguarded map)."""

    def __init__(self) -> None:
        self._conns: Dict[str, Connection] = {}
        self._lock = new_rlock()

    def add(self, conn: Connection) -> None:
        with self._lock:
            self._conns[conn.id()] = conn

    def remove(self, conn_id: str) -> None:
        """Reference conn.go:214-216."""
        with self._lock:
            self._conns.pop(conn_id, None)

    def get(self, conn_id: str) -> Optional[Connection]:
        with self._lock:
            return self._conns.get(conn_id)

    def get_all(self) -> List[Connection]:
        """Reference conn.go:196-202 (GetAll)."""
        with self._lock:
            return list(self._conns.values())

    def broadcast(self, msg: Message) -> None:
        """Fire-and-forget send to every pooled peer
        (reference conn.go:204-208)."""
        for conn in self.get_all():
            conn.send(msg)

    def send_to(self, conn_id: str, msg: Message) -> None:
        conn = self.get(conn_id)
        if conn is not None:
            conn.send(msg)

    def __len__(self) -> int:
        with self._lock:
            return len(self._conns)


__all__ = [
    "Handler",
    "Connection",
    "Broadcaster",
    "Authenticator",
    "NullAuthenticator",
    "HmacAuthenticator",
    "ConnectionPool",
    "sign_wave_counted",
]
