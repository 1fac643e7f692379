"""In-process channel transport with a deterministic scheduler.

The reference tests multi-node behavior without a cluster by wiring N
in-proc ``Connection``s over a channel-loopback fake transport
(``mock.StreamWrapper``, test/mock/stream.go:8-38; pattern described in
SURVEY.md §4.3).  This module is that idea promoted to a first-class
subsystem: a ``ChannelNetwork`` hosts any number of in-proc validators,
every message crosses the real wire codec (encode -> bytes -> decode)
and the real Authenticator, and delivery order is driven by a *seeded
deterministic scheduler* so Byzantine interleavings are replayable —
the asyncio-era answer to the reference's ``go test -race`` discipline
(SURVEY.md §5.2, §5.4: "seeded deterministic scheduler to test
Byzantine interleavings").

Fault injection (SURVEY.md §5.3 "the mock stream is the natural
injection point"): ``crash(node)``, ``partition(a, b)``, and an
arbitrary ``fault_filter`` for message-level drop/tamper/reorder
adversaries.
"""

from __future__ import annotations

import collections
import heapq
import random
import time
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

from cleisthenes_tpu_torch.transport.base import (
    Authenticator,
    Handler,
    NullAuthenticator,
    sign_wave_counted,
)
from cleisthenes_tpu_torch.transport.message import (
    FrameDecodeMemo,
    FrameEncodeMemo,
    Message,
    decode_frame,
    decode_frame_shared,
    encode_message,
    payload_body_count,
)
from cleisthenes_tpu_torch.transport.wan import WanEmulator, WanProfile

# A fault filter sees (sender_id, receiver_id, wire_bytes) and returns
# what to deliver: bytes (pass/tamper), None (drop), or a list of
# byte-strings (duplication / replay injection — the first delivers
# now, the rest re-enter the pending queue).  Tampering is modeled by
# returning different bytes — which the Authenticator then catches.
FaultFilter = Callable[[str, str, bytes], "Optional[bytes] | list"]


class ChannelEndpoint:
    """One validator's attachment to the network: its handler plus its
    authenticator (signing outbound, verifying inbound)."""

    def __init__(
        self,
        node_id: str,
        handler: Handler,
        auth: Authenticator,
        encode_memo: Optional[FrameEncodeMemo] = None,
    ) -> None:
        self.node_id = node_id
        self.auth = auth
        self.delivered = 0
        self.rejected = 0  # failed MAC verification
        # delivery-plane counters (Config.delivery_columnar; zeroed
        # keys of Metrics.snapshot()["transport"] via endpoint_stats):
        # payload decodes actually executed / shared-prefix memo
        # hits+misses / Authenticator verify invocations (one per
        # frame scalar, one per wave batch columnar)
        self.frames_decoded = 0
        self.decode_memo_hits = 0
        self.decode_memo_misses = 0
        self.mac_verify_batches = 0
        # egress-plane counters (Config.egress_columnar, the send-side
        # twins): payload bodies actually encoded / shared-prefix
        # encode-memo hits+misses / Authenticator sign invocations
        # (one per post scalar, one per wave columnar).  The memo is
        # THIS node's outbound encode memo (None on the scalar arm).
        self.frames_encoded = 0
        self.encode_memo_hits = 0
        self.encode_memo_misses = 0
        self.mac_sign_batches = 0
        self.encode_memo = encode_memo
        self.bind(handler)

    def bind(self, handler: Handler) -> None:
        """(Re)bind the handler.  ChannelNetwork.run() delivers the
        idle-callback promise (wire_idle_hooks) at every quiescence
        point; callers driving delivery manually with step() must pair
        it with idle_phase() — see step()."""
        self.handler = handler
        from cleisthenes_tpu_torch.transport.base import wire_idle_hooks

        self.flush_outbound, self.on_idle = wire_idle_hooks(handler)


class ChannelConnection:
    """The in-proc ``Connection``: send = enqueue onto the network
    (reference conn.go:66-77 semantics, minus goroutines — delivery
    happens when the scheduler runs)."""

    def __init__(self, network: "ChannelNetwork", local_id: str, remote_id: str):
        self._network = network
        self._local_id = local_id
        self._remote_id = remote_id
        self._closed = False

    def id(self) -> str:
        return self._remote_id

    def send(self, msg, on_success=None, on_err=None) -> None:
        if self._closed:
            if on_err is not None:
                on_err(ConnectionError("connection closed"))
            return
        try:
            self._network.post(self._local_id, self._remote_id, msg)
        except Exception as exc:  # queue full / encode error
            if on_err is not None:
                on_err(exc)
            return
        if on_success is not None:
            on_success(msg)

    def close(self) -> None:
        self._closed = True

    def start(self) -> None:  # no reader loop needed in-proc
        pass

    def handle(self, handler) -> None:
        """Rebind where THIS node processes inbound traffic
        (reference conn.go:81-85: Handle sets the local dispatch target)."""
        self._network.rebind_handler(self._local_id, handler)


class ChannelNetwork:
    """N in-proc validators + a deterministic message scheduler."""

    def __init__(
        self,
        seed: Optional[int] = None,
        queue_capacity: int = 1_000_000,
        delivery_columnar: bool = False,
        wave_routing: bool = False,
        egress_columnar: bool = False,
        wan_profile: Optional[Union[str, WanProfile]] = None,
    ):
        # seed=None -> FIFO delivery; seed=int -> seeded random-order
        # delivery (the adversarial asynchronous scheduler from
        # docs/HONEYBADGER-EN.md:125-140's PBFT comparison).
        self._rng = random.Random(seed) if seed is not None else None
        self._endpoints: Dict[str, ChannelEndpoint] = {}
        # FIFO mode uses a deque (O(1) popleft); seeded mode uses a
        # list with swap-pop (O(1) uniform removal, order irrelevant).
        # Entries are 5-slot LISTS [sender, receiver, wire, prefiltered,
        # prepared] — slot 4 holds the columnar arm's pre-wave decode +
        # MAC verdict (None until a wave pass prepares it).
        self._pending = collections.deque() if seed is None else []
        self._queue_capacity = queue_capacity
        self._crashed: Set[str] = set()
        self._partitions: Set[Tuple[str, str]] = set()
        self.fault_filter: Optional[FaultFilter] = None
        self.messages_posted = 0
        self.bytes_posted = 0
        # (kind, body) -> payload: one broadcast's body parses once
        # for all local receivers (scalar arm; see message.decode_frame)
        self._payload_memo: dict = {}
        # Columnar delivery plane (Config.delivery_columnar): frames
        # decode through the shared-prefix memo and MAC-verify in ONE
        # Authenticator.verify_wire_many batch per receiver per wave
        # (_prepare_wave).  The scalar arm above stays byte-equivalent.
        self._columnar = delivery_columnar
        self._decode_memo = FrameDecodeMemo() if delivery_columnar else None
        self._unprepared = 0  # pending entries awaiting a wave pass
        # Wave-routed ingest (Config.wave_routing): one step() drains
        # the whole prepared wave, bucketing verified frames per
        # receiver, and hands each receiver its bundle in ONE
        # serve_wave call (protocol.router demuxes it into typed
        # columns) instead of one serve_request per frame.  Handlers
        # without serve_wave — and frames a mounted fault_filter must
        # see per-frame — fall back to the scalar chain.
        self._wave_routing = wave_routing and delivery_columnar
        # network-wide delivery counters (the per-epoch numbers
        # bench.py sections and perfgate gate on; per-endpoint twins
        # live on ChannelEndpoint for Metrics.snapshot)
        self.frames_decoded = 0
        self.mac_verify_calls = 0
        # Columnar egress plane (Config.egress_columnar): each flush's
        # whole wave of folded bundles arrives in ONE post_wave call,
        # signs through the sender endpoint's sign_wire_wave (payload
        # bodies encode once per distinct object via the per-endpoint
        # FrameEncodeMemo, MACs in one batched pass) and enqueues one
        # frame per peer per flush.  The scalar per-post path stays
        # byte-equivalent (tests/test_egress_equivalence.py).
        self._egress_columnar = egress_columnar
        # network-wide egress counters (the send-side twins of the
        # delivery counters above)
        self.frames_encoded = 0
        self.mac_sign_calls = 0
        # test hook (tests/test_egress_equivalence.py): when set,
        # called (sender_id, receiver_id, wire bytes) for every frame
        # at enqueue time — the frame-stream capture the egress
        # byte-equivalence proof compares across arms.  None in all
        # non-test use.
        self.frame_tap: Optional[Callable[[str, str, bytes], None]] = None
        # Seeded WAN emulation plane: when a profile is
        # mounted, every _enqueue prices the frame through a per-link
        # LinkModel (base RTT, jitter, retransmission delay, bandwidth
        # serialization, straggler episodes) into a VIRTUAL-clock
        # delivery deadline.  Undelivered frames wait in _wan_holding
        # — a (ready_at, seq, entry) min-heap invisible to
        # _prepare_wave/_step_wave — until _wan_release moves them to
        # _pending; when the visible queue drains the clock jumps to
        # the next deadline (quantum-coalesced).  The seq tiebreak
        # keeps heap order a pure function of admission order, so a
        # fixed (seed, profile) replays byte-identically.
        self.wan = (
            WanEmulator(wan_profile, seed)
            if wan_profile is not None
            else None
        )
        self._wan_holding: list = []
        self._wan_seq = 0

    # -- topology ----------------------------------------------------------

    def join(
        self,
        node_id: str,
        handler: Handler,
        auth: Optional[Authenticator] = None,
    ) -> None:
        self._endpoints[node_id] = ChannelEndpoint(
            node_id,
            handler,
            auth or NullAuthenticator(),
            encode_memo=(
                FrameEncodeMemo() if self._egress_columnar else None
            ),
        )
        if self.wan is not None:
            self.wan.register(node_id)

    def rebind_handler(self, node_id: str, handler: Handler) -> None:
        self._endpoints[node_id].bind(handler)

    def connect(self, local_id: str, remote_id: str) -> ChannelConnection:
        return ChannelConnection(self, local_id, remote_id)

    def node_ids(self) -> List[str]:
        return sorted(self._endpoints)

    def endpoint_stats(self, node_id: str) -> Dict[str, int]:
        """One endpoint's frame counters, for
        ``Metrics.snapshot()["transport"]`` (the public route to
        ``rejected`` — adversarial tests used to reach through the
        private ``_endpoints`` map for it)."""
        ep = self._endpoints[node_id]
        return {
            "delivered": ep.delivered,
            "rejected": ep.rejected,
            "frames_decoded": ep.frames_decoded,
            "decode_memo_hits": ep.decode_memo_hits,
            "decode_memo_misses": ep.decode_memo_misses,
            "mac_verify_batches": ep.mac_verify_batches,
            "frames_encoded": ep.frames_encoded,
            "encode_memo_hits": ep.encode_memo_hits,
            "encode_memo_misses": ep.encode_memo_misses,
            "mac_sign_batches": ep.mac_sign_batches,
        }

    def delivery_stats(self) -> Dict[str, int]:
        """Network-wide delivery-plane counters (deterministic for a
        seeded schedule): payload decodes executed, Authenticator
        verify invocations, and the shared-prefix memo's hit/miss
        tallies — the numbers bench.py's protocol sections and
        tools/perfgate.py gate on."""
        memo = self._decode_memo
        ehits = emisses = 0
        for ep in self._endpoints.values():
            em = ep.encode_memo
            if em is not None:
                ehits += em.hits
                emisses += em.misses
        return {
            "frames_decoded": self.frames_decoded,
            "mac_verifies": self.mac_verify_calls,
            "decode_memo_hits": 0 if memo is None else memo.hits,
            "decode_memo_misses": 0 if memo is None else memo.misses,
            # egress twins (Config.egress_columnar): payload bodies
            # actually encoded, Authenticator sign invocations, and
            # the per-endpoint encode memos' pooled hit/miss tallies
            "frames_encoded": self.frames_encoded,
            "mac_signs": self.mac_sign_calls,
            "encode_memo_hits": ehits,
            "encode_memo_misses": emisses,
        }

    def link_states(self, node_id: str) -> Dict[str, Dict[str, object]]:
        """``node_id``'s view of every peer link — the
        channel-transport analog of the gRPC dial layer's
        PeerHealthTracker, feeding the SLO watchdog's peer detector
        (the public route to fault state; /healthz must degrade under
        an injected partition on THIS transport too).

        Per peer: ``state`` ("down" when the peer crashed or a
        partition severs the pair; "straggling" when a mounted WAN
        profile has either endpoint inside a slow episode — alive but
        DEGRADED-grade, never DOWN; else "up"), plus the link model's
        ``rtt_ms`` / ``loss`` / ``straggling`` fields (zeroed without
        a WAN profile)."""
        wan = self.wan
        out: Dict[str, Dict[str, object]] = {}
        for peer in sorted(self._endpoints):
            if peer == node_id:
                continue
            down = (
                peer in self._crashed
                or node_id in self._crashed
                or (node_id, peer) in self._partitions
            )
            if wan is None:
                info: Dict[str, object] = {
                    "rtt_ms": 0.0,
                    "loss": 0.0,
                    "straggling": False,
                }
            else:
                info = wan.link_info(node_id, peer)
            state = "down" if down else (
                "straggling" if info["straggling"] else "up"
            )
            info["state"] = state
            out[peer] = info
        return out

    # -- fault injection ---------------------------------------------------

    def crash(self, node_id: str) -> None:
        """Fail-stop: node neither sends nor receives from now on, and
        its in-flight frames are lost NOW (a dead host's socket buffers
        die with it) — so a later restart() cannot resurrect pre-crash
        traffic as ghost deliveries."""
        self._crashed.add(node_id)
        kept = [
            it
            for it in self._pending
            if it[0] != node_id and it[1] != node_id
        ]
        if isinstance(self._pending, collections.deque):
            self._pending = collections.deque(kept)
        else:
            self._pending = kept
        self._unprepared = sum(1 for it in kept if it[4] is None)
        if self._wan_holding:
            # WAN-held frames die with the host's buffers too
            self._wan_holding = [
                (t, s, it)
                for (t, s, it) in self._wan_holding
                if it[0] != node_id and it[1] != node_id
            ]
            heapq.heapify(self._wan_holding)

    def recover(self, node_id: str) -> None:
        """Un-crash, keeping the node's old handler (a blip, not a
        process restart — use restart() for the latter)."""
        self._crashed.discard(node_id)

    def restart(
        self,
        node_id: str,
        handler: Handler,
        auth: Optional[Authenticator] = None,
    ) -> None:
        """Rejoin a crashed node as a restarted PROCESS: fresh handler
        (typically a HoneyBadger rebuilt from its durable batch log),
        same identity, empty inbox — pre-crash frames were dropped at
        crash time.  ``auth`` defaults to the endpoint's existing
        authenticator (key material survives restarts)."""
        self._crashed.discard(node_id)
        ep = self._endpoints.get(node_id)
        if ep is None:
            self.join(node_id, handler, auth)
            return
        if auth is not None:
            ep.auth = auth
        ep.bind(handler)

    def partition(self, a: str, b: str) -> None:
        """Drop all traffic between a and b (both directions)."""
        self._partitions.add((a, b))
        self._partitions.add((b, a))

    def heal(self, a: str, b: str) -> None:
        self._partitions.discard((a, b))
        self._partitions.discard((b, a))

    # -- message flow ------------------------------------------------------

    def _enqueue(self, sender_id: str, receiver_id: str, wire: bytes) -> None:
        self.messages_posted += 1
        self.bytes_posted += len(wire)
        if self.frame_tap is not None:
            self.frame_tap(sender_id, receiver_id, wire)
        entry = [sender_id, receiver_id, wire, False, None]
        if self.wan is not None:
            # WAN admission: the frame is priced into a virtual-clock
            # deadline and held invisible to the scheduler (and to the
            # wave passes) until _wan_release moves it over
            ready_at = self.wan.admit(sender_id, receiver_id, len(wire))
            heapq.heappush(
                self._wan_holding, (ready_at, self._wan_seq, entry)
            )
            self._wan_seq += 1
            return
        self._pending.append(entry)
        self._unprepared += 1

    def _wan_release(self) -> None:
        """Move every WAN-held frame whose deadline the virtual clock
        has passed into the visible pending queue.  When the visible
        queue is empty, the clock first jumps to the earliest held
        deadline plus one delivery quantum — co-deadline frames (an
        RBC echo wave, a broadcast fan-out) land in the same wave
        instead of one wave per float, keeping step counts bounded
        without changing which frames *can* be seen before others."""
        wan, holding = self.wan, self._wan_holding
        if wan is None or not holding:
            return
        if not self._pending and holding[0][0] > wan.now:
            wan.advance(
                holding[0][0] + wan.profile.delivery_quantum_ms / 1e3
            )
        now = wan.now
        while holding and holding[0][0] <= now:
            _, _, entry = heapq.heappop(holding)
            self._pending.append(entry)
            self._unprepared += 1

    def post(self, sender_id: str, receiver_id: str, msg: Message) -> None:
        """Sign, encode and enqueue one message."""
        if sender_id in self._crashed:
            return
        ep = self._endpoints.get(sender_id)
        if ep is not None and self._egress_columnar:
            # single-receiver sends take the SAME wave signer as flush
            # waves: a mid-wave re-send of a
            # payload object the encode memo already holds reuses its
            # encoded body instead of re-encoding the envelope
            self.post_wave(sender_id, (((receiver_id,), msg),))
            return
        if self.pending_count() >= self._queue_capacity:
            raise OverflowError("channel network queue full")
        if ep is None:
            wire = encode_message(msg)  # staticcheck: allow[DET006] non-endpoint test rig
        else:  # sign_wire_many encodes the envelope exactly once
            bodies = payload_body_count(msg.payload)
            ep.frames_encoded += bodies
            ep.mac_sign_batches += 1
            self.frames_encoded += bodies
            self.mac_sign_calls += 1
            frames = ep.auth.sign_wire_many(  # staticcheck: allow[DET006] scalar arm
                msg, [receiver_id]
            )
            wire = frames[receiver_id]
        self._enqueue(sender_id, receiver_id, wire)

    def post_many(
        self, sender_id: str, receiver_ids, msg: Message
    ) -> None:
        """Broadcast enqueue: ONE payload encode for the whole receiver
        set via the authenticator's sign_wire_many fast path (pairwise
        MACs differ per receiver; the envelope bytes do not)."""
        if sender_id in self._crashed:
            return
        ep = self._endpoints.get(sender_id)
        if ep is None:
            for rid in receiver_ids:
                self.post(sender_id, rid, msg)
            return
        if self._egress_columnar:
            self.post_wave(sender_id, ((tuple(receiver_ids), msg),))
            return
        bodies = payload_body_count(msg.payload)
        ep.frames_encoded += bodies
        ep.mac_sign_batches += 1
        self.frames_encoded += bodies
        self.mac_sign_calls += 1
        frames = ep.auth.sign_wire_many(  # staticcheck: allow[DET006] scalar arm
            msg, receiver_ids
        )
        for rid, wire in frames.items():
            if self.pending_count() >= self._queue_capacity:
                raise OverflowError("channel network queue full")
            self._enqueue(sender_id, rid, wire)

    def post_wave(self, sender_id: str, entries) -> None:
        """One egress wave (Config.egress_columnar): ``entries`` are
        ``(receiver_ids, msg)`` pairs — everything one coalescer flush
        ships.  The whole wave signs through the sender endpoint's
        ``Authenticator.sign_wire_wave`` (payload bodies encode once
        per distinct object via the per-endpoint FrameEncodeMemo, MACs
        in one batched pass over the precomputed pair-key schedules)
        and enqueues in one pass — one frame per peer per flush, since
        the coalescer already folded each receiver's wave into a
        single bundle.  Admission is atomic: the wave is rejected
        whole when it would overflow the queue, so a coalescer retry
        never double-posts a partially shipped wave."""
        if sender_id in self._crashed:
            return
        ep = self._endpoints.get(sender_id)
        if ep is None:
            for rids, msg in entries:
                for rid in rids:
                    self.post(sender_id, rid, msg)
            return
        need = sum(len(rids) for rids, _msg in entries)
        if self.pending_count() + need > self._queue_capacity:
            raise OverflowError("channel network queue full")
        tr = getattr(ep.handler, "trace", None)
        t0 = 0.0 if tr is None else tr.now()
        frames_list, hits, misses, bodies = sign_wave_counted(
            ep.auth,
            [(msg, rids) for rids, msg in entries],
            ep.encode_memo,
        )
        ep.mac_sign_batches += 1
        self.mac_sign_calls += 1
        ep.encode_memo_hits += hits
        ep.encode_memo_misses += misses
        ep.frames_encoded += bodies
        self.frames_encoded += bodies
        if tr is not None:
            # ONE span per egress wave (mirror of the ingest
            # frame_decode span): args carry the wave's bundle count
            # and the encode memo's hit tally, tools/tracetool.py
            # rolls them into the delivery summary
            tr.complete(
                "transport",
                "frame_encode",
                t0,
                frames=len(entries),
                memo_hits=hits,
            )
        for (rids, _msg), frames in zip(entries, frames_list):
            for rid in rids:
                self._enqueue(sender_id, rid, frames[rid])

    def pending_count(self) -> int:
        """In-flight frames: scheduler-visible plus WAN-held."""
        return len(self._pending) + len(self._wan_holding)

    def _prepare_wave(self) -> None:
        """Columnar arm: decode (shared-prefix memoized) and
        MAC-verify every not-yet-prepared pending frame — ONE
        ``verify_wire_many`` batch per receiver per wave.  A wave is
        whatever the previous handler turns posted since the last
        pass; the scheduler then delivers prepared frames in its usual
        (FIFO or seeded) order, so the interleaving semantics are
        untouched.  Skipped entirely while a fault_filter is mounted:
        tampering adversaries must see — and re-verify — the exact
        delivered bytes (the scalar per-frame path below)."""
        self._unprepared = 0
        todo: Dict[str, list] = {}
        crashed, partitions = self._crashed, self._partitions
        for it in self._pending:
            # frames the delivery checks would drop anyway (crashed
            # ends, severed pairs) must not burn digest+decode+MAC
            # work here or skew the delivery counters — the scalar arm
            # checks these before ever decoding.  A frame skipped now
            # that becomes deliverable later (heal/recover) falls to
            # the scalar per-frame path at pop time.
            if (
                it[4] is None
                and it[1] not in crashed
                and it[0] not in crashed
                and (it[0], it[1]) not in partitions
            ):
                todo.setdefault(it[1], []).append(it)
        memo = self._decode_memo
        for receiver in sorted(todo):  # deterministic endpoint order
            ep = self._endpoints.get(receiver)
            if ep is None:
                continue
            msgs, prefixes, good = [], [], []
            tr = getattr(ep.handler, "trace", None)
            t0 = 0.0 if tr is None else tr.now()
            wave_hits0 = memo.hits
            attempts = 0
            for it in todo[receiver]:
                attempts += 1
                h0 = memo.hits
                try:
                    msg, prefix = decode_frame_shared(it[2], memo)
                except ValueError:
                    it[4] = (None, "undecodable")
                    continue
                if memo.hits > h0:
                    ep.decode_memo_hits += 1
                else:
                    ep.decode_memo_misses += 1
                    ep.frames_decoded += 1
                    self.frames_decoded += 1
                msgs.append(msg)
                prefixes.append(prefix)
                good.append(it)
            if tr is not None and attempts:
                # ONE span per receiver per wave (a per-frame span at
                # N=64 is ~350k events/run — it would overflow the
                # trace ring and distort the attribution it feeds):
                # args carry the wave's decode-attempt and memo-hit
                # counts, tools/tracetool.py rolls them up
                tr.complete(
                    "transport",
                    "frame_decode",
                    t0,
                    frames=attempts,
                    memo_hits=memo.hits - wave_hits0,
                )
            if not msgs:
                continue
            self.mac_verify_calls += 1
            ep.mac_verify_batches += 1
            t0 = 0.0 if tr is None else tr.now()
            oks = ep.auth.verify_wire_many(msgs, prefixes)
            if tr is not None:
                tr.complete(
                    "transport",
                    "mac_verify_batch",
                    t0,
                    batch_width=len(msgs),
                )
            for it, msg, ok in zip(good, msgs, oks):
                it[4] = (msg, True) if ok else (None, "bad_mac")

    def _step_wave(self) -> bool:
        """Wave-routing delivery (Config.wave_routing): ONE step
        drains the entire pending queue — one message wave, everything
        the previous handler turns posted — bucketing verified frames
        per receiver in scheduler pop order, then hands each receiver
        its bundle in a single ``serve_wave`` call (the WaveRouter
        demuxes it into typed ingest columns; one batch handler
        dispatch per message kind).  Receivers fire in sorted-id order
        (the idle_phase discipline); messages their handlers post form
        the NEXT wave.  Frames a mounted fault_filter must see — and
        frames the wave pass skipped (crashed/severed at prepare time)
        — decode and verify through the per-frame scalar path, but
        still JOIN the receiver's wave, so the router seam stays
        exercised under wire-fault schedules."""
        if not self._pending:
            return False
        if self.fault_filter is None and self._unprepared:
            self._prepare_wave()
        waves: Dict[str, List[Message]] = {}
        while self._pending:
            if self._rng is None:
                item = self._pending.popleft()
            else:
                idx = self._rng.randrange(len(self._pending))
                item = self._pending[idx]
                self._pending[idx] = self._pending[-1]
                self._pending.pop()
            sender, receiver, wire, prefiltered, prepared = item
            if prepared is None and self._unprepared > 0:
                self._unprepared -= 1
            if receiver in self._crashed or sender in self._crashed:
                continue
            if (sender, receiver) in self._partitions:
                continue
            ep = self._endpoints.get(receiver)
            if ep is None:
                continue
            if prepared is not None and self.fault_filter is None:
                # cached pre-wave verdict — only usable while NO
                # filter is mounted: a filter mounted mid-run (with
                # prepared frames still in flight) must see and
                # re-verify the exact delivered bytes, exactly like
                # the scalar arm re-filters prepared entries
                msg, verdict = prepared
                if verdict is not True:
                    ep.rejected += 1
                    self._trace_rejected(ep, sender, verdict)
                    continue
            else:
                if self.fault_filter is not None and not prefiltered:
                    maybe = self.fault_filter(sender, receiver, wire)
                    if maybe is None:
                        continue
                    if isinstance(maybe, list):
                        if not maybe:
                            continue
                        wire = maybe[0]
                        # injected duplicates re-enter pending (never
                        # re-filtered); the drain loop folds them into
                        # this wave's tail — dedup absorbs them like
                        # any replay
                        for extra in maybe[1:]:
                            if len(self._pending) < self._queue_capacity:
                                self._pending.append(
                                    [sender, receiver, extra, True, None]
                                )
                                self._unprepared += 1
                    else:
                        wire = maybe
                try:
                    msg, signing_prefix = decode_frame(
                        wire, payload_memo=self._payload_memo
                    )
                except ValueError:
                    ep.rejected += 1
                    self._trace_rejected(ep, sender, "undecodable")
                    continue
                ep.frames_decoded += 1
                self.frames_decoded += 1
                ep.mac_verify_batches += 1
                self.mac_verify_calls += 1
                if not ep.auth.verify_wire(msg, signing_prefix):
                    ep.rejected += 1
                    self._trace_rejected(ep, sender, "bad_mac")
                    continue
            ep.delivered += 1
            wave = waves.get(receiver)
            if wave is None:
                waves[receiver] = [msg]
            else:
                wave.append(msg)
        for receiver in sorted(waves):
            ep = self._endpoints.get(receiver)
            serve_wave = getattr(ep.handler, "serve_wave", None)
            if serve_wave is not None:
                serve_wave(waves[receiver])
            else:
                for m in waves[receiver]:
                    # handler without wave ingest: per-frame fallback
                    ep.handler.serve_request(m)  # staticcheck: allow[DET004] non-wave fallback
        return True

    def step(self) -> bool:
        """Deliver one message (or, in wave-routing mode, one whole
        wave); returns False if none pending.

        Delivery order: FIFO without a seed, seeded-uniform-random with
        one — every run with the same seed replays the identical
        interleaving.

        Manual driving contract: handlers joined to this network defer
        outbound bundles and batched crypto to idle callbacks, so a
        caller looping ``step()`` directly MUST call ``idle_phase()``
        whenever ``step()`` returns False (and keep going if new
        messages appear) — exactly what ``run()`` does — or buffered
        work strands and the protocol stalls without error.
        """
        if self.wan is not None:
            self._wan_release()
        if self._wave_routing:
            return self._step_wave()
        columnar = self._columnar and self.fault_filter is None
        if columnar and self._unprepared:
            self._prepare_wave()
        while self._pending:
            if self._rng is None:
                item = self._pending.popleft()
            else:
                idx = self._rng.randrange(len(self._pending))
                item = self._pending[idx]
                self._pending[idx] = self._pending[-1]
                self._pending.pop()
            sender, receiver, wire, prefiltered, prepared = item
            if prepared is None and self._unprepared > 0:
                # frames skipped by a wave pass (crashed receiver)
                # deliver through the scalar fallback below
                self._unprepared -= 1
            if receiver in self._crashed or sender in self._crashed:
                continue
            if (sender, receiver) in self._partitions:
                continue
            ep = self._endpoints.get(receiver)
            if columnar and prepared is not None:
                # pre-waved frame: decode + MAC verdict already batched
                if ep is None:
                    continue
                msg, verdict = prepared
                if verdict is not True:
                    ep.rejected += 1
                    self._trace_rejected(ep, sender, verdict)
                    continue
                ep.delivered += 1
                ep.handler.serve_request(msg)  # staticcheck: allow[DET004] scalar comparison arm
                return True
            if self.fault_filter is not None and not prefiltered:
                maybe = self.fault_filter(sender, receiver, wire)
                if maybe is None:
                    continue
                if isinstance(maybe, list):
                    if not maybe:
                        continue
                    wire = maybe[0]
                    # duplicates / injections: deliver later WITHOUT
                    # re-filtering (a filtered frame re-entering the
                    # filter would branch exponentially)
                    for extra in maybe[1:]:
                        if len(self._pending) < self._queue_capacity:
                            self._pending.append(
                                [sender, receiver, extra, True, None]
                            )
                            self._unprepared += 1
                else:
                    wire = maybe
            if ep is None:
                continue
            try:
                msg, signing_prefix = decode_frame(
                    wire, payload_memo=self._payload_memo
                )
            except ValueError:
                ep.rejected += 1
                self._trace_rejected(ep, sender, "undecodable")
                continue
            ep.frames_decoded += 1
            self.frames_decoded += 1
            ep.mac_verify_batches += 1
            self.mac_verify_calls += 1
            if not ep.auth.verify_wire(msg, signing_prefix):
                # the implemented version of conn.go:134-137's TODO
                ep.rejected += 1
                self._trace_rejected(ep, sender, "bad_mac")
                continue
            ep.delivered += 1
            ep.handler.serve_request(msg)  # staticcheck: allow[DET004] scalar comparison arm
            return True
        return False

    @staticmethod
    def _trace_rejected(ep: ChannelEndpoint, sender: str, why: str) -> None:
        """One trace instant per rejected frame (when the receiving
        handler carries a flight recorder): adversarial tampering shows
        up in tracetool reports instead of only in a counter."""
        tr = getattr(ep.handler, "trace", None)
        if tr is not None:
            tr.instant("transport", "rejected", sender=sender, why=why)

    def idle_phase(self) -> None:
        """The pending queue drained: give every live endpoint its idle
        callback (deferred batched crypto + outbound bundle flush).
        Deterministic order — endpoints fire sorted by node id."""
        for node_id in sorted(self._endpoints):
            if node_id in self._crashed:
                continue
            ep = self._endpoints[node_id]
            if ep.on_idle is not None:
                ep.on_idle()
            elif ep.flush_outbound is not None:
                ep.flush_outbound()

    def run(
        self, max_steps: int = 10_000_000, deadline_s: Optional[float] = None
    ) -> int:
        """Deliver until quiescent (handlers may enqueue more while we
        drain).  Returns the number of delivery steps — one per
        message, or one per WAVE in wave-routing mode (``max_steps``
        bounds the same unit).

        Quiescence is two-level: when the pending queue drains, every
        endpoint gets its idle callback (running deferred crypto and
        flushing coalesced bundles); only when TWO consecutive idle
        phases produce no new traffic is the network done.  The second
        pass is the stall-watchdog window (protocol plane's
        ``_maybe_chase_stall``): a handler can only recognize "no
        inbound since my previous idle callback" on an idle that
        FOLLOWS the quiet one, so a single-pass exit would always
        terminate one callback too early for it to fire.  For handlers
        without a watchdog the extra pass flushes nothing and is
        behaviorally inert.
        """
        t0 = time.monotonic()
        steps = 0
        quiet_idles = 0
        while steps < max_steps:
            if deadline_s is not None and time.monotonic() - t0 > deadline_s:
                break
            if self.step():
                steps += 1
                quiet_idles = 0
                continue
            self.idle_phase()
            if not self._pending:
                if self._wan_holding:
                    # quiescent wall-side but WAN-held frames remain:
                    # the next step() advances the virtual clock to
                    # their deadline instead of declaring the network
                    # drained
                    continue
                quiet_idles += 1
                if quiet_idles >= 2:
                    break
            else:
                quiet_idles = 0
        return steps


__all__ = [
    "ChannelNetwork",
    "ChannelConnection",
    "ChannelEndpoint",
    "FaultFilter",
]
