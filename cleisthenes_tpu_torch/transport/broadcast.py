"""Payload-level broadcast seam between protocol instances and transport.

The reference's protocol structs hold a ``cleisthenes.Broadcaster``
(reference rbc/rbc.go:35, bba/bba.go:60) and never touch gRPC directly;
this module is that seam for payloads: the protocol layer emits typed
payloads, the broadcaster wraps them in the authenticated envelope and
hands them to a concrete transport.

``broadcast`` includes the sending node itself: HBBFT quorum counting
treats the local node as a normal peer (its own ECHO/READY/BVAL votes
count), and routing self-delivery through the same transport keeps the
deterministic scheduler in charge of *all* message interleavings.
"""

from __future__ import annotations

import time
from typing import (
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    runtime_checkable,
)

from cleisthenes_tpu_torch.transport.message import (
    BbaBatchPayload,
    BbaPayload,
    BundlePayload,
    CoinBatchPayload,
    CoinPayload,
    DecShareBatchPayload,
    DecSharePayload,
    EchoBatchPayload,
    LanePayload,
    Message,
    Payload,
    RbcPayload,
    RbcType,
    ReadyBatchPayload,
)


@runtime_checkable
class PayloadBroadcaster(Protocol):
    def broadcast(self, payload: Payload) -> None: ...

    def send_to(self, member_id: str, payload: Payload) -> None: ...


class ChannelBroadcaster:
    """PayloadBroadcaster over an in-proc ChannelNetwork.

    Envelope signing happens inside the network at post time (each
    endpoint's Authenticator), mirroring the reference where the conn
    layer owns signatures (conn.go:134-137's intent)."""

    def __init__(self, network, node_id: str, member_ids: Sequence[str]):
        self._network = network
        self._node_id = node_id
        self._members: List[str] = sorted(member_ids)

    def set_members(self, member_ids: Sequence[str]) -> None:
        """Swap the broadcast target set (dynamic membership: the
        roster at an activation boundary; CoalescingBroadcaster
        propagates its own set_members here)."""
        self._members = sorted(member_ids)

    def _wrap(self, payload: Payload) -> Message:
        return Message(
            sender_id=self._node_id, timestamp=time.time(), payload=payload
        )

    def broadcast(self, payload: Payload) -> None:
        self._network.post_many(
            self._node_id, self._members, self._wrap(payload)
        )

    def send_to(self, member_id: str, payload: Payload) -> None:
        self._network.post(self._node_id, member_id, self._wrap(payload))

    def post_wave(self, entries) -> None:
        """One egress wave (Config.egress_columnar): ``entries`` are
        ``(member_id | None, payload)`` pairs — None addresses the full
        broadcast set.  The whole wave crosses into the network in ONE
        call, where the sender endpoint's ``sign_wire_wave`` encodes
        each distinct body once and MACs the wave in one batched
        pass."""
        wave = [
            (
                self._members if member_id is None else (member_id,),
                self._wrap(payload),
            )
            for member_id, payload in entries
        ]
        self._network.post_wave(self._node_id, wave)


def _columnarize(buf: List[Payload]) -> List[Payload]:
    """Merge a wave buffer's per-instance runs into columnar payloads.

    One wave makes a node emit the same logical message across many
    concurrent instances — N BVAL(v)s, N coin shares, N dec shares,
    N READYs differing only in per-instance fields.  Grouping by the
    shared key (first-occurrence order, so the merge is deterministic)
    turns O(N) bundle items into one columnar item each: both wire
    bytes and the receiver's per-item decode/dispatch drop by ~N.
    Singleton groups stay scalar; VAL/ECHO (bulky per-instance data)
    and sync payloads pass through unchanged.
    """
    groups: dict = {}
    order: List[tuple] = []
    for p in buf:
        cls = p.__class__
        # lane shard-out: a lane's runs merge under a
        # lane-prefixed key — the merged column re-wraps below, so S
        # lanes' traffic columnarizes exactly as lane 0's does and
        # still shares the one bundle per (receiver, wave)
        lane = 0
        q = p
        if cls is LanePayload:
            lane = p.lane
            q = p.inner
            cls = q.__class__
        if cls is BbaPayload:
            key = ("b", q.type, q.epoch, q.round, q.value)
        elif cls is CoinPayload:
            key = ("c", q.epoch, q.round, q.index)
        elif cls is DecSharePayload:
            key = ("d", q.epoch, q.index)
        elif cls is RbcPayload and q.type is RbcType.READY:
            key = ("r", q.epoch)
        elif cls is RbcPayload and q.type is RbcType.ECHO:
            # one turn's ECHO fan-out shares the sender's shard slot
            # (it echoes the VALs it received, all at its own index)
            key = ("e", q.epoch, q.shard_index)
        else:
            key = ("solo", len(order))  # preserves position, no merge
        if lane and key[0] != "solo":
            key = ("L", lane) + key
        if key in groups:
            groups[key].append(p)
        else:
            groups[key] = [p]
            order.append(key)
    out: List[Payload] = []
    for key in order:
        run = groups[key]
        if len(run) == 1:
            out.append(run[0])
            continue
        lane = 0
        if key[0] == "L":
            lane = key[1]
            key = key[2:]
            run = [p.inner for p in run]
        tag = key[0]
        if tag == "b":
            p0 = run[0]
            col = BbaBatchPayload(
                p0.type, p0.epoch, p0.round, p0.value,
                tuple(p.proposer for p in run),
            )
        elif tag == "c":
            p0 = run[0]
            col = CoinBatchPayload(
                p0.epoch, p0.round, p0.index,
                tuple(p.proposer for p in run),
                tuple(p.d for p in run),
                tuple(p.e for p in run),
                tuple(p.z for p in run),
            )
        elif tag == "d":
            p0 = run[0]
            col = DecShareBatchPayload(
                p0.epoch, p0.index,
                tuple(p.proposer for p in run),
                tuple(p.d for p in run),
                tuple(p.e for p in run),
                tuple(p.z for p in run),
            )
        elif tag == "r":
            p0 = run[0]
            col = ReadyBatchPayload(
                p0.epoch,
                tuple(p.proposer for p in run),
                tuple(p.root_hash for p in run),
            )
        else:  # "e"
            p0 = run[0]
            col = EchoBatchPayload(
                p0.epoch,
                p0.shard_index,
                tuple(p.proposer for p in run),
                tuple(p.root_hash for p in run),
                tuple(p.branch for p in run),
                tuple(p.shard for p in run),
            )
        out.append(LanePayload(lane, col) if lane else col)
    return out


class CoalescingBroadcaster:
    """Per-receiver outbound buffering in front of any PayloadBroadcaster.

    HBBFT's traffic is O(N^2) broadcast waves of tiny payloads: within
    one protocol turn a node emits one ECHO/READY/BVAL/AUX/coin/share
    per concurrent instance, all to the same N receivers.  Buffering
    them and flushing ONE ``BundlePayload`` envelope per receiver per
    wave amortizes the envelope encode + MAC + frame decode + verify to
    one per (sender, receiver, wave) instead of one per payload — the
    coalescing lever identified as the wall between the
    N=16 measurement and the BASELINE N=64/128 metric (the reference's
    per-message cost model: docs/HONEYBADGER-EN.md:93-96).

    ``flush()`` is called by the owner at wave boundaries (a transport
    idle callback, or the end of a handler turn).  When every buffered
    payload since the last flush was a broadcast, all receivers' bundles
    are byte-identical and the flush takes the inner broadcaster's
    broadcast fast path (one envelope encode, per-receiver MACs only —
    transport.base.Authenticator.sign_wire_many).
    """

    def __init__(
        self,
        inner,
        member_ids: Sequence[str],
        trace=None,
        egress_columnar: bool = False,
    ) -> None:
        self._inner = inner
        self._members: List[str] = sorted(member_ids)
        # Config.egress_columnar: hand each flush's whole wave of
        # folded bundles to the inner broadcaster in ONE post_wave
        # call — the transport signs it through one
        # Authenticator.sign_wire_wave pass (shared-prefix
        # FrameEncodeMemo, batched MACs) and writes one frame per peer
        # per flush.  Falls back to the scalar per-post path when the
        # inner broadcaster has no wave entry point (bare test
        # broadcasters).
        self._egress_wave = (
            egress_columnar and getattr(inner, "post_wave", None) is not None
        )
        # Broadcast payloads buffer ONCE on a shared list (a wave is
        # ~50k broadcasts at N=64; appending each to N per-receiver
        # buffers was ~1 s of epoch wall).  send_to payloads park per
        # receiver as (anchor, payload), anchor = the shared-list
        # position they arrived at, so the flush can reconstruct each
        # receiver's exact arrival-order interleaving.
        self._shared: List[Payload] = []
        self._extras: Dict[str, List[tuple]] = {
            m: [] for m in self._members
        }
        self._dirty = False
        self._broadcast_only = True  # no send_to since last flush
        self.bundles_flushed = 0
        self.payloads_buffered = 0
        # flight recorder (utils/trace.py): each flush records one
        # "transport/flush" span covering fold + envelope encode + MAC
        # + post for the wave.  None = tracing off.
        self.trace = trace

    def set_members(self, member_ids: Sequence[str]) -> None:
        """Swap the receiver set at a roster-activation boundary
        (dynamic membership).  Flushes buffered payloads FIRST — they
        belong to waves addressed under the outgoing roster — then
        rebuilds the per-receiver buffers and propagates to the inner
        broadcaster when it exposes ``set_members`` (the in-proc
        ChannelBroadcaster; the gRPC pool derives its receiver set
        from dialed connections instead)."""
        self.flush()
        self._members = sorted(member_ids)
        self._extras = {m: [] for m in self._members}
        inner_set = getattr(self._inner, "set_members", None)
        if inner_set is not None:
            inner_set(self._members)

    def broadcast(self, payload: Payload) -> None:
        self._shared.append(payload)
        self.payloads_buffered += len(self._members)
        self._dirty = True

    def send_to(self, member_id: str, payload: Payload) -> None:
        buf = self._extras.get(member_id)
        if buf is None:  # not a roster member: pass through untouched
            self._inner.send_to(member_id, payload)
            return
        buf.append((len(self._shared), payload))
        self.payloads_buffered += 1
        self._dirty = True
        self._broadcast_only = False

    @staticmethod
    def _fold(buf: List[Payload]) -> Payload:
        if len(buf) == 1:
            return buf[0]
        items = _columnarize(buf)
        return items[0] if len(items) == 1 else BundlePayload(tuple(items))

    def flush(self) -> None:
        """Ship every buffered payload.  Exception-safe: a transport
        failure mid-flush (queue overflow, missing pair key) re-marks
        the unsent buffers dirty and re-raises, so the next flush
        retries instead of silently stranding a wave's bundles."""
        if not self._dirty:
            return
        tr = self.trace
        if tr is None:
            self._flush_dirty()
            return
        t0 = tr.now()
        bundles0 = self.bundles_flushed
        payloads = len(self._shared) * len(self._members) + sum(
            len(b) for b in self._extras.values()
        )
        try:
            self._flush_dirty()
        finally:
            tr.complete(
                "transport",
                "flush",
                t0,
                bundles=self.bundles_flushed - bundles0,
                payloads=payloads,
            )

    def _merged(self, shared: List[Payload], extras: List[tuple]):
        """One receiver's arrival-order payload list: extras spliced
        back at their anchors (anchors are nondecreasing)."""
        out: List[Payload] = []
        i = 0
        for anchor, p in extras:
            if i < anchor:
                out.extend(shared[i:anchor])
                i = anchor
            out.append(p)
        out.extend(shared[i:])
        return out

    def _flush_dirty(self) -> None:
        self._dirty = False
        broadcast_only = self._broadcast_only
        self._broadcast_only = True
        if broadcast_only:
            # every receiver's bundle is the shared list by
            # construction: one fold, one envelope for all
            shared = self._shared
            if shared:
                try:
                    folded = self._fold(shared)
                    if self._egress_wave:
                        # whole wave in ONE transport call: the wave
                        # signer encodes the envelope once and MACs
                        # all receivers in one batched pass
                        self._inner.post_wave([(None, folded)])
                    else:
                        self._inner.broadcast(folded)
                except Exception:
                    self._dirty = True
                    self._broadcast_only = broadcast_only
                    raise
                self._shared = []
                self.bundles_flushed += len(self._members)
            return
        if self._egress_wave:
            self._flush_mixed_wave()
            return
        # mixed wave (rare: VAL fan-outs, CATCHUP serves): materialize
        # every receiver's merged view FIRST, then post — a transport
        # failure mid-loop must leave unsent members' payloads
        # buffered for the retry, already merged (anchor 0: they
        # precede anything buffered later)
        shared, merged = self._merged_views()
        for mi, m in enumerate(self._members):
            buf = merged.get(m)
            if not buf:
                continue
            try:
                self._inner.send_to(m, self._fold(buf))
            except Exception:
                for m2 in self._members[mi:]:
                    left = merged.get(m2)
                    if left:
                        self._extras[m2] = [(0, p) for p in left]
                self._dirty = True
                self._broadcast_only = False
                raise
            self.bundles_flushed += 1

    def _merged_views(
        self,
    ) -> Tuple[List[Payload], Dict[str, List[Payload]]]:
        """Pop the wave's buffers into every receiver's arrival-order
        merged view (shared between the scalar mixed path and the
        columnar wave path, so the two byte-equivalence arms cannot
        diverge here).  Receivers with no extras ALIAS the shared
        list — never mutated downstream; the columnar path keys on
        that identity to fold it once."""
        shared, self._shared = self._shared, []
        merged: Dict[str, List[Payload]] = {}
        for m in self._members:
            extras = self._extras[m]
            if extras:
                self._extras[m] = []
                merged[m] = self._merged(shared, extras)
            elif shared:
                merged[m] = shared  # never mutated below
        return shared, merged

    def _flush_mixed_wave(self) -> None:
        """Mixed-wave columnar flush (Config.egress_columnar): every
        receiver's merged bundle ships in ONE ``post_wave`` call.
        Receivers whose bundle is exactly the shared broadcast run
        share one folded payload OBJECT, so the transport's
        FrameEncodeMemo collapses their envelope bodies to a single
        encode; per-receiver merges (VAL fan-outs, CATCHUP serves,
        injected per-receiver lies) fold individually but still share
        their sub-payload objects with the run.  A transport failure
        re-parks every receiver's merged view for the retry, exactly
        like the scalar mixed path."""
        shared, merged = self._merged_views()
        entries: List[tuple] = []
        shared_fold: Optional[Payload] = None
        for m in self._members:
            buf = merged.get(m)
            if not buf:
                continue
            if buf is shared:
                if shared_fold is None:
                    shared_fold = self._fold(shared)
                entries.append((m, shared_fold))
            else:
                entries.append((m, self._fold(buf)))
        if not entries:
            return
        try:
            self._inner.post_wave(entries)
        except Exception:
            for m, buf in merged.items():
                if buf:
                    self._extras[m] = [(0, p) for p in buf]
            self._dirty = True
            self._broadcast_only = False
            raise
        self.bundles_flushed += len(entries)


__all__ = ["PayloadBroadcaster", "ChannelBroadcaster", "CoalescingBroadcaster"]
