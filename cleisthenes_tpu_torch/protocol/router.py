"""WaveRouter: one batch handler dispatch per message kind per wave.

Columnar delivery cut the delivery plane's decode+MAC work (4688->533
frames, 4688->308 verifies per seeded n16 epoch) and the transport
stage share did not move — because the remaining mass is per-payload
handler dispatch: each decoded frame still walked the
``HoneyBadger.serve_request -> _serve_payload -> ACS.handle_message ->
RBC/BBA.handle_message`` Python call chain one payload at a time.

This module is the inbound twin of the outbound wave work at the
ROUTING layer.  A transport in wave mode hands the router one delivery
wave's already-decoded, already-MAC-verified frames in a single
``serve_wave`` call; the router demuxes every payload in one pass into
typed ingest columns keyed by ``(message kind, epoch)`` and then makes
ONE batch handler invocation per (kind, wave) into the ``*_wave()``
entry points on ACS (which write EchoBank/VoteBank slots wholesale)
and the dec-share wave handler on HoneyBadger.  Stale/future-epoch
filtering happens once per column against the demux window instead of
once per payload; far-ahead traffic still feeds the CATCHUP renudge
counter payload-by-payload, so the traffic-clocked retry cadence is
identical to the scalar arm's.

The scalar ``handle_message`` chain stays live behind
``Config.wave_routing=False`` as the byte-equivalence comparison arm
(tests/test_delivery_equivalence.py): same seeded schedule, either
routing discipline, byte-identical committed ledgers.

Ordering contract: within a wave, columns dispatch in first-occurrence
order of their (kind, epoch) key — deterministic given the transport's
(seeded or FIFO) delivery order, independent of PYTHONHASHSEED.
CATCHUP payloads are order-sensitive barriers: the router flushes the
columns accumulated so far, dispatches the catch-up payload through
the scalar chain, and keeps demuxing — catch-up traffic is rare, so a
steady-state wave is one flush.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from cleisthenes_tpu_torch.protocol.honeybadger import (
    _logical_count as _logical,
)
from cleisthenes_tpu_torch.transport.message import (
    BbaBatchPayload,
    BbaPayload,
    BundlePayload,
    CatchupOrdPayload,
    CatchupReqPayload,
    CatchupRespPayload,
    CoinBatchPayload,
    CoinPayload,
    DecShareBatchPayload,
    DecSharePayload,
    EchoBatchPayload,
    LanePayload,
    RbcPayload,
    RbcType,
    ReadyBatchPayload,
    ResharePayload,
)

# the scalar chain handles these outside the epoch demux entirely
# (CATCHUP state transfer + reconfig gossip: epoch-unscoped, rare,
# and order-sensitive relative to the columns around them)
_CATCHUP_PAYLOADS = (
    CatchupReqPayload,
    CatchupRespPayload,
    CatchupOrdPayload,
    ResharePayload,
)

# kind tags (the router's column vocabulary); dispatch happens in
# first-occurrence order of (kind, epoch), never in tag order
_K_VAL = "val"
_K_ECHO = "echo"
_K_READY = "ready"
_K_VOTE = "vote"
_K_COIN = "coin"
_K_DEC = "dec"


class WaveRouter:
    """Per-node demux of delivery waves into typed ingest columns.

    Owned by (and coupled to) one HoneyBadger: the router reads the
    node's epoch window through ``_epoch_state`` and dispatches into
    the same protocol objects the scalar chain reaches — it changes
    HOW MANY Python calls carry a wave, never what state they write.

    Lock audit: deliberately unlocked.  The router holds no
    mutable state of its own (``__slots__`` is one back-pointer) and
    ``serve_wave``/``route`` run only on the dispatcher thread that
    serializes ALL protocol mutation; a ``@guarded_by`` here would
    declare a lock no second thread can ever contend.  The
    interprocedural sweep (CONC003/CONC004) confirms: no ``*_locked``
    callee and no blocking call is reachable from ``route``.
    """

    __slots__ = ("_hb",)

    def __init__(self, hb) -> None:
        self._hb = hb

    def route(self, msgs) -> None:
        """Demux one wave of verified Messages and dispatch each
        (kind, epoch) column once."""
        hb = self._hb
        metrics = hb.metrics
        metrics.waves_routed.inc()
        tr = hb.trace
        t0 = 0.0 if tr is None else tr.now()
        d0 = metrics.handler_dispatches.value if tr is not None else 0
        # (kind, epoch) -> item column, first-occurrence order (dicts
        # preserve insertion order; keys are tuples of str/int, so the
        # composition is PYTHONHASHSEED-independent)
        cols: Dict[Tuple[str, int], List] = {}
        logical = 0
        n_payloads = 0
        for msg in msgs:
            sender = msg.sender_id
            payload = msg.payload
            if payload.__class__ is BundlePayload:
                items = payload.items
            else:
                items = (payload,)
            for p in items:
                n_payloads += 1
                logical += _logical(p)
                if not self._demux(cols, sender, p):
                    # order-sensitive barrier (CATCHUP): flush what
                    # accumulated, scalar-dispatch, keep demuxing
                    self._dispatch_all(cols)
                    cols = {}
                    hb._serve_payload(sender, p)
        metrics.msgs_in.inc(logical)
        self._dispatch_all(cols)
        if tr is not None:
            tr.complete(
                "router",
                "route",
                t0,
                frames=len(msgs),
                payloads=n_payloads,
                dispatches=metrics.handler_dispatches.value - d0,
            )

    # -- demux -------------------------------------------------------------

    def _demux(self, cols, sender: str, p) -> bool:
        """Append one payload to its (kind, epoch) column — or, for a
        lane-wrapped payload (Config.lanes > 1), to its
        (kind, epoch, lane) column; False when the payload is an
        ordering barrier the caller must flush for."""
        cls = p.__class__
        lane = 0
        if cls is LanePayload:
            lane = p.lane
            if not (0 < lane < len(self._hb.lanes)):
                return True  # unknown lane: drop, like the scalar arm
            p = p.inner
            cls = p.__class__
            if cls in _CATCHUP_PAYLOADS:
                # barrier: the scalar chain demuxes the WRAPPED
                # payload into the sibling (route() passes the
                # original payload object)
                return False
        if cls is BbaBatchPayload:
            item = (sender, p.type, p.round, p.value, p.proposers)
            key = (_K_VOTE, p.epoch)
        elif cls is CoinBatchPayload:
            item = (sender, p.round, p.index, p.proposers, p.d, p.e, p.z)
            key = (_K_COIN, p.epoch)
        elif cls is EchoBatchPayload:
            item = (
                sender, p.shard_index, p.proposers, p.roots,
                p.branches, p.shards,
            )
            key = (_K_ECHO, p.epoch)
        elif cls is ReadyBatchPayload:
            item = (sender, p.proposers, p.roots)
            key = (_K_READY, p.epoch)
        elif cls is DecShareBatchPayload or cls is DecSharePayload:
            item = (sender, p)
            key = (_K_DEC, p.epoch)
        elif cls is RbcPayload:
            t = p.type
            if t == RbcType.ECHO:
                item = (
                    sender, p.shard_index, (p.proposer,),
                    (p.root_hash,), (p.branch,), (p.shard,),
                )
                key = (_K_ECHO, p.epoch)
            elif t == RbcType.READY:
                item = (sender, (p.proposer,), (p.root_hash,))
                key = (_K_READY, p.epoch)
            else:  # VAL: bulky one-per-instance payloads stay scalar
                item = (sender, p)
                key = (_K_VAL, p.epoch)
        elif cls is BbaPayload:
            item = (sender, p.type, p.round, p.value, (p.proposer,))
            key = (_K_VOTE, p.epoch)
        elif cls is CoinPayload:
            item = (
                sender, p.round, p.index, (p.proposer,),
                (p.d,), (p.e,), (p.z,),
            )
            key = (_K_COIN, p.epoch)
        elif cls in _CATCHUP_PAYLOADS:
            return False
        else:  # unknown/epochless payloads drop, like the scalar arm
            return True
        if lane:
            # lane columns stay distinct but ride the SAME wave: one
            # route() pass, one _dispatch_all — S lanes' traffic per
            # wave without S× routing passes
            key = key + (lane,)
        col = cols.get(key)
        if col is None:
            cols[key] = [item]
        else:
            col.append(item)
        return True

    # -- dispatch ----------------------------------------------------------

    def _dispatch_all(self, cols) -> None:
        for key, items in cols.items():
            if len(key) == 3:  # (kind, epoch, lane): a sibling's column
                sib = self._hb.lanes[key[2]]
                sib._idle_rx += len(items)  # its stall-watchdog clock
                sib._router._dispatch(key[0], key[1], items)
            else:
                self._dispatch(key[0], key[1], items)

    def _dispatch(self, kind: str, epoch: int, items) -> None:
        """One column = one handler invocation (the counter perfgate
        gates).  The demux window is checked HERE — column granularity
        — because an earlier column's dispatch may advance the epoch
        frontier mid-wave, exactly like a handler turn does on the
        scalar arm."""
        hb = self._hb
        es = hb._epochs.get(epoch) or hb._epoch_state(epoch)
        if es is None:  # outside the sliding window, or not a member
            if epoch > hb.epoch + hb.EPOCH_HORIZON or (
                epoch > hb.epoch
                and not hb.roster_for(epoch).local
            ):
                # per-payload sightings: the CATCHUP renudge cadence
                # is counted in payloads, and must tick identically
                # under either routing arm (the second arm is the
                # dynamic-membership joiner watching epochs it cannot
                # participate in run ahead of its adopted frontier)
                for _ in items:
                    hb._note_farahead()
            return
        metrics = hb.metrics
        if kind == _K_DEC:
            metrics.handler_dispatches.inc()
            hb._handle_dec_share_wave(epoch, es, items)
            return
        acs = es.acs
        if acs is None:
            # settle-only state (two-frontier mode): consensus traffic
            # for it is stale by definition
            return
        # the K-deep follow window (== {hb.epoch} at depth 1); the
        # predicate and RNG-order discipline are the owner's, shared
        # with the scalar arm so the two can never drift apart
        hb.maybe_follow_epoch(epoch, es)
        metrics.handler_dispatches.inc()
        if kind == _K_VOTE:
            acs.handle_vote_wave(items)
        elif kind == _K_ECHO:
            acs.handle_echo_wave(items)
        elif kind == _K_READY:
            acs.handle_ready_wave(items)
        elif kind == _K_COIN:
            acs.handle_coin_wave(items)
        else:  # _K_VAL
            for sender, p in items:
                acs.handle_message(sender, p)


__all__ = ["WaveRouter"]
