"""ValidatorHost: one HBBFT validator over the gRPC transport.

Bundles what an embedding application wires by hand in the reference
(its README's server/client/pool snippets): a GrpcServer accepting
peer streams, dialed client connections to every roster member, and
the HoneyBadger node — plus the piece the reference gets from Go's
runtime for free: a per-node *serial dispatcher*.  gRPC gives every
peer stream its own reader thread, but the protocol state machines are
single-threaded actors (the reference muxes everything through
reqChan loops, bba/bba.go:113-123); ``SerialDispatcher`` is that actor
loop at node level — every inbound message and every local command
funnels through one worker thread, so protocol code never needs locks.

Self-delivery bypasses the network: a node's own broadcasts are
enqueued straight onto its dispatcher (the in-proc transport routes
them through the scheduler instead; both count the node as a normal
quorum member).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from cleisthenes_tpu_torch.config import Config
from cleisthenes_tpu_torch.core.batch import Batch
from cleisthenes_tpu_torch.protocol.honeybadger import HoneyBadger, NodeKeys
from cleisthenes_tpu_torch.transport.base import (
    ConnectionPool,
    HmacAuthenticator,
    sign_wave_counted,
)
from cleisthenes_tpu_torch.transport.grpc_net import (
    DialOpts,
    GrpcClient,
    GrpcConnection,
    GrpcServer,
)
from cleisthenes_tpu_torch.transport.health import (
    Backoff,
    PeerHealthTracker,
    backoff_rng,
)
from cleisthenes_tpu_torch.transport.message import (
    FrameEncodeMemo,
    Message,
    Payload,
    payload_body_count,
)
from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_lock
from cleisthenes_tpu_torch.utils.log import NodeLogger


class _Wave:
    """One delivery wave riding the dispatcher mailbox as a SINGLE
    actor message (Config.wave_routing): the gRPC verify loop hands a
    whole verified burst over in one queue entry instead of N."""

    __slots__ = ("msgs",)

    def __init__(self, msgs: List[Message]) -> None:
        self.msgs = msgs


class SerialDispatcher:
    """Node-level actor loop: serializes message dispatch and local
    commands onto one worker thread (the node's reqChan)."""

    def __init__(self, name: str = "dispatch") -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._handler = None
        self._on_idle = None
        # flight recorder (utils/trace.py), set by the owning host
        # AFTER construction; only the worker thread records (the
        # producer-side serve_request never touches it).  None = off.
        self.trace = None
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._stopped = threading.Event()
        self._thread.start()

    def bind(self, handler) -> None:
        self._handler = handler
        # the dispatcher's empty-mailbox check is a real quiescence
        # point (all queued work processed), so handlers that batch
        # crypto/outbound by wave get their idle callback there
        from cleisthenes_tpu_torch.transport.base import wire_idle_hooks

        _, self._on_idle = wire_idle_hooks(handler)

    # transport Handler interface: called from gRPC reader threads
    def serve_request(self, msg: Message) -> None:
        if not self._stopped.is_set():
            self._q.put(msg)

    def serve_wave(self, msgs: List[Message]) -> None:
        """Wave ingest (Config.wave_routing): enqueue one verified
        delivery wave as ONE mailbox entry — the worker hands it to
        the bound handler's serve_wave (the WaveRouter seam) in a
        single call."""
        if msgs and not self._stopped.is_set():
            self._q.put(_Wave(msgs))

    def call(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the dispatch thread (local commands mutate
        protocol state, so they take the same door as messages)."""
        if not self._stopped.is_set():
            self._q.put(fn)

    def call_sync(self, fn: Callable[[], object], timeout: float = 30.0):
        """``call`` and wait for the result (for inspection APIs)."""
        if self._stopped.is_set():
            raise RuntimeError("dispatcher stopped")
        done = threading.Event()
        box: List[object] = []

        def run():
            try:
                box.append(fn())
            finally:
                done.set()

        self.call(run)
        if not done.wait(timeout):
            raise TimeoutError("dispatcher stalled")
        return box[0] if box else None

    def drain(self, timeout: float = 30.0) -> None:
        """Block until everything queued so far has been processed."""
        self.call_sync(lambda: None, timeout=timeout)

    def _loop(self) -> None:
        served = 0
        depth_peak = 0
        while not self._stopped.is_set():
            item = self._q.get()
            if item is None:
                return
            width = 1
            try:
                if callable(item):
                    item()
                elif isinstance(item, _Wave):
                    width = len(item.msgs)
                    handler = self._handler
                    if handler is not None:
                        serve_wave = getattr(handler, "serve_wave", None)
                        if serve_wave is not None:
                            serve_wave(item.msgs)
                        else:  # non-wave handler bound: per-frame
                            for m in item.msgs:
                                handler.serve_request(m)  # staticcheck: allow[DET004] fallback
                elif self._handler is not None:
                    self._handler.serve_request(item)  # staticcheck: allow[DET004] scalar arm
            except Exception:
                # a poisoned message must not kill the node's actor
                import traceback

                traceback.print_exc()
            tr = self.trace
            if tr is not None:
                served += width
                # backlog BEHIND the item just processed: the depth
                # signal (at the drain point itself it is 0 by
                # definition, so sample per item and report the peak)
                backlog = self._q.qsize()
                if backlog > depth_peak:
                    depth_peak = backlog
                if backlog == 0:
                    # mailbox drained: one wave's worth of items plus
                    # the deepest backlog observed during the wave
                    tr.instant(
                        "transport",
                        "queue_depth",
                        msgs=served,
                        depth=depth_peak,
                    )
                    served = 0
                    depth_peak = 0
            if self._on_idle is not None and self._q.empty():
                # mailbox drained: wave boundary (a racing producer
                # just means an extra flush later — never a lost one,
                # since its message re-triggers this check)
                try:
                    self._on_idle()
                except Exception:
                    import traceback

                    traceback.print_exc()

    def stop(self) -> None:
        self._stopped.set()
        self._q.put(None)

    def join(self, timeout: float = 10.0) -> None:
        """Wait for the worker to finish the item it is serving."""
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)


@guarded_by("_lock", "_ready", "_pending")
class GrpcPayloadBroadcaster:
    """PayloadBroadcaster over dialed peer connections + local
    short-circuit (transport.broadcast.ChannelBroadcaster's gRPC twin).

    Broadcasts sign+encode ONCE and fan the identical wire frame to
    every peer (signing_bytes is deterministic, so per-connection
    re-signing would produce the same bytes n-1 times)."""

    def __init__(
        self,
        node_id: str,
        pool: ConnectionPool,
        local: SerialDispatcher,
        auth,
        egress_columnar: bool = False,
    ) -> None:
        self._node_id = node_id
        self._pool = pool
        self._local = local
        self._auth = auth
        # until connect() finishes, the pool is incomplete: park
        # outbound traffic instead of silently dropping it for peers
        # not dialed yet (protocol messages are sent exactly once)
        self._ready = False
        self._pending: List = []
        self._lock = new_lock()
        # Columnar egress (Config.egress_columnar): the coalescer
        # hands each flush's whole wave to post_wave, which signs it
        # in ONE Authenticator.sign_wire_wave pass (payload bodies
        # encode once per distinct object via the encode memo, MACs
        # batched over the precomputed pair schedules) and makes one
        # stream write per peer per flush (the wave already folds to
        # one bundle per receiver).  Counters are the egress twins of
        # the connection-side delivery counters, folded into
        # Metrics.snapshot()["transport"] by the host.
        self._encode_memo = (
            FrameEncodeMemo() if egress_columnar else None
        )
        self.frames_encoded = 0
        self.encode_memo_hits = 0
        self.encode_memo_misses = 0
        self.mac_sign_batches = 0

    def mark_ready(self) -> None:
        with self._lock:
            self._ready = True
            pending, self._pending = self._pending, []
        for member_id, msg in pending:
            self._deliver(member_id, msg)

    def _wrap(self, payload: Payload) -> Message:
        return Message(
            sender_id=self._node_id, timestamp=time.time(), payload=payload
        )

    def _deliver(self, member_id: Optional[str], msg: Message) -> None:
        """member_id None = broadcast to all peers."""
        self.frames_encoded += payload_body_count(msg.payload)
        self.mac_sign_batches += 1
        if member_id is None:
            # pairwise MACs: each peer gets its own signed frame (one
            # key per peer — the sign-once/fan-out-identical-bytes path
            # would need a key every peer shares, exactly the forgeable
            # design ADVICE.md retired).  The envelope is encoded once;
            # only the 32-byte MAC differs per frame.
            conns = self._pool.get_all()
            frames = self._auth.sign_wire_many(  # staticcheck: allow[DET006] scalar arm
                msg, [c.id() for c in conns]
            )
            for conn in conns:
                conn.send_wire(frames[conn.id()])
        else:
            self._pool.send_to(member_id, msg)

    def post_wave(self, entries) -> None:
        """One egress wave (Config.egress_columnar): ``entries`` are
        ``(member_id | None, payload)`` pairs — one coalescer flush.
        The whole wave signs in ONE ``sign_wire_wave`` pass and ships
        as one stream write per peer per flush; local self-delivery
        short-circuits through the dispatcher exactly like the scalar
        arm, but only AFTER the fallible sign pass — a sign failure
        re-parks the wave in the coalescer, and serving local first
        would double-deliver the node's own payloads on the retry.
        Before the dial pool completes, the WHOLE wave parks per
        receiver in one pass and re-delivers scalar on mark_ready
        (boot-time traffic is a handful of frames; parking all-or-
        nothing keeps a mid-wave failure from re-parking entries the
        pending list already holds)."""
        msgs = [
            (member_id, self._wrap(payload))
            for member_id, payload in entries
        ]
        with self._lock:
            ready = self._ready
            if not ready:
                for member_id, msg in msgs:
                    if member_id != self._node_id:
                        self._pending.append((member_id, msg))
        if not ready:
            # scalar parity: local delivery never waits on the pool
            for member_id, msg in msgs:
                if member_id is None or member_id == self._node_id:
                    self._local.serve_request(msg)  # staticcheck: allow[DET004] self-delivery
            return
        wave: List = []  # (msg, receiver_ids, conns)
        local: List[Message] = []
        for member_id, msg in msgs:
            if member_id is None:
                conns = self._pool.get_all()
                wave.append((msg, [c.id() for c in conns], conns))
                local.append(msg)
            elif member_id == self._node_id:
                local.append(msg)
            else:
                conn = self._pool.get(member_id)
                if conn is not None:
                    wave.append((msg, [member_id], [conn]))
        if wave:
            tr = getattr(self._local, "trace", None)
            t0 = 0.0 if tr is None else tr.now()
            frames_list, hits, misses, bodies = sign_wave_counted(
                self._auth,
                [(msg, rids) for msg, rids, _conns in wave],
                self._encode_memo,
            )
            self.mac_sign_batches += 1
            self.encode_memo_hits += hits
            self.encode_memo_misses += misses
            self.frames_encoded += bodies
            if tr is not None:
                tr.complete(
                    "transport",
                    "frame_encode",
                    t0,
                    frames=len(wave),
                    memo_hits=hits,
                )
            for (_msg, _rids, conns), frames in zip(wave, frames_list):
                for conn in conns:
                    conn.send_wire(frames[conn.id()])
        for msg in local:
            self._local.serve_request(msg)  # staticcheck: allow[DET004] local self-delivery

    def _post(self, member_id: Optional[str], msg: Message) -> None:
        with self._lock:
            if not self._ready:
                self._pending.append((member_id, msg))
                return
        self._deliver(member_id, msg)

    def broadcast(self, payload: Payload) -> None:
        msg = self._wrap(payload)
        self._post(None, msg)
        self._local.serve_request(msg)  # staticcheck: allow[DET004] local self-delivery

    def send_to(self, member_id: str, payload: Payload) -> None:
        msg = self._wrap(payload)
        if member_id == self._node_id:
            self._local.serve_request(msg)  # staticcheck: allow[DET004] local self-delivery
        else:
            self._post(member_id, msg)


@guarded_by(
    "_closed_stats_lock",
    "_closed_delivered",
    "_closed_rejected",
    "_closed_decoded",
    "_closed_batches",
)
class ValidatorHost:
    """One validator process: server + peer dials + HoneyBadger node."""

    def __init__(
        self,
        config: Config,
        node_id: str,
        member_ids: Sequence[str],
        keys: NodeKeys,
        listen_addr: str = "127.0.0.1:0",
        auto_propose: bool = True,
        batch_log_path: Optional[str] = None,
        behavior=None,
        joining: bool = False,
        roster_version_base: int = 0,
    ) -> None:
        self.config = config
        self.node_id = node_id
        self.members = sorted(member_ids)
        self.keys = keys
        self._joining = joining
        self._addrs: Dict[str, str] = {}
        self._stopping = threading.Event()
        # per-member dial backoffs persist across redial loops so a
        # flapping link keeps its capped schedule instead of being
        # re-probed from base on every transient success (see
        # Backoff.note_lost); guarded by _backoffs_lock
        self._backoffs: Dict[str, Backoff] = {}
        self._backoffs_lock = new_lock()
        # redial threads started so far, joined by stop(); guarded by
        # _backoffs_lock
        self._redials: List[threading.Thread] = []
        self.log = NodeLogger(node_id, "host")
        # inbound verification looks up the pair key by sender id, so
        # one authenticator verifies all peers; signing is bound to
        # (node_id, receiver) pairs
        if config.attested_log:
            from cleisthenes_tpu_torch.protocol.attest import (
                AttestationDirectory,
                AttestingAuthenticator,
            )

            # each host holds its OWN simulated TEE NVRAM (one sealed
            # counter store per machine); fork evidence against peers
            # aggregates locally and surfaces through attest_stats
            self.attest_dir = AttestationDirectory()
            self._auth = AttestingAuthenticator(
                node_id, keys.mac_keys, self.attest_dir.attach(node_id)
            )
        else:
            self.attest_dir = None
            self._auth = HmacAuthenticator(node_id, keys.mac_keys)
        self.dispatcher = SerialDispatcher(name=f"dispatch-{node_id}")
        self.server = GrpcServer(
            listen_addr,
            self._auth,
            capacity=config.channel_capacity,
            delivery_columnar=config.delivery_columnar,
            wave_routing=config.wave_routing,
        )
        self.server.on_conn(self._accept)
        self.pool = ConnectionPool()
        self._client = GrpcClient(
            self._auth,
            delivery_columnar=config.delivery_columnar,
            wave_routing=config.wave_routing,
        )
        # frame counters of dialed streams that have since been lost:
        # folded in at loss time so the transport metric stays
        # cumulative across self-healing redials
        self._closed_stats_lock = new_lock()
        self._closed_delivered = 0
        self._closed_rejected = 0
        self._closed_decoded = 0
        self._closed_batches = 0
        # per-peer UP/DEGRADED/DOWN + reconnect counters + the recent
        # backoff schedule (proof the dial layer is not spinning)
        self.health = PeerHealthTracker(
            p for p in self.members if p != node_id
        )
        self.out = GrpcPayloadBroadcaster(
            node_id,
            self.pool,
            self.dispatcher,
            self._auth,
            egress_columnar=config.egress_columnar,
        )
        batch_log = None
        if batch_log_path is not None:
            from cleisthenes_tpu_torch.core.ledger import BatchLog

            batch_log = BatchLog(batch_log_path, fsync=config.ledger_fsync)
        # peers retired by a RECONFIG: redial loops check the set and
        # cancel; guarded by the health tracker's own lock discipline
        # (writes happen on the dispatch thread, reads on dial threads
        # via PeerHealthTracker.is_retired)
        self.node = HoneyBadger(
            config=config,
            node_id=node_id,
            member_ids=self.members,
            keys=keys,
            out=self.out,
            auto_propose=auto_propose,
            batch_log=batch_log,
            # semantic-adversary seam (protocol.byzantine): the same
            # behavior objects the in-proc cluster mounts run over real
            # gRPC — a lie per receiver, each frame validly MAC'd
            behavior=behavior,
            authenticator=self._auth,
            joining=joining,
            roster_version_base=roster_version_base,
        )
        # dynamic-membership transport hooks: a discovered joiner gets
        # a dial lane (the redial loop completes its CATCHUP on
        # success); a torn-down retiree stops being dialed
        self.node.on_peer_added = self.add_peer
        self.node.on_peer_retired = self.retire_peer
        self.node.metrics.set_transport_health(self.health.snapshot)
        self.node.metrics.set_transport_stats(self._transport_stats)
        # SLO watchdogs (utils/watchdog.py) run on every host: alert
        # counters fold into Metrics.snapshot()["alerts"] whether or
        # not the scrape endpoints are enabled.  Peer states come from
        # the dial layer's health tracker.
        from cleisthenes_tpu_torch.utils.watchdog import SloWatchdog

        self.watchdog = SloWatchdog(
            metrics=self.node.metrics,
            pending_fn=self.node.outstanding_tx_count,
            stall_factor=config.slo_stall_factor,
            stall_grace_s=config.slo_stall_grace_s,
            queue_depth_limit=config.slo_queue_depth,
            peer_lag_epochs=config.slo_peer_lag_epochs,
            peer_states_fn=self._peer_states,
            decrypt_lag_budget=config.decrypt_lag_max,
            trace=self.node.trace,
        )
        self.node.metrics.set_alerts(self.watchdog.alerts_block)
        # live telemetry endpoints (Config.obs_port): bounded-ring
        # sampler + localhost /metrics | /healthz | /vars.  Built here,
        # started by listen() next to the gRPC server.
        self.sampler = None
        self.obs = None
        if config.obs_port is not None:
            from cleisthenes_tpu_torch.transport.obs_http import (
                ObsServer,
                ObsTarget,
            )
            from cleisthenes_tpu_torch.utils.timeseries import TimeSeriesSampler

            self.sampler = TimeSeriesSampler(self.node.metrics.snapshot)
            self.sampler.on_tick(self.watchdog.check)
            self.obs = ObsServer(
                [
                    ObsTarget(
                        node_id,
                        self.node.metrics,
                        self.watchdog,
                        self.sampler,
                    )
                ],
                port=config.obs_port,
            )
        # client ingress plane (Config.ingress_port): the untrusted
        # submit/subscribe surface (transport/ingress.py), fronted by
        # the fee-priority mempool the node mounted above.  Built
        # here, bound by listen() next to the validator server.
        self.ingress = None
        self.ingress_server = None
        if config.ingress_port is not None:
            from cleisthenes_tpu_torch.transport.ingress import (
                IngressGrpcServer,
                IngressPlane,
            )

            # post-admission nudge: an idle node starts an epoch for
            # fresh client work (start_epoch no-ops mid-epoch, so the
            # kick is an enqueue + cheap check, never a double propose)
            self.ingress = IngressPlane(
                self.node,
                on_admitted=lambda: self.dispatcher.call(
                    self.node.start_epoch
                ),
            )
            self.ingress_server = IngressGrpcServer(
                self.ingress, f"127.0.0.1:{config.ingress_port}"
            )
        # the dispatcher records queue-depth/wave events on the node's
        # own timeline (same worker thread as all protocol code)
        self.dispatcher.trace = self.node.trace
        self.dispatcher.bind(self.node)
        self._commits: "queue.Queue" = queue.Queue()
        self.node.on_commit = lambda epoch, batch: self._commits.put(
            (epoch, batch)
        )

    def _peer_states(self) -> Dict[str, str]:
        """Peer UP/DEGRADED/DOWN states for the SLO watchdog's peer
        detector (the dial layer's health snapshot, states only)."""
        return {
            peer: str(ph["state"])
            for peer, ph in self.health.snapshot().items()
        }

    def _transport_stats(self) -> Dict[str, int]:
        """Inbound frame counters across every stream this host EVER
        read (server-accepted + dialed, live + lost), for
        ``Metrics.snapshot()["transport"]`` — cumulative across
        redials, like GrpcServer.stats."""
        stats = self.server.stats()
        delivered = stats["delivered"]
        rejected = stats["rejected"]
        decoded = stats["frames_decoded"]
        batches = stats["mac_verify_batches"]
        with self._closed_stats_lock:  # see _on_conn_lost: atomic
            delivered += self._closed_delivered
            rejected += self._closed_rejected
            decoded += self._closed_decoded
            batches += self._closed_batches
            conns = self.pool.get_all()
        for conn in conns:
            delivered += getattr(conn, "delivered", 0)
            rejected += getattr(conn, "rejected", 0)
            decoded += getattr(conn, "frames_decoded", 0)
            batches += getattr(conn, "mac_verify_batches", 0)
        return {
            "delivered": delivered,
            "rejected": rejected,
            "frames_decoded": decoded,
            "mac_verify_batches": batches,
            # egress twins (Config.egress_columnar): the payload
            # broadcaster owns the outbound signer seam, so its
            # counters are already host-cumulative
            "frames_encoded": self.out.frames_encoded,
            "encode_memo_hits": self.out.encode_memo_hits,
            "encode_memo_misses": self.out.encode_memo_misses,
            "mac_sign_batches": self.out.mac_sign_batches,
        }

    # -- lifecycle ---------------------------------------------------------

    def _accept(self, conn: GrpcConnection) -> None:
        """Server-side stream accepted: route into the dispatcher
        (the reference's connHandler contract, comm.go:47-49)."""
        conn.handle(self.dispatcher)
        conn.start()

    def listen(self) -> str:
        self.server.listen()
        addr = f"127.0.0.1:{self.server.port}"
        self.log.info("listening", addr=addr)
        if self.obs is not None:
            port = self.obs.start()
            self.sampler.start(self.config.obs_sample_period_s)
            self.log.info("obs endpoints up", addr=f"127.0.0.1:{port}")
        if self.ingress_server is not None:
            self.ingress_server.listen()
            self.log.info(
                "ingress up",
                addr=f"127.0.0.1:{self.ingress_server.port}",
            )
        return addr

    def connect(
        self, addrs: Dict[str, str], deadline_s: float = 10.0
    ) -> None:
        """Dial every other roster member, retrying with capped
        exponential backoff until deadline (peers boot concurrently).
        Buffered outbound traffic flushes once the pool is complete."""
        missing = set(self.members) - {self.node_id} - set(addrs)
        if missing:  # config error: fail fast, don't spin the retry loop
            raise ValueError(f"no address for roster members {sorted(missing)}")
        self._addrs = dict(addrs)
        t0 = time.monotonic()
        for member in self.members:
            if member == self.node_id:
                continue
            backoff = self._backoff_for(member)
            while True:
                try:
                    self._dial_member(member)
                    break
                except Exception:
                    if time.monotonic() - t0 > deadline_s:
                        raise
                    delay = backoff.next_delay()
                    self.health.dial_scheduled(member, delay)
                    # interruptible like _redial_loop's wait: stop()
                    # must not block behind a capped-backoff sleep
                    if self._stopping.wait(delay):
                        raise
        self.out.mark_ready()
        self.log.info("connected", peers=len(self.pool))
        if self.node.epoch > 0 or self._joining:
            # restarted from a durable log — or a JOINER bootstrapping
            # into a running roster: peers may have committed epochs
            # we missed — catch up before proposing
            self.dispatcher.call(self.node.request_catchup)

    def _backoff_for(self, member: str) -> Backoff:
        """One dial lane's backoff: Config policy + seeded jitter (the
        jitter de-synchronizes a roster all redialing the same dead
        peer; the seed keeps fault tests replayable).

        The instance PERSISTS across redial loops: a flapping WAN link
        (dial lands, stream dies before ``stability_s``) continues the
        capped schedule rather than restarting from base on every
        transient success — re-arming is stability-gated in
        ``Backoff.note_lost``."""
        with self._backoffs_lock:
            b = self._backoffs.get(member)
            if b is None:
                b = self._backoffs[member] = Backoff(
                    self.config.dial_retry_base_s,
                    self.config.dial_retry_max_s,
                    rng=backoff_rng(
                        self.config.seed, self.node_id, member
                    ),
                )
            return b

    def _dial_member(self, member: str):
        """Single dial attempt; raises on failure (retry policy is the
        caller's — connect()'s deadline loop or the redial loop).
        Returns the pooled connection."""
        self.health.dial_started(member)
        try:
            conn = self._client.dial(
                DialOpts(
                    self._addrs[member],
                    timeout_s=self.config.dial_timeout_s,
                    capacity=self.config.channel_capacity,
                    conn_id=member,  # pool addressed by member
                )
            )
        except Exception:
            self.health.dial_failed(member)
            raise
        conn.handle(self.dispatcher)
        # a broken stream prunes itself from the pool and redials in
        # the background (messages sent while down are lost; HBBFT's
        # f-tolerance covers short outages, reconnection restores the
        # peer for later epochs).  Chain the dial-layer close hook
        # (it cancels the underlying gRPC call).
        cancel_call = conn._on_close
        conn._on_close = lambda c, m=member, cc=cancel_call: (
            cc(c) if cc else None,
            self._on_conn_lost(m, c),
        )
        conn.start()
        self.pool.add(conn)
        self.health.connected(member)
        self._backoff_for(member).note_connected()
        return conn

    def _on_conn_lost(self, member: str, conn) -> None:
        # fold the dying stream's frame counters into the cumulative
        # tally — the transport metric must stay monotonic across
        # self-healing redials (GrpcServer.stats does the same for
        # accepted conns).  Fold and pool-removal happen under ONE
        # lock, and _transport_stats reads under the same lock, so a
        # concurrent snapshot never sees the conn both folded and
        # live (lock order everywhere: _closed_stats_lock -> pool)
        with self._closed_stats_lock:
            self._closed_delivered += getattr(conn, "delivered", 0)
            self._closed_rejected += getattr(conn, "rejected", 0)
            self._closed_decoded += getattr(conn, "frames_decoded", 0)
            self._closed_batches += getattr(conn, "mac_verify_batches", 0)
            self.pool.remove(member)
        self.health.stream_lost(member)
        self._backoff_for(member).note_lost()
        self.log.warning("peer stream lost", peer=member)
        if self._stopping.is_set() or self.health.is_retired(member):
            return  # a retired peer's lost stream stays lost
        self._start_redial(member)

    def _start_redial(self, member: str) -> None:
        t = threading.Thread(
            target=self._redial_loop,
            args=(member,),
            name=f"redial-{self.node_id}-{member}",
            daemon=True,
        )
        with self._backoffs_lock:
            self._redials = [r for r in self._redials if r.is_alive()]
            self._redials.append(t)
        t.start()

    def _redial_loop(self, member: str) -> None:
        """Self-healing redial: capped exponential backoff with seeded
        jitter (Config.dial_retry_base_s/_max_s), waking early on
        stop().  Health transitions UP -> DEGRADED -> DOWN ride the
        dial attempts (transport/health.py)."""
        backoff = self._backoff_for(member)
        while not self._stopping.is_set():
            if self.health.is_retired(member):
                # peer left the roster while we were backing off:
                # cancel the loop — a retired host must not keep
                # absorbing this roster's redial storms
                return
            try:
                conn = self._dial_member(member)
            except Exception:
                delay = backoff.next_delay()
                self.health.dial_scheduled(member, delay)
                if self._stopping.wait(delay):
                    return
                continue
            if self._stopping.is_set() or self.health.is_retired(
                member
            ):  # stop()/retirement raced the dial
                self.pool.remove(member)
                conn.close()
                return
            # the path to this peer just healed: anything we served it
            # while the link was down is gone — complete its
            # interrupted catch-up (no-op if it never asked)
            self.dispatcher.call(
                lambda m=member: self.node.peer_reconnected(m)
            )
            return

    def add_peer(self, member: str, addr: str) -> None:
        """Dynamic membership: open a dial lane to a discovered
        JOINER.  The redial loop dials with the standard capped
        backoff until the joiner's server answers, then fires
        ``peer_reconnected`` — which serves the joiner's standing
        CATCHUP-from-0 request, completing its bootstrap."""
        if member == self.node_id or self._stopping.is_set():
            return
        # an id retired by an EARLIER reconfig may be re-admitted by
        # a later one: lift the retirement before the dial loop's
        # is_retired checks would cancel it
        self.health.readmit(member)
        if member not in self.members:
            self.members = sorted(set(self.members) | {member})
        self._addrs[member] = addr
        if self.pool.get(member) is not None:
            return  # already connected
        self._start_redial(member)

    def retire_peer(self, member: str) -> None:
        """Dynamic membership: the peer left the roster and every
        pre-boundary epoch is settled.  Tear down its dial state —
        the backoff loop cancels, the pooled stream closes, and its
        health row drops from ``transport_health`` — so a retired
        host stops generating redial storms the moment its duties
        end."""
        self.health.retire(member)
        with self._backoffs_lock:
            self._backoffs.pop(member, None)
        self._addrs.pop(member, None)
        if member in self.members:
            self.members = sorted(set(self.members) - {member})
        conn = self.pool.get(member)
        if conn is not None:
            self.pool.remove(member)
            conn.close()
        self.log.info("peer retired", peer=member)

    def stop(self, timeout: float = 10.0) -> None:
        """Shut the host down and join every thread it started: the
        streams' reader and ingest threads, the redial loops, the
        sampler, the telemetry server and the dispatcher (each join
        bounded by ``timeout``)."""
        self._stopping.set()
        if self.ingress_server is not None:
            self.ingress_server.stop()
        if self.sampler is not None:
            self.sampler.stop()
        if self.obs is not None:
            self.obs.stop()
        dialed = self.pool.get_all()
        accepted = self.server.stop()
        self._client.close()
        for conn in dialed:
            # closing cancels the stream's call too (the client's channel
            # list shrinks under close() as the streams end)
            conn.close()
        for conn in dialed + accepted:
            conn.join(timeout)
        with self._backoffs_lock:
            redials = list(self._redials)
        for t in redials:
            t.join(timeout)
        self.dispatcher.stop()
        self.dispatcher.join(timeout)
        if self.node.batch_log is not None:
            self.node.batch_log.close()

    # -- application API ---------------------------------------------------

    def submit(self, tx: bytes) -> None:
        self.node.add_transaction(tx)  # queue is internally locked

    def propose(self) -> None:
        self.dispatcher.call(self.node.start_epoch)

    def wait_commit(self, timeout: float = 30.0):
        """Block for the next committed (epoch, Batch)."""
        return self._commits.get(timeout=timeout)

    def committed_batches(self) -> List[Batch]:
        return self.dispatcher.call_sync(
            lambda: list(self.node.committed_batches)
        )

    def pending_tx_count(self) -> int:
        return self.node.pending_tx_count()


__all__ = [
    "SerialDispatcher",
    "GrpcPayloadBroadcaster",
    "ValidatorHost",
]
