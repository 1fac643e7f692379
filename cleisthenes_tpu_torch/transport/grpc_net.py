"""gRPC network transport: the reference's comm.go/stream.go.

Topology preserved from the reference: ONE full-duplex bidi stream per
peer pair (reference pb/message.proto:7-9 ``MessageStream``), a server
that wraps every inbound stream into a ``Connection`` and hands it to
an ``on_conn`` callback (comm.go:37-51), a client that dials with a
timeout and returns a ``Connection`` (comm.go:107-140), and per-
connection reader/writer actors with a bounded outbound mailbox
(conn.go:60-77,104-180 — goroutines become threads; the mailbox depth
is Config.channel_capacity, the reference's 200-deep chan).

Differences, both deliberate:
- Frames on the wire are the self-contained codec of
  transport.message (encode_message bytes) carried as raw gRPC
  messages via the generic-handler API — no generated protobuf stubs,
  byte-identical frames to the in-proc channel transport, same MACs.
- ``verify`` is real (Authenticator seam), completing the reference's
  TODO (conn.go:134-137); unverifiable frames are counted and dropped.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence

import grpc

from cleisthenes_tpu_torch.config import (
    DEFAULT_CHANNEL_CAPACITY,
    DEFAULT_DIAL_TIMEOUT_S,
)
from cleisthenes_tpu_torch.transport.base import (
    Authenticator,
    Handler,
    NullAuthenticator,
)
from cleisthenes_tpu_torch.transport.message import (
    Message,
    decode_frame,
    encode_message,
)
from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_lock

SERVICE_NAME = "cleisthenes.StreamService"
METHOD_NAME = "MessageStream"
_FULL_METHOD = f"/{SERVICE_NAME}/{METHOD_NAME}"

_identity = lambda b: b  # raw-bytes (de)serializer  # noqa: E731

_CLOSE = object()  # outbound-queue sentinel


class GrpcConnection:
    """Per-peer actor (reference conn.go:40-180).

    ``send`` enqueues onto a bounded mailbox consumed by the stream's
    writer; ``start`` runs the reader loop that decodes, verifies and
    dispatches inbound frames to the registered Handler."""

    def __init__(
        self,
        inbound,  # iterator of wire bytes
        auth: Authenticator,
        capacity: int = DEFAULT_CHANNEL_CAPACITY,
        conn_id: Optional[str] = None,
        on_close: Optional[Callable[["GrpcConnection"], None]] = None,
        delivery_columnar: bool = False,
        wave_routing: bool = False,
    ) -> None:
        self._inbound = inbound
        self._auth = auth
        self._out: "queue.Queue" = queue.Queue(maxsize=capacity)
        self._conn_id = conn_id or str(uuid.uuid4())  # comm.go:46
        self._handler: Optional[Handler] = None
        self._closed = threading.Event()
        self._reader: Optional[threading.Thread] = None
        # the columnar path's stream -> queue thread (set by the reader)
        self._ingest: Optional[threading.Thread] = None
        self._on_close = on_close
        # Config.delivery_columnar: the reader splits into an ingest
        # thread (stream -> queue) and a verify loop that drains the
        # queue's backlog per pass — one message wave — and MACs it
        # through ONE Authenticator.verify_wire_many call.
        self._columnar = delivery_columnar
        # Config.wave_routing: the verified wave dispatches as ONE
        # handler call (SerialDispatcher.serve_wave — one actor
        # mailbox entry per wave, not N) instead of one serve_request
        # per frame.  Rides the columnar verify loop.
        self._wave_routing = wave_routing and delivery_columnar
        self.delivered = 0
        self.rejected = 0
        # delivery-plane counters (Metrics.snapshot()["transport"])
        self.frames_decoded = 0
        self.mac_verify_batches = 0

    # -- Connection interface (conn.go:31-38) ------------------------------

    def id(self) -> str:
        return self._conn_id

    def handle(self, handler: Handler) -> None:
        self._handler = handler

    def send(
        self,
        msg: Message,
        on_success: Optional[Callable[[Message], None]] = None,
        on_err: Optional[Callable[[Exception], None]] = None,
    ) -> None:
        """conn.go:66-77: enqueue with callbacks; full mailbox or a
        closed connection surfaces through on_err."""
        try:
            # the pool addresses client connections by roster member id
            # (host.py DialOpts conn_id=member), so conn_id names the
            # receiver for the pairwise MAC
            signed = self._auth.sign(msg, self._conn_id)
            wire = encode_message(signed)  # staticcheck: allow[DET006] scalar arm / pre-pool path
        except Exception as exc:
            if on_err is not None:
                on_err(exc)
            return
        if self.send_wire(wire, on_err=on_err) and on_success is not None:
            on_success(msg)

    def send_wire(
        self,
        wire: bytes,
        on_err: Optional[Callable[[Exception], None]] = None,
    ) -> bool:
        """Enqueue pre-signed wire bytes (the broadcast fast path:
        sign+encode once, fan the identical frame to every peer)."""
        if self._closed.is_set():
            if on_err is not None:
                on_err(ConnectionError("connection closed"))
            return False
        try:
            self._out.put_nowait(wire)
            return True
        except queue.Full as exc:
            if on_err is not None:
                on_err(exc)
            return False

    def start(self) -> None:
        """conn.go:104-128: spawn the reader; the writer is the
        outbound iterator consumed by gRPC itself."""
        if self._reader is not None:
            return
        self._reader = threading.Thread(
            target=self._read_loop, name=f"conn-read-{self._conn_id[:8]}",
            daemon=True,
        )
        self._reader.start()

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        try:  # best-effort wakeup; outbound() also polls the flag
            self._out.put_nowait(_CLOSE)
        except queue.Full:
            pass
        if self._on_close is not None:
            self._on_close(self)

    def join(self, timeout: float = 5.0) -> None:
        """Wait up to ``timeout`` seconds for the reader (and the
        columnar path's ingest) thread to end after ``close``.  A host's
        ``stop`` joins every stream so that no reader outlives it."""
        deadline = time.monotonic() + timeout
        for t in (self._reader, self._ingest):
            if t is not None and t is not threading.current_thread():
                t.join(max(0.0, deadline - time.monotonic()))

    # -- internals ---------------------------------------------------------

    def outbound(self):
        """The gRPC response/request iterator (writeStream,
        conn.go:143-162).  Polls the closed flag so termination never
        depends on a sentinel racing a full mailbox."""
        while True:
            try:
                item = self._out.get(timeout=0.25)
            except queue.Empty:
                if self._closed.is_set():
                    return
                continue
            if item is _CLOSE:
                return
            yield item

    def _read_loop(self) -> None:
        """readStream + dispatch (conn.go:110-128,164-180)."""
        if self._columnar:
            self._read_loop_columnar()
            return
        try:
            for wire in self._inbound:
                if self._closed.is_set():
                    break
                try:
                    msg, signing_prefix = decode_frame(wire)
                except ValueError:
                    self.rejected += 1
                    self._trace_rejected("undecodable")
                    continue
                self.frames_decoded += 1
                self.mac_verify_batches += 1
                if not self._auth.verify_wire(  # conn.go:134-137, real
                    msg, signing_prefix
                ):
                    self.rejected += 1
                    self._trace_rejected("bad_mac")
                    continue
                self.delivered += 1
                handler = self._handler
                if handler is not None:
                    handler.serve_request(msg)  # staticcheck: allow[DET004] scalar comparison arm
        except Exception:  # staticcheck: allow[ERR001] finally closes the conn
            pass  # stream broken: fall through to close
        finally:
            self.close()

    def _ingest_loop(self, q: "queue.Queue") -> None:
        """Stream -> local queue: the wave buffer's producer side.  The
        queue is BOUNDED (the scalar path's synchronous consumption
        exerted backpressure through gRPC flow control; an unbounded
        buffer here would re-open the flood-to-OOM hole), so a full
        buffer blocks ingest — and with it the gRPC window — until the
        verify loop drains.  The sentinel (stream end OR break)
        releases the verify loop."""
        try:
            for wire in self._inbound:
                if self._closed.is_set():
                    break
                while not self._closed.is_set():
                    try:
                        q.put(wire, timeout=0.25)
                        break
                    except queue.Full:
                        continue
        except Exception:  # staticcheck: allow[ERR001] sentinel closes the conn
            pass  # stream broken: the sentinel ends the verify loop
        finally:
            while True:  # the sentinel must land; the verify loop
                try:  # drains continuously, so this terminates
                    q.put(_CLOSE, timeout=0.25)
                    break
                except queue.Full:
                    if self._closed.is_set():
                        break  # verify loop already exiting on the flag

    def _read_loop_columnar(self) -> None:
        """Wave-batched inbound path (Config.delivery_columnar): drain
        the ingest queue's current backlog — one message wave, however
        many frames arrived since the last pass — decode them, and MAC
        the whole wave through ONE verify_wire_many call before
        dispatching in arrival order.  Width follows the actual burst
        shape: a peer's bundle fan-in lands together, so steady-state
        waves are much wider than 1."""
        q: "queue.Queue" = queue.Queue(maxsize=self._out.maxsize)
        self._ingest = threading.Thread(
            target=self._ingest_loop,
            args=(q,),
            name=f"conn-ingest-{self._conn_id[:8]}",
            daemon=True,
        )
        self._ingest.start()
        try:
            ended = False
            while not ended and not self._closed.is_set():
                try:
                    first = q.get(timeout=0.25)
                except queue.Empty:
                    continue
                batch = [first]
                while True:  # the wave: everything already buffered
                    try:
                        batch.append(q.get_nowait())
                    except queue.Empty:
                        break
                msgs, prefixes = [], []
                for wire in batch:
                    if wire is _CLOSE:
                        ended = True
                        continue
                    try:
                        msg, prefix = decode_frame(wire)
                    except ValueError:
                        self.rejected += 1
                        self._trace_rejected("undecodable")
                        continue
                    self.frames_decoded += 1
                    msgs.append(msg)
                    prefixes.append(prefix)
                if not msgs:
                    continue
                self.mac_verify_batches += 1
                tr = getattr(self._handler, "trace", None)
                t0 = 0.0 if tr is None else tr.now()
                oks = self._auth.verify_wire_many(msgs, prefixes)
                if tr is not None:
                    tr.complete(
                        "transport",
                        "mac_verify_batch",
                        t0,
                        batch_width=len(msgs),
                    )
                handler = self._handler
                good: List[Message] = []
                for msg, ok in zip(msgs, oks):
                    if not ok:
                        self.rejected += 1
                        self._trace_rejected("bad_mac")
                        continue
                    self.delivered += 1
                    good.append(msg)
                if not good or handler is None:
                    continue
                serve_wave = (
                    getattr(handler, "serve_wave", None)
                    if self._wave_routing
                    else None
                )
                if serve_wave is not None:
                    # one actor message per wave: the dispatcher's
                    # mailbox carries the whole verified burst
                    serve_wave(good)
                else:
                    for msg in good:
                        handler.serve_request(msg)  # staticcheck: allow[DET004] scalar arm
        finally:
            self.close()

    def _trace_rejected(self, why: str) -> None:
        """Mirror of ChannelNetwork's rejected-frame instant: when the
        bound handler (the host's SerialDispatcher) carries a flight
        recorder, every rejected frame lands in the trace."""
        tr = getattr(self._handler, "trace", None)
        if tr is not None:
            tr.instant(
                "transport", "rejected", conn=self._conn_id, why=why
            )


ConnHandler = Callable[[GrpcConnection], None]  # comm.go:18
ErrHandler = Callable[[Exception], None]  # comm.go:19


@guarded_by(
    "_lock",
    "_conns",
    "_delivered_closed",
    "_rejected_closed",
    "_decoded_closed",
    "_batches_closed",
)
class GrpcServer:
    """Reference comm.go:21-99 GrpcServer.

    ``on_conn`` fires for every accepted stream with a started-but-
    unhandled Connection; the callback registers a Handler and calls
    ``start()`` (exactly the reference's app contract, comm.go:47-49).
    """

    def __init__(
        self,
        addr: str,
        auth: Optional[Authenticator] = None,
        capacity: int = DEFAULT_CHANNEL_CAPACITY,
        delivery_columnar: bool = False,
        wave_routing: bool = False,
    ) -> None:
        self.addr = addr
        self._auth = auth or NullAuthenticator()
        self._capacity = capacity
        self._delivery_columnar = delivery_columnar
        self._wave_routing = wave_routing
        self._on_conn: Optional[ConnHandler] = None
        self._on_err: Optional[ErrHandler] = None
        self._server: Optional[grpc.Server] = None
        self._executor = None
        self._conns: List[GrpcConnection] = []
        self._lock = new_lock()
        self.port: Optional[int] = None
        # counters folded in from closed connections, so stats() stays
        # cumulative across redials
        self._delivered_closed = 0
        self._rejected_closed = 0
        self._decoded_closed = 0
        self._batches_closed = 0

    def on_conn(self, handler: ConnHandler) -> None:
        """comm.go:65-70."""
        self._on_conn = handler

    def on_err(self, handler: ErrHandler) -> None:
        """comm.go:72-77."""
        self._on_err = handler

    def _remove_conn(self, conn: "GrpcConnection") -> None:
        with self._lock:
            try:
                self._conns.remove(conn)
            except ValueError:
                return  # already folded into the cumulative counters
            self._delivered_closed += conn.delivered
            self._rejected_closed += conn.rejected
            self._decoded_closed += conn.frames_decoded
            self._batches_closed += conn.mac_verify_batches

    def stats(self) -> dict:
        """Cumulative inbound frame counters across every stream this
        server ever accepted (live + closed), for
        ``Metrics.snapshot()["transport"]``."""
        with self._lock:
            delivered = self._delivered_closed
            rejected = self._rejected_closed
            decoded = self._decoded_closed
            batches = self._batches_closed
            for conn in self._conns:
                delivered += conn.delivered
                rejected += conn.rejected
                decoded += conn.frames_decoded
                batches += conn.mac_verify_batches
        return {
            "delivered": delivered,
            "rejected": rejected,
            "frames_decoded": decoded,
            "mac_verify_batches": batches,
        }

    def _stream_behavior(self, request_iterator, context):
        conn = GrpcConnection(
            request_iterator,
            self._auth,
            capacity=self._capacity,
            on_close=lambda c: (self._remove_conn(c), context.cancel()),
            delivery_columnar=self._delivery_columnar,
            wave_routing=self._wave_routing,
        )
        with self._lock:
            self._conns.append(conn)
        if self._on_conn is not None:
            self._on_conn(conn)
        return conn.outbound()

    def listen(self, max_workers: int = 32) -> None:
        """comm.go:79-99 — binds and serves in the background (gRPC
        owns the accept loop; no blocking call needed)."""
        handler = grpc.method_handlers_generic_handler(
            SERVICE_NAME,
            {
                METHOD_NAME: grpc.stream_stream_rpc_method_handler(
                    self._stream_behavior,
                    request_deserializer=_identity,
                    response_serializer=_identity,
                )
            },
        )
        from concurrent import futures as _futures

        self._executor = _futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="grpc-server"
        )
        self._server = grpc.server(self._executor)
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(self.addr)
        if self.port == 0:
            err = RuntimeError(f"could not bind {self.addr}")
            if self._on_err is not None:
                self._on_err(err)
            raise err  # never leave the caller with a dead server
        self._server.start()

    def stop(self, grace: float = 0.5) -> List["GrpcConnection"]:
        """comm.go:101-105.  Returns the streams it closed (the caller
        may ``join`` them) and waits for gRPC's own shutdown."""
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            conn.close()
        if self._server is not None:
            self._server.stop(grace).wait(grace + 5.0)
        if self._executor is not None:
            # the stream handlers end with their closed connections
            self._executor.shutdown(wait=True)
        return conns


class DialOpts:
    """comm.go:111-117."""

    def __init__(
        self,
        addr: str,
        timeout_s: float = DEFAULT_DIAL_TIMEOUT_S,
        capacity: int = DEFAULT_CHANNEL_CAPACITY,
        conn_id: Optional[str] = None,
    ):
        self.addr = addr
        self.timeout_s = timeout_s
        self.capacity = capacity
        self.conn_id = conn_id


class GrpcClient:
    """Reference comm.go:119-140 GrpcClient."""

    def __init__(
        self,
        auth: Optional[Authenticator] = None,
        delivery_columnar: bool = False,
        wave_routing: bool = False,
    ):
        self._auth = auth or NullAuthenticator()
        self._delivery_columnar = delivery_columnar
        self._wave_routing = wave_routing
        self._channels: List[grpc.Channel] = []

    def dial(self, opts: DialOpts) -> GrpcConnection:
        """Insecure dial with timeout -> client stream wrapper ->
        Connection (comm.go:125-140)."""
        channel = grpc.insecure_channel(opts.addr)
        try:
            grpc.channel_ready_future(channel).result(timeout=opts.timeout_s)
        except Exception:
            channel.close()  # don't leak channels across dial retries
            raise
        self._channels.append(channel)
        multi = channel.stream_stream(
            _FULL_METHOD,
            request_serializer=_identity,
            response_deserializer=_identity,
        )
        # the connection exists first (gRPC starts consuming the
        # request iterator immediately); the call object then becomes
        # the connection's inbound stream
        conn = GrpcConnection(
            None,
            self._auth,
            capacity=opts.capacity,
            conn_id=opts.conn_id,
            delivery_columnar=self._delivery_columnar,
            wave_routing=self._wave_routing,
        )
        call = multi(conn.outbound())
        conn._inbound = call

        def cleanup(_c, ch=channel, call=call):
            # release the channel with its stream: redial cycles must
            # not accumulate live channels (sockets + threads)
            try:
                call.cancel()
            finally:
                try:
                    ch.close()
                except Exception:  # staticcheck: allow[ERR001] best-effort close
                    pass
                try:
                    self._channels.remove(ch)
                except ValueError:
                    pass

        conn._on_close = cleanup
        return conn

    def close(self) -> None:
        for ch in self._channels:
            ch.close()


__all__ = [
    "GrpcServer",
    "GrpcClient",
    "GrpcConnection",
    "DialOpts",
    "SERVICE_NAME",
    "METHOD_NAME",
]
