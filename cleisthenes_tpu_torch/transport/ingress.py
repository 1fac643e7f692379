"""Client ingress plane: the validator's door for untrusted clients.

Everything before this module fed transactions in-process
(``demo.py`` called ``host.submit``), so no throughput claim had the
one number that arbitrates them all: client-visible submit->ordered
and submit->settled latency.  This module is the missing surface:

- **Submit**: a client sends an ``IngressSubmitPayload`` frame
  (transport.message.encode_client_frame) and gets exactly one
  ``IngressAckPayload`` back — the mempool's admission verdict
  (core/mempool.py: dedup / per-client + global backpressure /
  priority eviction) plus the admitting node's two commit frontiers,
  so the client can bound when its tx can first appear in a batch.

- **Subscribe**: a client sends an ``IngressSubscribePayload`` and
  receives the settled batch stream from ``from_epoch`` on — replay
  from the node's committed history (the same state the BatchLog
  restores at startup: one log, not two) followed by a live tail fed
  from the settlement fan-out (HoneyBadger.add_commit_listener).
  Batch bodies are the canonical ledger encoding
  (core.ledger.encode_batch_body) — the exact bytes CATCHUP serves,
  so subscribers and rejoining validators read one format.

Two mounts share ALL of this logic through ``IngressPlane``:

- ``IngressGrpcServer`` exposes it as gRPC service
  ``cleisthenes.IngressService`` (raw-bytes stream methods, the same
  generic-handler idiom as transport/grpc_net.py) on
  ``Config.ingress_port``, built and started by ``ValidatorHost``.
- ``InProcIngressClient`` is the SimulatedCluster-side twin: it
  round-trips the identical encoded frames through the identical
  plane entry points, so channel-transport tests (and the fuzz
  band's client schedules) exercise the production code path with
  no sockets.

Client frames carry no envelope MAC (clients hold no roster keys);
the mempool's admission control is the abuse guard, and ingress
frames can never reach the validator-to-validator dispatch path —
``decode_client_frame`` rejects every protocol-plane payload kind.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Tuple

from cleisthenes_tpu_torch.core.ledger import encode_batch_body
from cleisthenes_tpu_torch.core.mempool import (
    DUPLICATE,
    OK,
    REJECTED,
    RETRY_AFTER,
)
from cleisthenes_tpu_torch.transport.message import (
    IngressAckPayload,
    IngressBatchPayload,
    IngressStatus,
    IngressSubmitPayload,
    IngressSubscribePayload,
    decode_client_frame,
    encode_client_frame,
)
from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_lock

# mempool verdict -> wire status (core stays transport-free, so the
# mapping lives here at the boundary)
_STATUS = {
    OK: IngressStatus.OK,
    DUPLICATE: IngressStatus.DUPLICATE,
    REJECTED: IngressStatus.REJECTED,
    RETRY_AFTER: IngressStatus.RETRY_AFTER,
}

# a subscriber this many undelivered batches behind is dropped (slow
# consumer): the feed queue must not buffer an unbounded history
FEED_CAPACITY = 4096


class SubscriptionFeed:
    """One subscriber's batch stream: a bounded queue of encoded
    IngressBatchPayload frames, fed replay-then-live in strict epoch
    order by the owning plane.  ``next_frame`` is the consumer side
    (gRPC response generator, or the in-proc twin's iterator)."""

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=FEED_CAPACITY)
        self._closed = threading.Event()
        # set when the plane dropped us for falling behind
        self.lagged = False

    def _push(self, frame: bytes) -> bool:
        """Plane side.  False means the consumer is too far behind
        and the feed was closed (the ingress contract prefers a
        visible drop over unbounded buffering)."""
        if self._closed.is_set():
            return False
        try:
            self._q.put_nowait(frame)
            return True
        except queue.Full:
            self.lagged = True
            self.close()
            return False

    def next_frame(self, timeout: float = 0.25) -> Optional[bytes]:
        """One encoded IngressBatchPayload, or None on timeout/close."""
        if self._closed.is_set() and self._q.empty():
            return None
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    @property
    def closed(self) -> bool:
        return self._closed.is_set() and self._q.empty()

    def close(self) -> None:
        self._closed.set()


@guarded_by("_lock", "_feeds")
class IngressPlane:
    """One node's transport-agnostic ingress core.  Thread-safe:
    submit_frame runs on gRPC worker threads (the mempool admits
    under its own lock), the settlement fan-out runs on the protocol
    thread, and subscribe can come from either."""

    def __init__(self, node, on_admitted: Optional[Callable[[], None]] = None):
        if node.mempool is None:
            raise RuntimeError(
                "ingress needs a mounted mempool "
                "(Config.mempool_capacity > 0)"
            )
        self._node = node
        # optional post-admission kick (ValidatorHost wires a propose
        # nudge so an idle node starts an epoch for fresh client work;
        # the in-proc cluster's run loop does its own driving)
        self._on_admitted = on_admitted
        self._lock = new_lock()
        self._feeds: List[SubscriptionFeed] = []
        node.set_subscriber_provider(self.subscriber_count)
        node.add_commit_listener(self._on_settled)

    # -- submit --------------------------------------------------------

    def submit_frame(self, data: bytes) -> bytes:
        """One client submit frame in, exactly one ack frame out —
        the no-silent-drops contract.  A malformed frame raises to
        the transport (which hangs up), never into the protocol."""
        payload = decode_client_frame(data)
        if not isinstance(payload, IngressSubmitPayload):
            raise ValueError(
                f"expected a submit frame, got {type(payload).__name__}"
            )
        tr = self._node.trace
        t0 = 0.0 if tr is None else tr.now()
        verdict = self._node.submit_ingress(
            payload.client_id, payload.fee, payload.tx
        )
        status = _STATUS[verdict.status]
        if tr is not None:
            tr.complete("ingress", "submit", t0, status=verdict.status)
        if status == IngressStatus.OK and self._on_admitted is not None:
            self._on_admitted()
        # frontiers in the ack are MERGED total-order frontiers: at
        # lanes=1 they equal (epoch, settled_epoch) byte-for-byte; at
        # lanes>1 they span every lane, so a client's exactly-once
        # audit window is one number regardless of which lane its tx
        # hashed into
        ack = IngressAckPayload(
            client_id=payload.client_id,
            nonce=payload.nonce,
            status=int(status),
            ordered_epoch=self._node.merged_ordered_frontier,
            settled_epoch=self._node.merged_settled_frontier,
            retry_after_ms=verdict.retry_after_ms,
        )
        return encode_client_frame(ack)

    # -- subscribe -----------------------------------------------------

    def subscribe(self, from_epoch: int) -> SubscriptionFeed:
        """Open one committed-batch feed: settled epochs in
        [from_epoch, settled-frontier) replay immediately from the
        committed history, later ones arrive live from the settlement
        fan-out.  Registration and replay happen under one lock
        acquisition against _on_settled, so the epoch sequence a
        subscriber sees has no gap and no duplicate at the
        replay/live seam."""
        feed = SubscriptionFeed()
        with self._lock:
            # merged total order (== committed_batches at lanes=1):
            # subscribers see ONE slot sequence across all lanes, the
            # same stream the live fan-out (add_commit_listener) emits
            batches = self._node.merged_batches
            for epoch in range(max(0, from_epoch), len(batches)):
                feed._push(
                    encode_client_frame(
                        IngressBatchPayload(
                            epoch, encode_batch_body(epoch, batches[epoch])
                        )
                    )
                )
            self._feeds.append(feed)
        return feed

    def _on_settled(self, epoch: int, batch) -> None:
        """Settlement fan-out (protocol thread, via
        HoneyBadger.add_commit_listener): encode once, feed every
        live subscriber, drop the ones that fell behind."""
        with self._lock:
            if not self._feeds:
                return
            frame = encode_client_frame(
                IngressBatchPayload(epoch, encode_batch_body(epoch, batch))
            )
            live = [f for f in self._feeds if f._push(frame)]
            self._feeds = live
        tr = self._node.trace
        if tr is not None:
            tr.instant("ingress", "stream", epoch=epoch, subs=len(live))

    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._feeds)

    def close_feed(self, feed: SubscriptionFeed) -> None:
        feed.close()
        with self._lock:
            if feed in self._feeds:
                self._feeds.remove(feed)

    def close(self) -> None:
        with self._lock:
            feeds, self._feeds = self._feeds, []
        for f in feeds:
            f.close()


class InProcIngressClient:
    """The SimulatedCluster-side twin of the gRPC client: identical
    encoded frames through the identical IngressPlane entry points,
    minus the sockets — so channel-transport tests and the fuzz
    band's client schedules exercise the production path."""

    def __init__(self, plane: IngressPlane):
        self._plane = plane

    def submit(
        self, client_id: str, nonce: int, fee: int, tx: bytes
    ) -> IngressAckPayload:
        frame = encode_client_frame(
            IngressSubmitPayload(client_id, nonce, fee, tx)
        )
        ack = decode_client_frame(self._plane.submit_frame(frame))
        assert isinstance(ack, IngressAckPayload)
        return ack

    def subscribe(self, from_epoch: int = 0) -> SubscriptionFeed:
        return self._plane.subscribe(from_epoch)

    def next_batch(
        self, feed: SubscriptionFeed, timeout: float = 0.25
    ) -> Optional[IngressBatchPayload]:
        frame = feed.next_frame(timeout=timeout)
        if frame is None:
            return None
        payload = decode_client_frame(frame)
        assert isinstance(payload, IngressBatchPayload)
        return payload


# ---------------------------------------------------------------------------
# gRPC mount
# ---------------------------------------------------------------------------

INGRESS_SERVICE = "cleisthenes.IngressService"
SUBMIT_METHOD = "Submit"
SUBSCRIBE_METHOD = "Subscribe"


def _identity(b: bytes) -> bytes:
    return b


class IngressGrpcServer:
    """The client-facing gRPC mount of one node's IngressPlane: raw-
    bytes stream methods via the generic-handler idiom (the
    grpc_net.GrpcServer pattern), bound on Config.ingress_port.

    ``Submit`` is bidi: each request frame yields exactly one ack
    frame, so a pipelining client matches acks by nonce.
    ``Subscribe`` takes one IngressSubscribePayload frame and streams
    IngressBatchPayload frames until the client hangs up."""

    def __init__(self, plane: IngressPlane, addr: str) -> None:
        import grpc  # deferred like grpc_net: core never needs it

        self._grpc = grpc
        self._plane = plane
        self.addr = addr
        self.port: Optional[int] = None
        self._server: Optional["grpc.Server"] = None

    def _submit_behavior(self, request_iterator, context):
        for data in request_iterator:
            try:
                yield self._plane.submit_frame(data)
            except ValueError:
                # malformed client frame: hang up, never crash the node
                context.cancel()
                return

    def _subscribe_behavior(self, request_iterator, context):
        try:
            first = next(iter(request_iterator))
            payload = decode_client_frame(first)
        except (StopIteration, ValueError):
            context.cancel()
            return
        if not isinstance(payload, IngressSubscribePayload):
            context.cancel()
            return
        feed = self._plane.subscribe(payload.from_epoch)
        try:
            while context.is_active():
                frame = feed.next_frame(timeout=0.25)
                if frame is not None:
                    yield frame
                elif feed.closed:
                    return
        finally:
            self._plane.close_feed(feed)

    def listen(self, max_workers: int = 16) -> None:
        grpc = self._grpc
        handler = grpc.method_handlers_generic_handler(
            INGRESS_SERVICE,
            {
                SUBMIT_METHOD: grpc.stream_stream_rpc_method_handler(
                    self._submit_behavior,
                    request_deserializer=_identity,
                    response_serializer=_identity,
                ),
                SUBSCRIBE_METHOD: grpc.stream_stream_rpc_method_handler(
                    self._subscribe_behavior,
                    request_deserializer=_identity,
                    response_serializer=_identity,
                ),
            },
        )
        from concurrent import futures as _futures

        self._server = grpc.server(
            _futures.ThreadPoolExecutor(max_workers=max_workers)
        )
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(self.addr)
        if self.port == 0:
            raise RuntimeError(f"could not bind ingress {self.addr}")
        self._server.start()

    def stop(self, grace: float = 0.5) -> None:
        self._plane.close()
        if self._server is not None:
            self._server.stop(grace)


class IngressGrpcClient:
    """A client's handle on one node's ingress service (demo.py and
    the gRPC round-trip tests; loadgen uses the in-proc twin)."""

    def __init__(self, addr: str) -> None:
        import grpc

        self._channel = grpc.insecure_channel(addr)
        self._submit = self._channel.stream_stream(
            f"/{INGRESS_SERVICE}/{SUBMIT_METHOD}",
            request_serializer=_identity,
            response_deserializer=_identity,
        )
        self._subscribe = self._channel.stream_stream(
            f"/{INGRESS_SERVICE}/{SUBSCRIBE_METHOD}",
            request_serializer=_identity,
            response_deserializer=_identity,
        )

    def submit(
        self, client_id: str, nonce: int, fee: int, tx: bytes,
        timeout: float = 10.0,
    ) -> IngressAckPayload:
        acks = self.submit_many(
            [(client_id, nonce, fee, tx)], timeout=timeout
        )
        return acks[0]

    def submit_many(
        self,
        submits: List[Tuple[str, int, int, bytes]],
        timeout: float = 30.0,
    ) -> List[IngressAckPayload]:
        """Pipeline many submits on one stream; one ack per submit,
        in order."""
        frames = [
            encode_client_frame(IngressSubmitPayload(c, n, f, t))
            for (c, n, f, t) in submits
        ]
        acks: List[IngressAckPayload] = []
        for resp in self._submit(iter(frames), timeout=timeout):
            ack = decode_client_frame(resp)
            assert isinstance(ack, IngressAckPayload)
            acks.append(ack)
            if len(acks) == len(frames):
                break
        return acks

    def subscribe(
        self, from_epoch: int = 0, timeout: float = 3600.0
    ) -> Iterator[IngressBatchPayload]:
        """Yields settled batches from ``from_epoch`` until the caller
        abandons the iterator (closing the channel tears it down)."""
        frame = encode_client_frame(IngressSubscribePayload(from_epoch))
        for resp in self._subscribe(iter([frame]), timeout=timeout):
            payload = decode_client_frame(resp)
            assert isinstance(payload, IngressBatchPayload)
            yield payload

    def close(self) -> None:
        self._channel.close()


__all__ = [
    "FEED_CAPACITY",
    "INGRESS_SERVICE",
    "IngressGrpcClient",
    "IngressGrpcServer",
    "IngressPlane",
    "InProcIngressClient",
    "SubscriptionFeed",
]
