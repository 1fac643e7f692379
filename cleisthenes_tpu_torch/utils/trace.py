"""Epoch flight recorder: the structured-tracing half of observability.

The cost model of this stack is dispatch count per epoch, not FLOPs
(docs/ARCHITECTURE.md), yet until this module the only instruments
were coarse counters (`utils/metrics.py`): an N=64 epoch read as one
~12 s number with no way to say whether RBC echo waves, BBA coin
rounds, TPKE verify+combine, or hub flush scheduling bounded the
commit.  The recorder is a per-node bounded ring buffer of typed
events; `tools/tracetool.py` merges N node buffers into one
Chrome-trace-event artifact (Perfetto-loadable) and derives the
per-epoch critical-path report (docs/TRACING.md).

Design constraints, in order:

1. **Compiled-out when off.**  `Config.trace=False` (the default)
   means NO recorder exists: instrumentation sites hold `None` and
   guard with one attribute load + identity check — no allocation, no
   call (`tests/test_trace.py` asserts the zero-allocation property).
2. **Determinism-plane safe.**  Ordering comes from per-node
   **sequence numbers** assigned at record time; `perf_counter`
   timestamps ride along as PURE OBSERVABILITY data that no protocol
   state ever reads back.  This file is the single sanctioned home of
   that clock (the `allow[DET001]` pragmas below); protocol/transport
   code calls `recorder.now()` and never touches `time` itself.  Two
   `PYTHONHASHSEED` runs of one seeded cluster must produce identical
   event sequences — only the timestamps may differ.
3. **Bounded.**  The ring keeps the NEWEST `cap` events and counts
   drops (`stats()`), so an unbounded run can never leak memory into
   the protocol plane.

Event tuple shape (storage; `to_chrome` renders the JSON form):

    (seq, ts, dur, cat, name, args)

    seq   deterministic per-node sequence number (ordering truth)
    ts    perf_counter seconds at record time (observability only)
    dur   None for instant events; span length in seconds otherwise
    cat   one of CATEGORIES
    name  short event name, e.g. "open", "flush", "reveal"
    args  dict of JSON-scalar details (counts, epochs, proposers) —
          MUST be deterministic: no timestamps, no id()s, no set order
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_lock

# The stage vocabulary: every event belongs to exactly one plane, and
# the critical-path report attributes epoch wall time to these names.
CATEGORIES = frozenset(
    (
        "epoch",  # epoch open / ACS output / commit markers
        "rbc",  # reliable broadcast: VAL/ECHO/READY/deliver
        "bba",  # binary agreement rounds and decisions
        "coin",  # threshold-coin share issue + reveal
        "tpke",  # threshold encryption: encrypt/share/combine
        "settle",  # the trailing decrypt frontier (two-frontier commit
        # split): dec-share issue/combine run by the settler, plus the
        # per-epoch ordered->settled decrypt_lag bracket — kept apart
        # from "tpke" so open->ordered critical paths show exactly the
        # mass that LEFT them
        "hub",  # CryptoHub batched-dispatch flushes
        "router",  # wave-routed ingest demux (protocol.router): one
        # "route" span per delivery wave, args carry frame/payload/
        # dispatch counts — the handler-dispatch amortization record
        "transport",  # envelope coalescing, waves, queue depth
        "ledger",  # WAL appends / checkpoints
        "catchup",  # state-transfer requests/serves/adopts
        "alert",  # SLO watchdog firings (epoch stall, backpressure…)
        "reconfig",  # dynamic membership: one "ceremony" span per
        # reshare (discovery -> qualified set -> finalize) plus
        # discovered/deal/staged/install/activate/teardown instants
        # — the roster-switch timeline tools/tracetool.py reports
        "ingress",  # client admission pipeline (transport/ingress +
        # core/mempool): submit spans per ingress frame, admit/evict
        # instants with the verdict, and one "stream" span per
        # subscriber batch delivery — the client-visible latency
        # timeline the ingress_load bench section measures against
        "engine",  # the modexp engine's calls inside a lockstep epoch:
        # int->bytes packing, the device leg, bytes->int unpacking
        "gc",  # full collections of the garbage collector inside a
        # traced lockstep epoch
    )
)

DEFAULT_CAP = 1 << 16

# The recorder of the traced lockstep epoch now running, else None.
# ``LockstepCluster.run_epoch`` binds it for the epoch and resets it in a
# ``finally``; ops/tpke.py and ``ModEngine`` read it at their call sites,
# so the batched ops record spans without a recorder argument.  The
# asynchronous plane never binds it.  Read it as ``trace.ACTIVE``: a
# name imported from here would keep the value it had at import.
ACTIVE: Optional["TraceRecorder"] = None

Event = Tuple[int, float, Optional[float], str, str, dict]


@guarded_by("_lock", "_events", "_seq", "_dropped", "_high_water")
class TraceRecorder:
    """One node's flight recorder: a bounded ring of typed events.

    Thread-safe (the gRPC transport records from its dispatcher thread
    while `Metrics.snapshot()` reads stats from callers), but sequence
    numbers are only *meaningful* ordering when the owner records from
    one thread — exactly the single-threaded-actor discipline the
    protocol plane already has.
    """

    def __init__(self, node_id: str, cap: int = DEFAULT_CAP) -> None:
        if cap <= 0:
            raise ValueError(f"trace ring cap {cap} must be > 0")
        self.node_id = node_id
        self.cap = cap
        self._events: Deque[Event] = collections.deque(maxlen=cap)
        self._seq = 0
        self._dropped = 0
        self._high_water = 0
        self._lock = new_lock()

    @staticmethod
    def now() -> float:
        """The observability clock.  Pure data: nothing in the
        protocol plane may branch on this value."""
        return time.perf_counter()  # pure observability (outside the plane)

    # -- recording ---------------------------------------------------------

    def _record(
        self, cat: str, name: str, ts: float, dur: Optional[float], args: dict
    ) -> None:
        with self._lock:
            self._seq += 1
            ring = self._events
            if len(ring) >= self.cap:  # deque(maxlen) evicts the OLDEST
                self._dropped += 1
            ring.append((self._seq, ts, dur, cat, name, args))
            if len(ring) > self._high_water:
                self._high_water = len(ring)

    def instant(self, cat: str, name: str, **args) -> None:
        """A zero-duration marker (quorum crossing, commit, adopt)."""
        self._record(cat, name, self.now(), None, args)

    def complete(
        self, cat: str, name: str, t0: float, t1: Optional[float] = None, **args
    ) -> None:
        """A span recorded at its END: ``t0`` came from ``now()``
        before the work (the begin/end pair in one call — no nesting
        bookkeeping on the hot path).  ``t1`` is the end when the
        caller has already read it (a phase boundary it also keeps in
        its stats); else the end is read now."""
        if t1 is None:
            t1 = self.now()
        self._record(cat, name, t0, t1 - t0, args)

    @contextlib.contextmanager
    def span(self, cat: str, name: str, **args):
        """Context-manager form of ``complete`` for non-hot-path use
        (tools, tests, demo drivers)."""
        t0 = self.now()
        try:
            yield self
        finally:
            self.complete(cat, name, t0, **args)

    # -- reading -----------------------------------------------------------

    def events(self) -> List[Event]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._events)

    def stats(self) -> Dict[str, int]:
        """The Metrics.snapshot()["trace"] block: lifetime recorded
        count, ring-overflow drops, and the buffer high-water mark."""
        with self._lock:
            return {
                "events_recorded": self._seq,
                "events_dropped": self._dropped,
                "high_water": self._high_water,
            }


def maybe_recorder(config, node_id: str) -> Optional[TraceRecorder]:
    """The one construction seam: a recorder iff ``config.trace``,
    else None — and None IS the compiled-out fast path (sites guard
    with ``if tr is not None``)."""
    if getattr(config, "trace", False):
        return TraceRecorder(
            node_id, getattr(config, "trace_buffer", DEFAULT_CAP)
        )
    return None


# ---------------------------------------------------------------------------
# Chrome-trace-event rendering (the Perfetto-loadable artifact)
# ---------------------------------------------------------------------------


def to_chrome(events_by_node: Dict[str, Iterable[Event]]) -> dict:
    """Merge N node buffers into one Chrome trace-event document:
    one track (tid) per node, instants as 'i' events, spans as 'X'
    complete events (self-nesting in the viewer), timestamps
    normalized to the earliest event and scaled to microseconds.

    The per-node ``seq`` rides in ``args.seq`` — it is the ordering
    ground truth (`tools/tracetool.py --validate` checks it is
    strictly increasing per track; timestamps are allowed to be
    whatever the clock said).
    """
    nodes = sorted(events_by_node)
    all_events = {n: list(events_by_node[n]) for n in nodes}
    t_min = min(
        (ev[1] for evs in all_events.values() for ev in evs),
        default=0.0,
    )
    trace_events: List[dict] = []
    for tid, node in enumerate(nodes, start=1):
        trace_events.append(
            {
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "name": "thread_name",
                "args": {"name": node},
            }
        )
        for seq, ts, dur, cat, name, args in all_events[node]:
            ev = {
                "pid": 1,
                "tid": tid,
                "cat": cat,
                "name": name,
                "ts": round((ts - t_min) * 1e6, 3),
                "args": {"seq": seq, **args},
            }
            if dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"  # thread-scoped instant
            else:
                ev["ph"] = "X"
                ev["dur"] = round(dur * 1e6, 3)
            trace_events.append(ev)
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "metadata": {
            "tool": "cleisthenes_tpu_torch.utils.trace",
            "nodes": nodes,
        },
    }


def write_chrome(path: str, events_by_node: Dict[str, Iterable[Event]]) -> None:
    """Serialize ``to_chrome`` to ``path`` (open the file in Perfetto
    via ui.perfetto.dev -> Open trace file; see docs/TRACING.md)."""
    import json

    with open(path, "w", encoding="utf-8") as fh:
        json.dump(to_chrome(events_by_node), fh)


__all__ = [
    "CATEGORIES",
    "DEFAULT_CAP",
    "TraceRecorder",
    "maybe_recorder",
    "to_chrome",
    "write_chrome",
]
