"""Metrics & tracing: the observability the reference lacks.

SURVEY.md §5.1/§5.5: the reference's only observability is three log
lines on listen errors (reference comm.go:82,92,95) — no metrics
registry, no per-epoch timing, even though the BASELINE metric is
"tx/sec & epoch p50".  This module provides exactly that: counters,
streaming histograms with percentiles, and per-epoch phase traces
(propose -> ACS output -> commit), cheap enough to stay always-on.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_lock


@guarded_by("_lock", "_v")
class Counter:
    """Monotonic counter (thread-safe)."""

    def __init__(self) -> None:
        self._v = 0
        self._lock = new_lock()

    def inc(self, by: int = 1) -> None:
        with self._lock:
            self._v += by

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


# Default cumulative-bucket bounds for the Prometheus exposition
# (seconds): epoch latencies span ~10 ms in-proc mini-clusters to
# multi-minute N=128 message-passing epochs, so the ladder is
# log-spaced across that whole range.
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


@guarded_by(
    "_lock", "_sorted", "_ring", "_bucket_counts", "_total_sum",
    "_total_count",
)
class Histogram:
    """Sorted-reservoir histogram with exact percentiles.

    Bounded: keeps the most recent ``cap`` observations (epoch
    latencies arrive at network pace, so thousands of samples cover
    hours of operation).  Percentiles read the reservoir (a recency
    window); the Prometheus export (``cumulative_buckets`` /
    ``total_sum`` / ``total_count``) reads SEPARATE lifetime tallies
    that only ever grow — the histogram type contract requires
    monotonic counters, and reservoir eviction would read as counter
    resets (spurious rate() spikes on dashboards)."""

    def __init__(
        self, cap: int = 4096, buckets: Sequence[float] = DEFAULT_BUCKETS
    ) -> None:
        self._sorted: List[float] = []
        self._ring: "collections.deque[float]" = collections.deque()
        self._cap = cap
        self.bucket_bounds: List[float] = sorted(buckets)
        # lifetime (monotonic) tallies for the Prometheus exposition
        self._bucket_counts: List[int] = [0] * len(self.bucket_bounds)
        self._total_sum = 0.0
        self._total_count = 0
        self._lock = new_lock()

    def observe(self, v: float) -> None:
        with self._lock:
            if len(self._ring) >= self._cap:
                old = self._ring.popleft()
                idx = bisect.bisect_left(self._sorted, old)
                self._sorted.pop(idx)
            self._ring.append(v)
            bisect.insort(self._sorted, v)
            self._total_sum += v
            self._total_count += 1
            i = bisect.bisect_left(self.bucket_bounds, v)
            if i < len(self._bucket_counts):
                self._bucket_counts[i] += 1

    def percentile(self, p: float) -> Optional[float]:
        """p in [0, 100]; None when empty."""
        with self._lock:
            if not self._sorted:
                return None
            idx = min(
                len(self._sorted) - 1,
                int(round((p / 100.0) * (len(self._sorted) - 1))),
            )
            return self._sorted[idx]

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """Prometheus-style cumulative buckets over the histogram's
        LIFETIME: ``[(le, observations <= le), ...]`` ending with the
        ``(inf, total)`` catch-all — monotonic counters per the
        text-exposition ``_bucket{le=...}`` contract, never affected
        by reservoir eviction."""
        with self._lock:
            out: List[Tuple[float, int]] = []
            running = 0
            for le, n in zip(self.bucket_bounds, self._bucket_counts):
                running += n
                out.append((le, running))
            out.append((float("inf"), self._total_count))
            return out

    @property
    def total_sum(self) -> float:
        """Lifetime sum — the exposition's monotonic ``_sum``."""
        with self._lock:
            return self._total_sum

    @property
    def total_count(self) -> int:
        """Lifetime observation count — the exposition's ``_count``."""
        with self._lock:
            return self._total_count

    @property
    def count(self) -> int:
        """Reservoir size (bounded by ``cap``) — the percentile
        window, NOT the exposition counter."""
        with self._lock:
            return len(self._ring)

    @property
    def p50(self) -> Optional[float]:
        return self.percentile(50)

    @property
    def p95(self) -> Optional[float]:
        return self.percentile(95)


class EpochTrace:
    """Phase timestamps for one epoch: propose -> acs_output ->
    [ordered ->] commit (the per-epoch phase timing of SURVEY.md §5.1;
    ``t_ordered`` is set only on the two-frontier path,
    Config.order_then_settle, where commit = settle)."""

    __slots__ = (
        "epoch", "t_propose", "t_acs_output", "t_ordered", "t_commit",
        "n_txs",
    )

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.t_propose: Optional[float] = None
        self.t_acs_output: Optional[float] = None
        self.t_ordered: Optional[float] = None
        self.t_commit: Optional[float] = None
        self.n_txs: int = 0

    @property
    def total_s(self) -> Optional[float]:
        if self.t_propose is None or self.t_commit is None:
            return None
        return self.t_commit - self.t_propose

    @property
    def acs_s(self) -> Optional[float]:
        if self.t_propose is None or self.t_acs_output is None:
            return None
        return self.t_acs_output - self.t_propose

    @property
    def decrypt_s(self) -> Optional[float]:
        if self.t_acs_output is None or self.t_commit is None:
            return None
        return self.t_commit - self.t_acs_output

    @property
    def ordered_s(self) -> Optional[float]:
        """Propose -> ciphertext-ordered commit: the protocol-plane
        latency as the APPLICATION'S ordering sees it."""
        if self.t_propose is None or self.t_ordered is None:
            return None
        return self.t_ordered - self.t_propose

    @property
    def settle_lag_s(self) -> Optional[float]:
        """Ordered -> settled: how long the epoch's plaintext trailed
        its ordering (the decrypt-lag wall)."""
        if self.t_ordered is None or self.t_commit is None:
            return None
        return self.t_commit - self.t_ordered


@guarded_by("_lock", "_traces", "_last_commit_t")
class Metrics:
    """Per-node metrics registry."""

    def __init__(self, trace_cap: int = 1024) -> None:
        self.msgs_in = Counter()
        self.msgs_out = Counter()
        self.epochs_committed = Counter()
        self.txs_committed = Counter()
        # duplicate protocol votes/shares dropped by one-vote-per-
        # sender dedup (RBC echo/ready slots, VoteBank rows, share
        # pools): the counter that makes replay/duplication attacks
        # VISIBLE — before it, absorption happened silently across a
        # dozen private sets
        self.dedup_absorbed = Counter()
        # two-frontier commit (Config.order_then_settle): epochs whose
        # ciphertext ordering committed (the ordered frontier's tally;
        # settlement lands in epochs_committed as before)
        self.epochs_ordered = Counter()
        # dynamic membership (protocol.reconfig): completed roster
        # switches this node activated (joins, retirements, re-keys)
        self.reconfigs_total = Counter()
        # wave-routed ingest (Config.wave_routing): batch handler
        # invocations crossing the router seam into protocol logic
        # (ACS/RBC/BBA/dec-share entry points).  The scalar routing
        # arm counts one per payload; the wave arm counts one per
        # (message kind, delivery wave) — DETERMINISTIC for a seeded
        # schedule, the counter perfgate gates like hub dispatches.
        self.handler_dispatches = Counter()
        # delivery waves the router demuxed (0 on the scalar arm)
        self.waves_routed = Counter()
        # K-deep pipelined frontiers (Config.pipeline_depth): waves
        # whose coalescer flush carried eagerly piggybacked dec
        # shares for a freshly ordered epoch (0 at depth 1 — the
        # eager path is gated to the K-deep plane)
        self.eager_share_waves = Counter()
        self.epoch_latency = Histogram()  # seconds, propose -> commit
        self.acs_latency = Histogram()
        self.decrypt_latency = Histogram()
        # propose -> ciphertext-ordered commit (the ordered frontier's
        # epoch latency) and ordered -> settled (the decrypt lag wall)
        self.ordered_latency = Histogram()
        self.settle_lag_latency = Histogram()
        self._traces: Dict[int, EpochTrace] = {}
        self._trace_cap = trace_cap
        self._t0 = time.monotonic()
        # monotonic instant of the last committed epoch: the SLO
        # watchdog's stall detector measures "time since progress"
        # against this (never-committed reads as age since boot)
        self._last_commit_t: Optional[float] = None
        self._lock = new_lock()
        # transport-health provider (transport.health.PeerHealthTracker
        # .snapshot, set by the host that owns the dial layer): folds a
        # per-peer UP/DEGRADED/DOWN block into snapshot()
        self._transport_health: Optional[Callable[[], Dict]] = None
        # flight-recorder stats provider (utils.trace.TraceRecorder
        # .stats, set by the node when Config.trace is on): folds the
        # {events_recorded, events_dropped, high_water} block in
        self._trace_stats: Optional[Callable[[], Dict]] = None
        # transport frame-counter provider (ChannelNetwork
        # .endpoint_stats / ValidatorHost connection counters): folds
        # {delivered, rejected} into snapshot()["transport"], making
        # MAC rejections reachable without touching private transport
        # internals
        self._transport_stats: Optional[Callable[[], Dict]] = None
        # SLO watchdog provider (utils.watchdog.SloWatchdog
        # .alerts_block, set by the host/cluster that owns the
        # watchdog): folds health + per-alert counters into snapshot()
        self._alerts: Optional[Callable[[], Dict]] = None
        # crypto-hub counter provider (set by the owning HoneyBadger):
        # folds the coin-issue dispatch tallies into snapshot()["hub"]
        # (a cluster-SHARED hub reports cluster-wide numbers on every
        # node, the same convention as bench.py's hub_dispatches)
        self._hub_stats: Optional[Callable[[], Dict]] = None
        # frontier provider (set by the owning HoneyBadger): () ->
        # (ordered_frontier, settled_frontier).  decrypt_lag_epochs =
        # ordered - settled is THE two-frontier health signal — zero on
        # the coupled path, bounded by Config.decrypt_lag_max on the
        # order-then-settle path.
        self._frontiers: Optional[Callable[[], Tuple[int, int]]] = None
        # roster-version provider (set by the owning HoneyBadger):
        # () -> the ACTIVE roster version (0 = the genesis roster)
        self._roster_version: Optional[Callable[[], int]] = None
        # pipeline provider (set by the owning HoneyBadger): () ->
        # the number of epochs currently running RBC/BBA concurrently
        # (proposed, consensus live, not yet ordered) — the K-deep
        # window's in-flight gauge, 1 in steady lockstep
        self._pipeline: Optional[Callable[[], int]] = None
        # WAN-emulation provider (set by the owning cluster when
        # SimulatedCluster(wan_profile=) mounts a link model;
        # WanEmulator.stats): folds the virtual-clock plane's tallies
        # into snapshot()["wan"]
        self._wan_stats: Optional[Callable[[], Dict]] = None
        # ingress-plane provider (set by the owning HoneyBadger:
        # mempool admission tallies + subscriber gauge) — folds into
        # the ALWAYS-present zeroed snapshot()["ingress"] block
        self._ingress: Optional[Callable[[], Dict]] = None
        # lane shard-out provider (set by the owning lane-0 primary:
        # per-lane frontier gauges, merge frontier, partition skew) —
        # folds into the ALWAYS-present snapshot()["lanes"] block
        self._lanes: Optional[Callable[[], Dict]] = None

    def set_transport_health(
        self, provider: Optional[Callable[[], Dict]]
    ) -> None:
        self._transport_health = provider

    def set_transport_stats(
        self, provider: Optional[Callable[[], Dict]]
    ) -> None:
        self._transport_stats = provider

    def set_trace_stats(
        self, provider: Optional[Callable[[], Dict]]
    ) -> None:
        self._trace_stats = provider

    def set_alerts(self, provider: Optional[Callable[[], Dict]]) -> None:
        self._alerts = provider

    def set_hub_stats(
        self, provider: Optional[Callable[[], Dict]]
    ) -> None:
        self._hub_stats = provider

    def set_frontiers(
        self, provider: Optional[Callable[[], Tuple[int, int]]]
    ) -> None:
        self._frontiers = provider

    def set_reconfig(self, provider: Optional[Callable[[], int]]) -> None:
        """Roster-version provider (dynamic membership)."""
        self._roster_version = provider

    def set_pipeline(self, provider: Optional[Callable[[], int]]) -> None:
        """Epochs-in-flight provider (K-deep pipelined frontiers)."""
        self._pipeline = provider

    def set_wan_stats(
        self, provider: Optional[Callable[[], Dict]]
    ) -> None:
        """WAN emulation-plane provider (WanEmulator.stats)."""
        self._wan_stats = provider

    def set_ingress(self, provider: Optional[Callable[[], Dict]]) -> None:
        """Ingress-plane provider (mempool tallies + subscribers)."""
        self._ingress = provider

    def set_lanes(self, provider: Optional[Callable[[], Dict]]) -> None:
        """Lane shard-out provider (Config.lanes: per-lane frontiers,
        merge frontier, partition skew)."""
        self._lanes = provider

    def decrypt_lag_epochs(self) -> int:
        """Ordered frontier - settled frontier (0 when no provider is
        registered, and 0 by construction on the coupled path)."""
        if self._frontiers is None:
            return 0
        ordered, settled = self._frontiers()
        return max(0, ordered - settled)

    def trace(self, epoch: int) -> EpochTrace:
        with self._lock:
            tr = self._traces.get(epoch)
            if tr is None:
                tr = EpochTrace(epoch)
                self._traces[epoch] = tr
                if len(self._traces) > self._trace_cap:
                    del self._traces[min(self._traces)]
            return tr

    def epoch_proposed(self, epoch: int) -> None:
        self.trace(epoch).t_propose = time.monotonic()

    def epoch_acs_output(self, epoch: int) -> None:
        self.trace(epoch).t_acs_output = time.monotonic()

    def epoch_ordered(self, epoch: int) -> None:
        """The ciphertext-ordered commit instant (two-frontier path):
        the ordered frontier advanced past ``epoch``."""
        tr = self.trace(epoch)
        tr.t_ordered = time.monotonic()
        self.epochs_ordered.inc()
        if tr.ordered_s is not None:
            self.ordered_latency.observe(tr.ordered_s)

    def epoch_committed(self, epoch: int, n_txs: int) -> None:
        tr = self.trace(epoch)
        tr.t_commit = time.monotonic()
        tr.n_txs = n_txs
        with self._lock:  # read cross-thread by the SLO watchdog
            self._last_commit_t = tr.t_commit
        self.epochs_committed.inc()
        self.txs_committed.inc(n_txs)
        if tr.total_s is not None:
            self.epoch_latency.observe(tr.total_s)
        if tr.acs_s is not None:
            self.acs_latency.observe(tr.acs_s)
        if tr.decrypt_s is not None:
            self.decrypt_latency.observe(tr.decrypt_s)
        if tr.settle_lag_s is not None:
            self.settle_lag_latency.observe(tr.settle_lag_s)

    def epoch_spans(self) -> List[Tuple[int, float, float]]:
        """(epoch, t_propose, t_commit) for every retained epoch trace
        with both endpoints — the per-epoch serial walls an overlap
        ratio needs (serial sum / elapsed wall > 1 means epochs
        genuinely overlapped)."""
        with self._lock:
            traces = list(self._traces.items())
        return sorted(
            (epoch, t.t_propose, t.t_commit)
            for epoch, t in traces
            if t.t_propose is not None and t.t_commit is not None
        )

    def tx_per_sec(self) -> float:
        dt = time.monotonic() - self._t0
        return self.txs_committed.value / dt if dt > 0 else 0.0

    def last_commit_age_s(self, now: Optional[float] = None) -> float:
        """Seconds (monotonic) since the last committed epoch — since
        construction when nothing committed yet.  ``now`` lets the
        watchdog tests drive synthetic clocks."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            base = (
                self._last_commit_t
                if self._last_commit_t is not None
                else self._t0
            )
        return max(0.0, now - base)

    def snapshot(self) -> Dict[str, object]:
        """One flat dict for logging/export (the BASELINE metrics),
        plus the transport-health block when a dial layer registered
        its provider."""
        out: Dict[str, object] = {
            "msgs_in": self.msgs_in.value,
            "msgs_out": self.msgs_out.value,
            "epochs_committed": self.epochs_committed.value,
            "txs_committed": self.txs_committed.value,
            "tx_per_sec": round(self.tx_per_sec(), 3),
            "epoch_p50_s": self.epoch_latency.p50,
            "epoch_p95_s": self.epoch_latency.p95,
            "acs_p50_s": self.acs_latency.p50,
            "decrypt_p50_s": self.decrypt_latency.p50,
        }
        # two-frontier block: ALWAYS present (zeroed on the coupled
        # path) — same appear/disappear contract as "transport" below
        frontiers: Dict[str, object] = {
            "epochs_ordered": self.epochs_ordered.value,
            "ordered_p50_s": self.ordered_latency.p50,
            "settle_lag_p50_s": self.settle_lag_latency.p50,
            "decrypt_lag_epochs": 0,
            "ordered_frontier": 0,
            "settled_frontier": 0,
        }
        if self._frontiers is not None:
            ordered, settled = self._frontiers()
            frontiers["ordered_frontier"] = ordered
            frontiers["settled_frontier"] = settled
            frontiers["decrypt_lag_epochs"] = max(0, ordered - settled)
        out["frontiers"] = frontiers
        # reconfig block: ALWAYS present with every key, zeroed on
        # fixed-roster nodes (the schema-stability rule — a
        # scraper must never see a key appear/disappear between
        # snapshots because a roster happened to change)
        reconfig: Dict[str, object] = {
            "roster_version": 0,
            "reconfigs_total": self.reconfigs_total.value,
        }
        if self._roster_version is not None:
            reconfig["roster_version"] = int(self._roster_version())
        out["reconfig"] = reconfig
        # wave-routing block: ALWAYS present with every key, zeroed on
        # the scalar arm / bare nodes (the schema-stability rule
        # — scrapers and the timeseries sampler must never see a key
        # appear or disappear between snapshots)
        out["router"] = {
            "handler_dispatches": self.handler_dispatches.value,
            "waves_routed": self.waves_routed.value,
        }
        # K-deep pipeline block: ALWAYS present with every key,
        # zeroed at depth 1 / on bare nodes (same schema rule)
        pipeline: Dict[str, object] = {
            "epochs_in_flight": 0,
            "eager_share_waves": self.eager_share_waves.value,
        }
        if self._pipeline is not None:
            pipeline["epochs_in_flight"] = int(self._pipeline())
        out["pipeline"] = pipeline
        # every transport key is ALWAYS present (zeroed when no frame
        # counters registered): scrapers and the timeseries sampler
        # must never see a key appear/disappear between snapshots —
        # nodes without a transport provider (bare HoneyBadger, early
        # boot) used to omit delivered/rejected entirely
        transport: Dict[str, object] = {
            "delivered": 0,
            "rejected": 0,
            "dedup_absorbed": self.dedup_absorbed.value,
            # delivery-plane counters (Config.delivery_columnar): the
            # schema-stability rule — every key present and
            # zeroed on EVERY path (scalar arm, bare HoneyBadger,
            # early boot); transports with counters overwrite below
            "frames_decoded": 0,
            "decode_memo_hits": 0,
            "decode_memo_misses": 0,
            "mac_verify_batches": 0,
            # egress-plane twins (Config.egress_columnar): same
            # zeroed-key schema rule on both egress arms
            "frames_encoded": 0,
            "encode_memo_hits": 0,
            "encode_memo_misses": 0,
            "mac_sign_batches": 0,
        }
        if self._transport_stats is not None:
            transport.update(self._transport_stats())
        out["transport"] = transport
        # crypto-hub block: ALWAYS present with every key, zeroed on
        # bare nodes (the schema-stability rule); the coin-issue
        # dispatch tallies are counted on BOTH egress arms, so the
        # scalar arm reports its per-node-per-drain batches here too
        hub: Dict[str, object] = {
            "coin_share_batches": 0,
            "coin_share_items": 0,
        }
        if self._hub_stats is not None:
            hub.update(self._hub_stats())
        out["hub"] = hub
        # WAN-emulation block: ALWAYS present with every key, zeroed
        # on real transports / unmounted profiles (the schema
        # rule); with SimulatedCluster(wan_profile=) the emulator's
        # provider overwrites with the virtual-clock plane's tallies
        wan: Dict[str, object] = {
            "enabled": 0,
            "profile": "",
            "frames_delayed": 0,
            "retransmits": 0,
            "straggler_episodes": 0,
            "virtual_time_ms": 0,
        }
        if self._wan_stats is not None:
            wan.update(self._wan_stats())
        out["wan"] = wan
        # ingress block: ALWAYS present with every key, zeroed on
        # nodes without a mounted mempool (the schema rule);
        # with Config.mempool_capacity > 0 the owning node's provider
        # overwrites with the admission pipeline's tallies
        ingress: Dict[str, object] = {
            "submitted": 0,
            "admitted": 0,
            "rejected": 0,
            "retried": 0,
            "deduped": 0,
            "evicted": 0,
            "subscribers": 0,
            "mempool_depth": 0,
        }
        if self._ingress is not None:
            ingress.update(self._ingress())
        out["ingress"] = ingress
        # lane shard-out block: ALWAYS present with every key (the
        # schema-stability rule) — a single-lane node reports
        # lanes=1 with one-element gauge lists, so scrapers see the
        # same shape at every S
        lanes: Dict[str, object] = {
            "lanes": 1,
            "merge_frontier": 0,
            "ordered_epochs": [0],
            "settled_epochs": [0],
            "lane_fill": [0],
            "partition_skew": 0,
        }
        if self._lanes is not None:
            lanes.update(self._lanes())
        out["lanes"] = lanes
        if self._transport_health is not None:
            out["transport_health"] = self._transport_health()
        if self._trace_stats is not None:
            out["trace"] = self._trace_stats()
        if self._alerts is not None:
            out["alerts"] = self._alerts()
        return out


__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Histogram",
    "EpochTrace",
    "Metrics",
]
