"""Scrapeable telemetry endpoints: /metrics, /healthz, /vars.

Thetacrypt (PAPERS.md, arxiv 2502.03247) frames threshold crypto as a
*service* — and a service has an operational surface: health probes,
per-request metrics, something a fleet scheduler can scrape.  The
reference has none; this module gives every validator one, stdlib-only
(the container bakes no prometheus_client), opt-in via
``Config.obs_port``:

- ``/metrics``  Prometheus text exposition (version 0.0.4): counters,
  epoch-latency histograms with cumulative buckets, transport frame /
  dedup counters, per-peer dial health, flight-recorder stats, SLO
  alert counters, and the health verdict as a gauge.
- ``/healthz``  UP/DEGRADED/DOWN (HTTP 503 on DOWN) derived from the
  SLO watchdogs (utils/watchdog.py) + peer health — each GET runs the
  watchdog checks, so probes see fresh verdicts even with no sampler
  thread running.
- ``/vars``     the full ``Metrics.snapshot()`` JSON plus the bounded
  time-series rings (utils/timeseries.py) — the debugging firehose.

One ``ObsServer`` can front many nodes (the SimulatedCluster exposes
its whole roster through one port, each sample labeled
``node="..."``); a ValidatorHost runs its own single-target server.
Binds 127.0.0.1 only: telemetry is an operator surface, not a roster
protocol — nothing here is MAC'd and nothing must reach the open
network.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

from cleisthenes_tpu_torch.utils.metrics import Histogram, Metrics
from cleisthenes_tpu_torch.utils.watchdog import (
    DEGRADED,
    DOWN,
    UP,
    SloWatchdog,
    worst_health,
)

CONTENT_TYPE_PROM = "text/plain; version=0.0.4; charset=utf-8"

_HEALTH_GAUGE = {UP: 2, DEGRADED: 1, DOWN: 0}


def escape_label_value(v: object) -> str:
    """Prometheus text-format label escaping: backslash, double quote
    and newline (in THAT order — escaping the escapes first)."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if isinstance(v, int) or float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Exposition:
    """Accumulates samples grouped into metric families, so a
    multi-node scrape emits each # HELP/# TYPE header exactly once."""

    def __init__(self, prefix: str = "cleisthenes") -> None:
        self.prefix = prefix
        self._families: Dict[str, List[str]] = {}
        self._headers: Dict[str, str] = {}

    def family(self, name: str, kind: str, help_text: str) -> str:
        full = f"{self.prefix}_{name}"
        if full not in self._families:
            self._families[full] = []
            self._headers[full] = (
                f"# HELP {full} {help_text}\n# TYPE {full} {kind}"
            )
        return full

    def add(self, full: str, labels: Dict[str, object], value: float,
            suffix: str = "") -> None:
        lab = ",".join(
            f'{k}="{escape_label_value(v)}"' for k, v in labels.items()
        )
        self._families[full].append(
            f"{full}{suffix}{{{lab}}} {_fmt(value)}"
        )

    def render(self) -> str:
        out: List[str] = []
        for full, samples in self._families.items():
            out.append(self._headers[full])
            out.extend(samples)
        return "\n".join(out) + "\n"


def _expose_histogram(
    exp: _Exposition,
    name: str,
    help_text: str,
    hist: Histogram,
    labels: Dict[str, object],
) -> None:
    full = exp.family(name, "histogram", help_text)
    for le, count in hist.cumulative_buckets():
        exp.add(full, {**labels, "le": _fmt(le)}, count, suffix="_bucket")
    # lifetime tallies: the histogram type contract wants monotonic
    # counters (the percentile reservoir is a recency window)
    exp.add(full, labels, hist.total_sum, suffix="_sum")
    exp.add(full, labels, hist.total_count, suffix="_count")


class ObsTarget:
    """One scrapeable node: its metrics registry plus (optionally) the
    SLO watchdog and time-series sampler wired around it."""

    def __init__(
        self,
        node_id: str,
        metrics: Metrics,
        watchdog: Optional[SloWatchdog] = None,
        sampler=None,
    ) -> None:
        self.node_id = node_id
        self.metrics = metrics
        self.watchdog = watchdog
        self.sampler = sampler

    def health(self) -> str:
        if self.watchdog is None:
            return UP
        return self.watchdog.check()


def render_prometheus(targets: Sequence[ObsTarget]) -> str:
    """The /metrics body for a set of targets, each sample labeled by
    its node id."""
    exp = _Exposition()
    for t in targets:
        m = t.metrics
        labels = {"node": t.node_id}
        snap = m.snapshot()
        for name, counter, help_text in (
            ("msgs_in_total", m.msgs_in, "logical protocol messages received"),
            ("msgs_out_total", m.msgs_out, "logical protocol messages sent"),
            ("epochs_committed_total", m.epochs_committed,
             "epochs committed (consensus + catch-up adoption)"),
            ("txs_committed_total", m.txs_committed,
             "transactions committed"),
        ):
            exp.add(
                exp.family(name, "counter", help_text),
                labels,
                counter.value,
            )
        exp.add(
            exp.family("tx_per_sec", "gauge",
                       "committed transaction throughput since boot"),
            labels,
            float(snap["tx_per_sec"]),
        )
        for hname, hist, help_text in (
            ("epoch_latency_seconds", m.epoch_latency,
             "propose -> commit wall time per epoch"),
            ("acs_latency_seconds", m.acs_latency,
             "propose -> ACS output wall time per epoch"),
            ("decrypt_latency_seconds", m.decrypt_latency,
             "ACS output -> commit (threshold decryption) per epoch"),
            ("ordered_latency_seconds", m.ordered_latency,
             "propose -> ciphertext-ordered commit (two-frontier "
             "ordered frontier)"),
            ("settle_lag_seconds", m.settle_lag_latency,
             "ordered -> settled (trailing decrypt frontier lag)"),
        ):
            _expose_histogram(exp, hname, help_text, hist, labels)
        frontiers = snap["frontiers"]
        exp.add(
            exp.family(
                "epochs_ordered_total", "counter",
                "epochs whose ciphertext ordering committed "
                "(two-frontier commit split)",
            ),
            labels,
            int(frontiers["epochs_ordered"]),
        )
        exp.add(
            exp.family(
                "decrypt_lag_epochs", "gauge",
                "ordered frontier - settled frontier (0 on the "
                "coupled path; bounded by decrypt_lag_max)",
            ),
            labels,
            int(frontiers["decrypt_lag_epochs"]),
        )
        # dynamic-membership counters (always present — zeroed on
        # fixed-roster nodes per the schema-stability rule)
        reconfig = snap["reconfig"]
        exp.add(
            exp.family(
                "roster_version", "gauge",
                "the ACTIVE roster version (0 = genesis; bumps at "
                "every RECONFIG activation boundary)",
            ),
            labels,
            int(reconfig["roster_version"]),
        )
        exp.add(
            exp.family(
                "reconfigs_total", "counter",
                "completed roster switches activated by this node "
                "(joins, retirements, re-keys)",
            ),
            labels,
            int(reconfig["reconfigs_total"]),
        )
        transport = snap["transport"]
        frames = exp.family(
            "transport_frames_total", "counter",
            "inbound wire frames by verification result",
        )
        for result in ("delivered", "rejected"):
            exp.add(
                frames, {**labels, "result": result},
                int(transport[result]),
            )
        exp.add(
            exp.family(
                "dedup_absorbed_total", "counter",
                "duplicate protocol votes/shares absorbed by dedup",
            ),
            labels,
            int(transport["dedup_absorbed"]),
        )
        # delivery-plane columnarization counters (always present —
        # zeroed on the scalar arm per the schema-stability rule)
        exp.add(
            exp.family(
                "transport_frames_decoded_total", "counter",
                "inbound payload decodes actually executed "
                "(shared-prefix memo hits skip the decode)",
            ),
            labels,
            int(transport["frames_decoded"]),
        )
        memo = exp.family(
            "transport_decode_memo_total", "counter",
            "shared-prefix frame-decode memo probes by result",
        )
        for result, key in (
            ("hit", "decode_memo_hits"),
            ("miss", "decode_memo_misses"),
        ):
            exp.add(
                memo, {**labels, "result": result}, int(transport[key])
            )
        exp.add(
            exp.family(
                "transport_mac_verify_batches_total", "counter",
                "authenticator verify invocations (one per wave batch "
                "columnar; one per frame scalar)",
            ),
            labels,
            int(transport["mac_verify_batches"]),
        )
        # egress-columnarization counters (always present —
        # zeroed on the scalar arm per the schema-stability rule)
        exp.add(
            exp.family(
                "transport_frames_encoded_total", "counter",
                "outbound payload bodies actually encoded "
                "(shared-prefix encode memo hits skip the encode)",
            ),
            labels,
            int(transport["frames_encoded"]),
        )
        ememo = exp.family(
            "transport_encode_memo_total", "counter",
            "shared-prefix frame-encode memo probes by result",
        )
        for result, key in (
            ("hit", "encode_memo_hits"),
            ("miss", "encode_memo_misses"),
        ):
            exp.add(
                ememo, {**labels, "result": result}, int(transport[key])
            )
        exp.add(
            exp.family(
                "transport_mac_sign_batches_total", "counter",
                "authenticator sign invocations (one per egress wave "
                "columnar; one per post scalar)",
            ),
            labels,
            int(transport["mac_sign_batches"]),
        )
        hub = snap["hub"]
        exp.add(
            exp.family(
                "coin_share_batches_total", "counter",
                "native coin-share issue dispatches (one per staged "
                "pool per wave columnar; one per node per drain "
                "scalar)",
            ),
            labels,
            int(hub["coin_share_batches"]),
        )
        exp.add(
            exp.family(
                "coin_share_items_total", "counter",
                "coin shares issued through the batched coin kernels",
            ),
            labels,
            int(hub["coin_share_items"]),
        )
        # wave-routed ingest counters (always present — zeroed on the
        # scalar routing arm per the schema-stability rule)
        router = snap["router"]
        exp.add(
            exp.family(
                "router_handler_dispatches_total", "counter",
                "batch handler invocations crossing the router seam "
                "(one per payload scalar; one per kind per wave routed)",
            ),
            labels,
            int(router["handler_dispatches"]),
        )
        exp.add(
            exp.family(
                "router_waves_total", "counter",
                "delivery waves demuxed by the wave router",
            ),
            labels,
            int(router["waves_routed"]),
        )
        # K-deep pipelined-frontier counters (always present — zeroed
        # at depth 1 per the schema-stability rule)
        pipeline = snap["pipeline"]
        exp.add(
            exp.family(
                "pipeline_epochs_in_flight", "gauge",
                "epochs running RBC/BBA concurrently in the K-deep "
                "window (1 in steady lockstep)",
            ),
            labels,
            int(pipeline["epochs_in_flight"]),
        )
        exp.add(
            exp.family(
                "pipeline_eager_share_waves_total", "counter",
                "delivery waves whose flush carried eagerly "
                "piggybacked dec shares for a freshly ordered epoch",
            ),
            labels,
            int(pipeline["eager_share_waves"]),
        )
        # WAN emulation-plane counters (always present — zeroed on
        # real transports / unmounted profiles per the schema rule)
        wan = snap["wan"]
        exp.add(
            exp.family(
                "wan_enabled", "gauge",
                "1 while a seeded WAN link-model profile is mounted "
                "on the channel transport",
            ),
            labels,
            int(wan["enabled"]),
        )
        exp.add(
            exp.family(
                "wan_frames_delayed_total", "counter",
                "frames priced past their admission instant by the "
                "link model (latency/loss/bandwidth/straggler)",
            ),
            labels,
            int(wan["frames_delayed"]),
        )
        exp.add(
            exp.family(
                "wan_retransmits_total", "counter",
                "emulated reliable-transport retransmissions (each "
                "seeded loss adds one RTO to the delivery deadline)",
            ),
            labels,
            int(wan["retransmits"]),
        )
        exp.add(
            exp.family(
                "wan_straggler_episodes_total", "counter",
                "heavy-tailed straggler episodes started across the "
                "roster's node processes",
            ),
            labels,
            int(wan["straggler_episodes"]),
        )
        exp.add(
            exp.family(
                "wan_virtual_time_seconds", "gauge",
                "the emulation plane's virtual clock (never wall "
                "time; advances only at delivery deadlines)",
            ),
            labels,
            int(wan["virtual_time_ms"]) / 1e3,
        )
        # client ingress-plane counters (always present — zeroed
        # when no mempool is mounted per the schema rule)
        ingress = snap["ingress"]
        exp.add(
            exp.family(
                "ingress_submitted_total", "counter",
                "client transactions offered to the admission stage "
                "(every one got an explicit ack verdict)",
            ),
            labels,
            int(ingress["submitted"]),
        )
        exp.add(
            exp.family(
                "ingress_admitted_total", "counter",
                "submissions admitted into the fee-priority mempool",
            ),
            labels,
            int(ingress["admitted"]),
        )
        exp.add(
            exp.family(
                "ingress_rejected_total", "counter",
                "submissions rejected outright (malformed, "
                "oversized, negative fee)",
            ),
            labels,
            int(ingress["rejected"]),
        )
        exp.add(
            exp.family(
                "ingress_retried_total", "counter",
                "submissions answered RETRY_AFTER (per-client cap "
                "or global pressure — explicit backpressure, never "
                "a silent drop)",
            ),
            labels,
            int(ingress["retried"]),
        )
        exp.add(
            exp.family(
                "ingress_deduped_total", "counter",
                "submissions absorbed by the bounded seen-ring "
                "(already pending, in flight, or recently settled)",
            ),
            labels,
            int(ingress["deduped"]),
        )
        exp.add(
            exp.family(
                "ingress_evicted_total", "counter",
                "pending entries bumped by higher-priority "
                "newcomers under capacity pressure",
            ),
            labels,
            int(ingress["evicted"]),
        )
        exp.add(
            exp.family(
                "ingress_subscribers", "gauge",
                "open committed-batch subscription feeds",
            ),
            labels,
            int(ingress["subscribers"]),
        )
        exp.add(
            exp.family(
                "ingress_mempool_depth", "gauge",
                "live mempool entries (pending + drained-in-flight) "
                "— the depth the queue-backpressure watchdog reads",
            ),
            labels,
            int(ingress["mempool_depth"]),
        )
        # lane shard-out families (always present — the lanes block
        # is in every snapshot, collapsed to one lane at Config.lanes=1)
        lanes_blk = snap["lanes"]
        exp.add(
            exp.family(
                "lane_count", "gauge",
                "configured consensus lanes (Config.lanes; 1 = the "
                "single-lane build)",
            ),
            labels,
            int(lanes_blk["lanes"]),
        )
        exp.add(
            exp.family(
                "lane_merge_frontier", "gauge",
                "merge-emitted total-order slots (== the settled "
                "epoch count at one lane)",
            ),
            labels,
            int(lanes_blk["merge_frontier"]),
        )
        exp.add(
            exp.family(
                "lane_partition_skew", "gauge",
                "max-min lifetime admissions across lanes (the "
                "tx-hash partitioner's balance witness)",
            ),
            labels,
            int(lanes_blk["partition_skew"]),
        )
        for k, v in enumerate(lanes_blk["ordered_epochs"]):
            exp.add(
                exp.family(
                    "lane_ordered_epochs", "gauge",
                    "per-lane ordered frontier (labeled by lane)",
                ),
                {**labels, "lane": k},
                int(v),
            )
        for k, v in enumerate(lanes_blk["settled_epochs"]):
            exp.add(
                exp.family(
                    "lane_settled_epochs", "gauge",
                    "per-lane settled frontier (labeled by lane)",
                ),
                {**labels, "lane": k},
                int(v),
            )
        for k, v in enumerate(lanes_blk["lane_fill"]):
            exp.add(
                exp.family(
                    "lane_fill_total", "counter",
                    "lifetime mempool admissions per lane (labeled "
                    "by lane)",
                ),
                {**labels, "lane": k},
                int(v),
            )
        for peer, ph in snap.get("transport_health", {}).items():
            plabels = {**labels, "peer": peer}
            exp.add(
                exp.family(
                    "peer_health", "gauge",
                    "dial-layer peer state (labeled; value always 1)",
                ),
                {**plabels, "state": ph["state"]},
                1,
            )
            exp.add(
                exp.family("peer_reconnects_total", "counter",
                           "successful re-establishments after a loss"),
                plabels,
                int(ph["reconnects"]),
            )
            exp.add(
                exp.family("peer_dial_failures_total", "counter",
                           "failed dial attempts"),
                plabels,
                int(ph["dial_failures"]),
            )
        tr = snap.get("trace")
        if tr is not None:
            exp.add(
                exp.family("trace_events_recorded_total", "counter",
                           "flight-recorder events recorded"),
                labels,
                int(tr["events_recorded"]),
            )
            exp.add(
                exp.family("trace_events_dropped_total", "counter",
                           "flight-recorder ring-overflow drops"),
                labels,
                int(tr["events_dropped"]),
            )
        for alert, st in snap.get("alerts", {}).items():
            alabels = {**labels, "alert": alert}
            exp.add(
                exp.family("alerts_total", "counter",
                           "SLO watchdog firings (inactive->active)"),
                alabels,
                int(st["count"]),
            )
            exp.add(
                exp.family("alert_active", "gauge",
                           "1 while the named SLO alert is active"),
                alabels,
                1 if st["active"] else 0,
            )
        if t.watchdog is not None:
            exp.add(
                exp.family("health", "gauge",
                           "node health: 2=up 1=degraded 0=down"),
                labels,
                _HEALTH_GAUGE[t.watchdog.health()],
            )
    return exp.render()


class ObsServer:
    """The localhost telemetry listener (ThreadingHTTPServer on a
    daemon thread).  ``port=0`` binds an ephemeral port; read
    ``.port`` after ``start()``."""

    def __init__(
        self,
        targets: Sequence[ObsTarget],
        port: int = 0,
        host: str = "127.0.0.1",
    ) -> None:
        self.targets = list(targets)
        self._host = host
        self._requested_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def add_target(self, target: ObsTarget) -> None:
        """Fold one more node into the scrape (dynamic membership: a
        JOINER wired in mid-run).  List append is atomic under the
        GIL and request handlers only iterate, so no lock is needed
        for the read-mostly pattern here."""
        self.targets.append(target)

    # -- endpoint bodies (also the in-proc testing surface) ----------------

    def metrics_text(self) -> str:
        for t in self.targets:
            t.health()  # run watchdog checks: scrapes see fresh state
        return render_prometheus(self.targets)

    def healthz(self) -> Dict[str, object]:
        nodes = {t.node_id: t.health() for t in self.targets}
        return {"status": worst_health(nodes.values()), "nodes": nodes}

    def vars(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for t in self.targets:
            entry: Dict[str, object] = {"metrics": t.metrics.snapshot()}
            if t.sampler is not None:
                entry["timeseries"] = {
                    name: points
                    for name, points in t.sampler.series().items()
                }
                entry["sampler"] = t.sampler.stats()
            out[t.node_id] = entry
        return out

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> int:
        if self._httpd is not None:
            return self.port  # type: ignore[return-value]
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet: NodeLogger owns stdout
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(
                            200,
                            server.metrics_text().encode("utf-8"),
                            CONTENT_TYPE_PROM,
                        )
                    elif path == "/healthz":
                        doc = server.healthz()
                        self._send(
                            503 if doc["status"] == DOWN else 200,
                            (json.dumps(doc) + "\n").encode("utf-8"),
                            "application/json",
                        )
                    elif path == "/vars":
                        self._send(
                            200,
                            (json.dumps(server.vars()) + "\n").encode(
                                "utf-8"
                            ),
                            "application/json",
                        )
                    else:
                        self._send(
                            404, b"not found\n", "text/plain"
                        )
                except Exception as exc:  # scrape must never kill the server
                    try:
                        self._send(
                            500,
                            f"scrape failed: {exc!r}\n".encode("utf-8"),
                            "text/plain",
                        )
                    except OSError:
                        pass  # peer already hung up

        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), Handler
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"obs-http:{self.port}",
            daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)


__all__ = [
    "CONTENT_TYPE_PROM",
    "ObsServer",
    "ObsTarget",
    "escape_label_value",
    "render_prometheus",
]
