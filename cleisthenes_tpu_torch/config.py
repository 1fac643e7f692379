"""Single framework configuration object.

The reference declares an (empty) ``Config`` struct as the intended
one-stop config (reference cleisthenes.go:3-4, consumed by
``NewRBC(config cleisthenes.Config)`` at rbc/rbc.go:38); its real knobs
live in constructor args (``NewHoneyBadger(batchSize, nodes)``,
honeybadger.go:36) and constants (``DefaultDialTimeout = 3s``,
comm.go:107-109; channel caps 200, conn.go:60-61).  Here the config is a
real dataclass carrying every knob, including the TPU-build additions:
``crypto_backend`` (the ``--crypto=tpu`` flag from BASELINE.json) and
the device-mesh layout for the batched crypto plane.

This is the PyTorch port's copy of ``cleisthenes_tpu/config.py``.  It
differs in three places: ``crypto_backend`` takes ``'cuda'`` (the
default, hand-written CUDA kernels on an NVIDIA GPU), ``'cpu'`` or
``'cpp'`` (in place of the reference's ``'tpu'``);
the new ``device`` field names the torch device the ``'cuda'`` backend
runs on (tests pass ``device='cpu'`` to run the kernels' plain PyTorch
versions); ``mesh_shape`` shards the ``'cuda'`` crypto plane over the
cards (parallel/mesh.py ``CryptoMesh``: explicit tiles, one launch a
device, where the reference lets GSPMD partition).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


DEFAULT_DIAL_TIMEOUT_S = 3.0  # reference comm.go:107-109
# K-deep pipelined frontiers (Config.pipeline_depth): the protocol
# plane may run at most this many epochs' RBC/BBA concurrently.  The
# cap is the demux window's forward horizon
# (protocol.honeybadger.EPOCH_HORIZON, cross-checked there): an
# in-flight epoch past the horizon could not be delivered to a peer
# at the same frontier.
MAX_PIPELINE_DEPTH = 8
# Horizontal shard-out (Config.lanes): at most this many parallel
# consensus lanes over one roster.  The cap bounds the per-node state
# multiplier (S lane instances share one hub/coalescer/WAL) and keeps
# the lane id in a u32 wire field with headroom to spare.
MAX_LANES = 8
DEFAULT_CHANNEL_CAPACITY = 200  # reference conn.go:60-61 (out/read chans)
# Self-healing dial layer (transport/host.py): first retry delay and
# the cap of the exponential backoff.  The reference redials never
# (a lost stream stays lost); a fixed-interval retry is the other
# failure mode — it synchronizes a whole roster's redial storms.
DEFAULT_DIAL_RETRY_BASE_S = 0.05
DEFAULT_DIAL_RETRY_MAX_S = 5.0


@dataclasses.dataclass
class Config:
    """Framework-wide configuration.

    Attributes:
      n: number of validators in the network (N).
      f: Byzantine fault budget; requires N >= 3f+1
         (reference docs/BBA-EN.md:26, docs/HONEYBADGER-EN.md:35).
         Defaults to floor((n-1)/3), the maximum tolerable.
      batch_size: target committed transactions per epoch (B). The
        effective per-node proposal is B/N randomly sampled from the
        head of the queue (reference honeybadger.go:36-49,62-104;
        docs/HONEYBADGER-EN.md:49-56).
      crypto_backend: 'cuda' (default: the RBC data plane in
        hand-written CUDA kernels, ops/rs_cuda.py and
        ops/sha256_cuda.py), 'cpu' (numpy + native host kernels) or
        'cpp' (the GF(2^8) codec in the native host kernel, the rest
        as 'cpu') — the BatchCrypto/ErasureCoder seam from
        BASELINE.json.
      device: torch device of the 'cuda' backend ('cuda' default,
        'cuda:N', or 'cpu' to run the kernels' plain PyTorch versions
        — the tests' setting).  A CUDA device on a machine without a
        GPU makes backend construction raise; nothing falls back.
      dial_timeout_s: client dial timeout (reference comm.go:107-109).
      dial_retry_base_s / dial_retry_max_s: redial policy for the
        self-healing gRPC transport — capped exponential backoff with
        seeded jitter, both for boot-time dials and for streams lost
        mid-run (transport/host.py, transport/health.py).
      channel_capacity: per-connection mailbox depth (conn.go:60-61).
      ledger_fsync: fsync-on-commit policy for the durable batch log
        (core/ledger.py).  False (default) flushes to the OS on every
        append — surviving process crashes; True additionally fsyncs —
        surviving host power loss, at ~ms/commit cost.
      ledger_checkpoint_every: append a dedup-set checkpoint record to
        the batch log every this-many commits, so a restart seeds the
        duplicate filter from the checkpoint instead of re-deriving it
        from every logged batch.  0 disables checkpointing.
      seed: None (default) draws batch-sampling randomness from the OS
        CSPRNG — production mode, keeping proposal selection
        unpredictable (part of HBBFT's censorship-resistance story).
        An int makes sampling deterministic, for tests/benchmarks only.
      coin_seed: shared setup seed for the threshold common-coin and
        TPKE key generation in trusted-dealer mode.
      mesh_shape: optional ('v', 'l') device-mesh layout — (validator
        axis, shard-length axis) — for sharding the crypto plane
        across devices via parallel.mesh.CryptoMesh; None means
        single-device.  Only consumed by the 'cuda' backend, whose mesh
        takes v*l handles of the CPU on device='cpu' and the first v*l
        cards otherwise (fewer visible cards raise).
      trace: enable the per-node flight recorder (utils/trace.py):
        quorum crossings, hub flushes, wave boundaries and WAL
        appends record into a bounded ring, mergeable into one
        Perfetto-loadable artifact by tools/tracetool.py.  False (the
        default) constructs NO recorder at all — instrumentation
        sites hold None and the hot path pays one identity check.
      trace_buffer: per-node trace ring capacity (newest events win;
        overflow counts as drops in Metrics.snapshot()["trace"]).
      obs_port: opt-in live telemetry endpoints (transport/obs_http.py):
        None (default) serves nothing; 0 binds an ephemeral localhost
        port (tests/demo); N binds 127.0.0.1:N.  Serves /metrics
        (Prometheus text exposition), /healthz (UP/DEGRADED/DOWN from
        peer health + SLO watchdogs) and /vars (full JSON snapshot +
        sampled time series) on ValidatorHost and SimulatedCluster.
      obs_sample_period_s: telemetry sampling cadence for the bounded
        time-series rings (utils/timeseries.py) when the obs plane is
        on; each tick also runs the SLO watchdog checks.
      slo_stall_factor / slo_stall_grace_s: the epoch-stall watchdog's
        commit budget is max(grace, factor * recent epoch p50) — no
        commit within it while txs are pending flips health to DOWN
        (utils/watchdog.py).
      slo_queue_depth: pending-transaction depth above which the
        backpressure alarm fires (ingress outrunning commit).
      slo_peer_lag_epochs: epoch-frontier gap above which a trailing
        peer counts as lagging (peer-lag detector; in-proc clusters).
      order_then_settle: two-frontier commit split (see the field
        comment below): ciphertext-ordered commit at ACS output, with
        threshold decryption trailing in an idle-driven settler.
      pipeline_depth: K-deep pipelined frontiers (see the field
        comment below): epochs [ordered frontier, ordered frontier +
        K - 1] run their RBC propose/ECHO/READY and BBA rounds
        concurrently; ordering still advances strictly in epoch
        order and parks at decrypt_lag_max.  1 (lockstep — only the
        frontier epoch runs, today's pre-K behavior byte-identically)
        .. MAX_PIPELINE_DEPTH (the demux window's forward horizon).
        Effective only on the pipelined two-frontier path
        (epoch_pipelining and order_then_settle both on — the
        epoch_pipelining arm flag gates the whole K-deep plane).
      decrypt_lag_max: backpressure bound on ordered-ahead epochs
        (ordered frontier - settled frontier); also the settle-stall
        SLO watchdog's lag budget.
      reconfig_lead: dynamic membership (protocol.reconfig): epochs
        between the settlement completing a reshare ceremony and the
        new roster's activation; must exceed pipeline_depth +
        decrypt_lag_max so the activation boundary lands past every
        epoch the old roster could already have ordered OR still
        have in flight in the K-deep window.
      delivery_columnar: columnar inbound delivery plane — wave-batched
        MAC verification + shared-prefix frame-decode memoization on
        both transports (see the field comment below).  False is the
        scalar byte-equivalence arm.
      wave_routing: wave-routed protocol ingest — the routing-layer
        twin of delivery_columnar: one batch handler dispatch per
        (message kind, delivery wave) through protocol.router's
        WaveRouter instead of one Python call chain per payload (see
        the field comment below).  False is the scalar per-payload
        routing comparison arm.
      egress_columnar: columnar outbound plane — one batched
        encode+MAC-sign pass per node per wave (Authenticator
        .sign_wire_wave + FrameEncodeMemo), coalesced frame writes,
        and wave-batched native coin-share issue through the hub's
        coin column (see the field comment below).  False is the
        scalar per-send egress comparison arm.
      epoch_pipelining, hub_wave_flush, mempool_*, ingress_port,
        attested_log, reduced_quorum, lanes: the reference's
        asynchronous-plane knobs (cleisthenes_tpu/config.py documents
        them), kept so a configuration carries across unchanged.  The
        lockstep epoch reads n, f, batch_size, crypto_backend and
        device; reduced_quorum (which needs attested_log) changes f's
        default to floor((n-1)/2) and the n >= 2f+1 check.
    """

    n: int = 4
    f: Optional[int] = None
    batch_size: int = 256
    crypto_backend: str = "cuda"
    device: str = "cuda"
    dial_timeout_s: float = DEFAULT_DIAL_TIMEOUT_S
    dial_retry_base_s: float = DEFAULT_DIAL_RETRY_BASE_S
    dial_retry_max_s: float = DEFAULT_DIAL_RETRY_MAX_S
    channel_capacity: int = DEFAULT_CHANNEL_CAPACITY
    ledger_fsync: bool = False
    ledger_checkpoint_every: int = 32
    seed: Optional[int] = None
    coin_seed: int = 1
    mesh_shape: Optional[tuple] = None
    trace: bool = False
    trace_buffer: int = 1 << 16
    obs_port: Optional[int] = None
    obs_sample_period_s: float = 1.0
    slo_stall_factor: float = 8.0
    slo_stall_grace_s: float = 10.0
    slo_queue_depth: int = 100_000
    slo_peer_lag_epochs: int = 8
    epoch_pipelining: bool = True
    hub_wave_flush: bool = True
    order_then_settle: bool = True
    delivery_columnar: bool = True
    wave_routing: bool = True
    egress_columnar: bool = True
    pipeline_depth: int = 2
    decrypt_lag_max: int = 4
    reconfig_lead: int = 8
    mempool_capacity: int = 0
    mempool_client_cap: int = 64
    mempool_seen_cap: int = 1 << 16
    mempool_retry_after_ms: int = 100
    ingress_port: Optional[int] = None
    attested_log: bool = False
    reduced_quorum: bool = False
    lanes: int = 1

    def __post_init__(self) -> None:
        if self.n < 1:
            raise ValueError(f"n={self.n} must be >= 1")
        if self.reduced_quorum and not self.attested_log:
            raise ValueError(
                "reduced_quorum=True requires attested_log=True: the "
                "n-f quorum intersection argument only holds once "
                "equivocation is excluded by the attested sender log"
            )
        if self.f is None:
            self.f = (
                (self.n - 1) // 2
                if self.reduced_quorum
                else (self.n - 1) // 3
            )
        if self.f < 0:
            raise ValueError(f"f={self.f} must be >= 0")
        if self.reduced_quorum:
            if self.n < 2 * self.f + 1:
                raise ValueError(
                    f"n={self.n} must be >= 2f+1={2 * self.f + 1} "
                    "in reduced-quorum mode (arxiv 2102.01970)"
                )
        elif self.n < 3 * self.f + 1:
            raise ValueError(
                f"n={self.n} must be >= 3f+1={3 * self.f + 1} "
                "(docs/BBA-EN.md:26: t < n/3)"
            )
        if self.dial_retry_base_s <= 0 or (
            self.dial_retry_max_s < self.dial_retry_base_s
        ):
            raise ValueError(
                f"dial retry policy base={self.dial_retry_base_s} "
                f"max={self.dial_retry_max_s}: need 0 < base <= max"
            )
        if self.ledger_checkpoint_every < 0:
            raise ValueError(
                f"ledger_checkpoint_every={self.ledger_checkpoint_every} "
                "must be >= 0 (0 disables checkpoints)"
            )
        if self.crypto_backend not in ("cpu", "cpp", "cuda"):
            raise ValueError(f"unknown crypto_backend {self.crypto_backend!r}")
        if not (self.device == "cpu" or self.device.startswith("cuda")):
            raise ValueError(f"device={self.device!r}: need 'cuda[:N]' or 'cpu'")
        if self.trace_buffer <= 0:
            raise ValueError(
                f"trace_buffer={self.trace_buffer} must be > 0"
            )
        if self.obs_port is not None and not (0 <= self.obs_port <= 65535):
            raise ValueError(
                f"obs_port={self.obs_port} must be None or 0..65535"
            )
        if self.obs_sample_period_s <= 0:
            raise ValueError(
                f"obs_sample_period_s={self.obs_sample_period_s} "
                "must be > 0"
            )
        if self.slo_stall_factor <= 0 or self.slo_stall_grace_s <= 0:
            raise ValueError(
                f"stall SLO needs factor>0 grace>0, got "
                f"{self.slo_stall_factor}/{self.slo_stall_grace_s}"
            )
        if self.slo_queue_depth <= 0 or self.slo_peer_lag_epochs <= 0:
            raise ValueError(
                f"SLO thresholds must be > 0: queue_depth="
                f"{self.slo_queue_depth} peer_lag="
                f"{self.slo_peer_lag_epochs}"
            )
        if self.decrypt_lag_max < 1:
            raise ValueError(
                f"decrypt_lag_max={self.decrypt_lag_max} must be >= 1 "
                "(1 = order at most one epoch ahead of settlement)"
            )
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth={self.pipeline_depth} must be >= 1 "
                "(1 = lockstep: only the ordered frontier's epoch "
                "runs its RBC/BBA)"
            )
        if self.pipeline_depth > MAX_PIPELINE_DEPTH:
            raise ValueError(
                f"pipeline_depth={self.pipeline_depth} exceeds "
                f"MAX_PIPELINE_DEPTH={MAX_PIPELINE_DEPTH} (the demux "
                "window's forward horizon: an in-flight epoch past it "
                "could not reach a same-frontier peer)"
            )
        if self.reconfig_lead <= self.pipeline_depth + self.decrypt_lag_max:
            raise ValueError(
                f"reconfig_lead={self.reconfig_lead} must exceed "
                f"pipeline_depth + decrypt_lag_max = "
                f"{self.pipeline_depth + self.decrypt_lag_max} (the "
                "roster switch point must land past every epoch the "
                "old roster could already have ordered or still have "
                "in flight in the K-deep window)"
            )
        if self.mempool_capacity < 0:
            raise ValueError(
                f"mempool_capacity={self.mempool_capacity} must be "
                ">= 0 (0 disables the mempool)"
            )
        if self.mempool_client_cap < 1:
            raise ValueError(
                f"mempool_client_cap={self.mempool_client_cap} must "
                "be >= 1"
            )
        if self.mempool_seen_cap < 1:
            raise ValueError(
                f"mempool_seen_cap={self.mempool_seen_cap} must be >= 1"
            )
        if self.mempool_retry_after_ms < 0:
            raise ValueError(
                f"mempool_retry_after_ms={self.mempool_retry_after_ms} "
                "must be >= 0"
            )
        if self.ingress_port is not None and not (
            0 <= self.ingress_port <= 65535
        ):
            raise ValueError(
                f"ingress_port={self.ingress_port} must be None or "
                "0..65535"
            )
        if not (1 <= self.lanes <= MAX_LANES):
            raise ValueError(
                f"lanes={self.lanes} must be 1..{MAX_LANES} (S parallel "
                "consensus lanes over one roster; 1 = single-lane "
                "pre-shard-out behavior)"
            )
        if self.mesh_shape is not None:
            from cleisthenes_tpu_torch.parallel.mesh import validate_mesh_shape

            self.mesh_shape = validate_mesh_shape(self.mesh_shape)

    @property
    def data_shards(self) -> int:
        """K = N - 2f data shards for RS coding (docs/RBC-EN.md:30)."""
        return self.n - 2 * self.f

    @property
    def parity_shards(self) -> int:
        """2f parity shards so any N-2f of N shards reconstruct."""
        return 2 * self.f

    @property
    def decryption_threshold(self) -> int:
        """f+1 decryption shares recover a TPKE plaintext
        (docs/HONEYBADGER-EN.md:40-42, docs/THRESHOLD_ENCRYPTION-EN.md:33-36)."""
        return self.f + 1

    @property
    def quorum_large(self) -> int:
        """The large-quorum threshold: READY amplification to deliver,
        BVAL bin_values growth, TERM halt.  Baseline 2f+1; in
        reduced-quorum mode n-f (identical when n = 3f+1 exactly, so
        every historical roster's arithmetic is unchanged).  The f+1
        relay thresholds and the n-f input-wait thresholds are mode-
        independent."""
        return (self.n - self.f) if self.reduced_quorum else (2 * self.f + 1)
