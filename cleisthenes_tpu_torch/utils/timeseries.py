"""Bounded-ring time series: the live half of the telemetry plane.

`Metrics.snapshot()` is a point-in-time read; the flight recorder
(utils/trace.py) is a post-hoc artifact.  Neither answers the
operator's live questions — "is commit latency drifting *right now*?",
"has the queue been growing for the last minute?" — which need short
HISTORY, not a single sample or a full trace.  This module folds
periodic snapshots into per-metric bounded rings cheap enough to stay
always-on next to a validator: `cap` points per metric, oldest
evicted, no unbounded growth ever.

The sampler is the one place in the telemetry plane that owns a
clock + thread:

- `sample(now=None)` is the pure fold (provider snapshot -> rings),
  callable manually — tests and the deterministic in-proc cluster
  drive it with synthetic `now` values and never start the thread.
- `start(period_s)` runs that fold on a daemon thread for live
  deployments (ValidatorHost, demo --obs-port), and gives registered
  tick callbacks (the SLO watchdog's `check`) their heartbeat.

utils/ sits outside the determinism plane, so the wall clock is legal
here — but the same discipline as utils/trace.py applies: protocol
code never reads these timestamps back, and the clock stays confined
to `_now()` below (the staticcheck fixture
tests/staticcheck_fixtures/protocol/det001_obs_bad.py proves a
hand-rolled sampler loop in protocol/ still gates).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from cleisthenes_tpu_torch.utils.determinism import guarded_by
from cleisthenes_tpu_torch.utils.lockcheck import new_lock

DEFAULT_CAP = 512

Point = Tuple[float, float]  # (sample instant, value)


def _now() -> float:
    """The sampler's clock (monotonic: series are for rate/age math,
    never wall-calendar display).  Confined here the way
    TraceRecorder.now() confines the trace clock."""
    return time.monotonic()  # telemetry clock (outside the determinism plane)


def flatten_snapshot(
    snap: Dict[str, object], prefix: str = ""
) -> Dict[str, float]:
    """Flatten a nested snapshot dict into dotted scalar series names:
    ``{"transport": {"delivered": 3}} -> {"transport.delivered": 3.0}``.
    Non-numeric leaves (states, lists, None) are dropped — they belong
    to /vars and /healthz, not to numeric series."""
    out: Dict[str, float] = {}
    for key, val in snap.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(flatten_snapshot(val, name))
        elif isinstance(val, bool):
            out[name] = 1.0 if val else 0.0
        elif isinstance(val, (int, float)):
            out[name] = float(val)
    return out


@guarded_by("_lock", "_series", "_samples")
class TimeSeriesSampler:
    """Folds a snapshot provider into per-metric bounded rings.

    One sampler serves one node (provider = that node's
    ``Metrics.snapshot``); the observability endpoints read
    ``series()``/``latest()`` and the trend tooling reads ``rate()``.
    """

    def __init__(
        self,
        provider: Callable[[], Dict[str, object]],
        cap: int = DEFAULT_CAP,
    ) -> None:
        if cap <= 0:
            raise ValueError(f"timeseries cap {cap} must be > 0")
        self._provider = provider
        self.cap = cap
        self._series: Dict[str, Deque[Point]] = {}
        self._samples = 0
        self._lock = new_lock()
        self._on_tick: List[Callable[[], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the fold ----------------------------------------------------------

    def on_tick(self, fn: Callable[[Optional[float]], None]) -> None:
        """Register a callback run on every sample (manual or
        threaded) BEFORE the snapshot is read — the SLO watchdog's
        ``check`` rides here so each sample records post-check state.
        The callback receives the sample instant, so a synthetic
        ``sample(now=...)`` drives the watchdog's clock too (rings and
        verdicts must tell one consistent story)."""
        self._on_tick.append(fn)

    def sample(self, now: Optional[float] = None) -> Dict[str, float]:
        """One fold: run tick callbacks (passing the sample instant),
        snapshot, append every numeric leaf to its ring.  Returns the
        flattened sample."""
        t = _now() if now is None else now
        for fn in self._on_tick:
            fn(t)
        flat = flatten_snapshot(self._provider())
        with self._lock:
            self._samples += 1
            for name, value in flat.items():
                ring = self._series.get(name)
                if ring is None:
                    ring = self._series[name] = collections.deque(
                        maxlen=self.cap
                    )
                ring.append((t, value))
        return flat

    # -- reading -----------------------------------------------------------

    def series(self) -> Dict[str, List[Point]]:
        """Every ring, oldest point first."""
        with self._lock:
            return {name: list(ring) for name, ring in self._series.items()}

    def latest(self) -> Dict[str, float]:
        with self._lock:
            return {
                name: ring[-1][1]
                for name, ring in self._series.items()
                if ring
            }

    def rate(self, name: str) -> Optional[float]:
        """Per-second delta of a (monotonic counter) series across its
        ring window; None with < 2 points or a zero-length window."""
        with self._lock:
            ring = self._series.get(name)
            if ring is None or len(ring) < 2:
                return None
            (t0, v0), (t1, v1) = ring[0], ring[-1]
        if t1 <= t0:
            return None
        return (v1 - v0) / (t1 - t0)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"samples": self._samples, "series": len(self._series)}

    # -- the live loop -----------------------------------------------------

    def start(self, period_s: float = 1.0) -> None:
        """Spawn the sampling daemon; idempotent."""
        if period_s <= 0:
            raise ValueError(f"sample period {period_s} must be > 0")
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(period_s):
                try:
                    self.sample()
                except Exception:
                    # a failing provider must not kill telemetry;
                    # the next tick retries
                    import traceback

                    traceback.print_exc()

        self._thread = threading.Thread(
            target=loop, name="obs-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)


__all__ = [
    "DEFAULT_CAP",
    "TimeSeriesSampler",
    "flatten_snapshot",
]
