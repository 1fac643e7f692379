"""Cross-cutting utilities: metrics, tracing, deterministic helpers."""

from cleisthenes_tpu_torch.utils.determinism import guarded_by, proposal_rng
from cleisthenes_tpu_torch.utils.metrics import (
    Counter,
    EpochTrace,
    Histogram,
    Metrics,
)
from cleisthenes_tpu_torch.utils.timeseries import (
    TimeSeriesSampler,
    flatten_snapshot,
)
from cleisthenes_tpu_torch.utils.trace import TraceRecorder, maybe_recorder

__all__ = [
    "Counter",
    "Histogram",
    "EpochTrace",
    "Metrics",
    "TimeSeriesSampler",
    "TraceRecorder",
    "flatten_snapshot",
    "guarded_by",
    "maybe_recorder",
    "proposal_rng",
]
