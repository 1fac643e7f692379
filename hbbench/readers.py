"""Arithmetic the metric readers share: per-epoch means of the
``run_epoch`` stats and the engines' host clocks, the device's idle share
and a kernel's share of its roofline from the traced window."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from hbbench.trace import kernel_us


def per_epoch_ms(run, value: Callable[[dict], float]) -> Optional[float]:
    """The window's total of ``value(epoch record)`` over its epochs, in ms."""
    if not run.epochs:
        return None
    return sum(value(ep) for ep in run.epochs) / len(run.epochs) * 1e3


def stat(*keys: str) -> Callable[[dict], float]:
    return lambda ep: sum(float(ep["stats"][k]) for k in keys)


def bba_host_ms(run) -> Optional[float]:
    return per_epoch_ms(run, lambda ep: float(ep["stats"]["bba_s"]) - ep["engine_s"])


def device_idle_pct(run) -> Optional[float]:
    if run.profile is None:
        return None
    return 100.0 * (1.0 - run.profile["busy_share"])


def roofline_pct(run, kernel: str, bound_ms: Optional[float]) -> Optional[float]:
    """100 x the bound's milliseconds over the kernel's profiled device
    milliseconds, both summed over the window's calls."""
    if run.profile is None or not bound_ms:
        return None
    us = kernel_us(run.profile, kernel)
    if us <= 0:
        return None
    return 100.0 * bound_ms / (us / 1e3)


def latency_pct(run, q: float) -> Optional[float]:
    if not run.latencies_ms:
        return None
    return float(np.percentile(run.latencies_ms, q))
