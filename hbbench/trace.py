"""Reading the traced window from ``torch.profiler``.

``merged_us`` and ``profile_split`` are frozen copies of the device
busy/idle split the port's bring-up used: device microseconds by kernel
and by copy direction, and the union of the device's intervals against
the window.  ``host_labels`` and ``idle_by_label`` name the device's idle
time by the innermost host span open at each moment (the benchmark's
spans around the calls into each layer; ``epoch`` alone is the epoch's
host code outside the wrapped calls).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "hbbench.window"


def merged_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for st, en in sorted(intervals):
        if cur_e is None or st > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def profile_split(events, window) -> dict:
    """From the device's events (name, start_us, end_us): device
    microseconds a kernel name and a memcpy direction, and the share of
    ``window`` (start_us, end_us) in which the device was busy."""
    kernels, copies, spans = {}, {}, []
    for name, st, en in events:
        if en <= window[0] or st >= window[1]:
            continue
        spans.append((max(st, window[0]), min(en, window[1])))
        if name.startswith("Memcpy"):
            key = next((d for d in ("HtoD", "DtoH", "DtoD") if d in name), name)
            copies[key] = copies.get(key, 0.0) + en - st
        else:
            kernels[name] = kernels.get(name, 0.0) + en - st
    busy = merged_us(spans)
    return {"kernels_us": kernels, "copies_us": copies, "busy_us": busy,
            "window_us": window[1] - window[0],
            "busy_share": busy / (window[1] - window[0]) if window[1] > window[0] else 0.0}


def _busy_intervals(events, window) -> List[Tuple[float, float]]:
    out = []
    for _name, st, en in sorted(events, key=lambda e: e[1]):
        st, en = max(st, window[0]), min(en, window[1])
        if en <= st:
            continue
        if out and st <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], en))
        else:
            out.append((st, en))
    return out


def host_labels(spans, window) -> List[Tuple[float, float, str]]:
    """Nested host spans (name, start, end) -> (start, end, innermost
    name) segments covering ``window``; time in no span is ``host``."""
    points = []
    for name, st, en in spans:
        points.append((st, 1, en, name))
        points.append((en, 0, st, name))
    points.sort(key=lambda p: (p[0], p[1]))
    stack: List[Tuple[float, str]] = []
    segs = []
    t = window[0]
    for x, kind, other, name in points:
        if x > t:
            lo, hi = max(t, window[0]), min(x, window[1])
            if hi > lo:
                segs.append((lo, hi, stack[-1][1] if stack else "host"))
            t = x
        if kind:
            stack.append((other, name))
        else:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == (x, name):
                    del stack[i]
                    break
    if t < window[1]:
        segs.append((t, window[1], stack[-1][1] if stack else "host"))
    return segs


def idle_by_label(dev_events, spans, window) -> Dict[str, float]:
    """Device-idle microseconds inside ``window``, by the innermost host
    span open while the device idled."""
    busy = _busy_intervals(dev_events, window)
    gaps, t = [], window[0]
    for st, en in busy:
        if st > t:
            gaps.append((t, st))
        t = max(t, en)
    if t < window[1]:
        gaps.append((t, window[1]))
    out: Dict[str, float] = {}
    segs = host_labels(spans, window)
    i = 0
    for a, b in gaps:
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            lo, hi = max(a, segs[j][0]), min(b, segs[j][1])
            if hi > lo:
                out[segs[j][2]] = out.get(segs[j][2], 0.0) + hi - lo
            j += 1
    return out


def kernel_us(split: dict, pattern: str) -> float:
    """Device microseconds of the kernels whose name matches ``pattern``
    as a whole word (``dual_pow_kernel`` is not ``wide_dual_pow_kernel``)."""
    rx = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(pattern) + r"(?![A-Za-z0-9_])")
    return sum(us for name, us in split["kernels_us"].items() if rx.search(name))


def read_profile(prof) -> Optional[dict]:
    """The window's split, its device events and host spans, or None when
    the profiler gave no device events."""
    evs = prof.events()

    def on_device(e) -> bool:
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    window = None
    spans = []
    dev = []
    for e in evs:
        rng = (e.time_range.start, e.time_range.end)
        if on_device(e):
            # a span's device-side twin is not device work
            if not _is_span_name(e.name):
                dev.append((e.name, rng[0], rng[1]))
        elif e.name == WINDOW_SPAN:
            window = rng
        elif _is_span_name(e.name):
            spans.append((e.name, rng[0], rng[1]))
    if window is None or not dev:
        return None
    split = profile_split(dev, window)
    split["idle_by_label_us"] = idle_by_label(dev, spans, window)
    return split


def _is_span_name(name: str) -> bool:
    return name == WINDOW_SPAN or name == "epoch" or name.split(".")[0] in (
        "propose", "rbc", "engine", "decrypt", "client",
    )
