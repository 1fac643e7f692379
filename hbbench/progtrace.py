"""Reading the program's own spans in a traced window.

With ``Config.trace`` the port's ``LockstepCluster`` records its epoch
into a ``cleisthenes_tpu_torch.utils.trace.TraceRecorder``: a ring of
``(seq, ts, dur, cat, name, args)`` on the ``perf_counter`` clock.  A
span is named ``cat.name`` here.  This module:

- picks each epoch's spans by its ``[start, end]`` on the same clock;
- splits BBA's host time by the spans' *self time*: a span's length less
  the union of the ``coin.issue``, ``coin.challenge``, ``coin.verify``
  and ``engine.*`` spans inside it (``gc.full`` is not subtracted);
- maps the spans onto ``torch.profiler``'s timeline by clock anchors,
  program-clock reads taken around a profiler span's edge;
- so that ``hbbench/trace.py``'s ``idle_by_label``, given the
  benchmark's spans and the mapped program spans together, names each
  device-idle moment by the innermost span of either set.

Nothing here imports the program: the events are plain tuples.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from hbbench.trace import merged_us

Event = tuple  # (seq, ts, dur, cat, name, args)
Span = Tuple[str, float, float, dict]  # (cat.name, start_s, end_s, args)

# the spans whose time another metric reads, so the spans around them do
# not count it again
MEASURED = ("coin.issue", "coin.challenge", "coin.verify")


def spans(events: Iterable[Event]) -> List[Span]:
    """The events with a duration, as (cat.name, start, end, args)."""
    return [(f"{ev[3]}.{ev[4]}", ev[1], ev[1] + ev[2], ev[5])
            for ev in events if ev[2] is not None]


def in_window(events: Iterable[Event], start: float, end: float) -> List[Event]:
    """The spans that lie inside ``[start, end]`` (one epoch's)."""
    return [ev for ev in events if ev[2] is not None and ev[1] >= start and ev[1] + ev[2] <= end]


def _measured(name: str) -> bool:
    return name in MEASURED or name.startswith("engine.")


def inside(outer: Span, ss: Sequence[Span], pred) -> List[Tuple[float, float]]:
    """The intervals of the spans of ``ss`` that ``pred`` takes, clipped
    to ``outer``, ``outer`` itself left out."""
    _n, a, b, _args = outer
    out = []
    for s in ss:
        if s is outer or not pred(s[0]):
            continue
        lo, hi = max(a, s[1]), min(b, s[2])
        if hi > lo:
            out.append((lo, hi))
    return out


def self_s(outer: Span, ss: Sequence[Span]) -> float:
    """``outer``'s length less the union of the measured spans inside it."""
    return (outer[2] - outer[1]) - merged_us(inside(outer, ss, _measured))


def epoch_split(ss: Sequence[Span]) -> Dict[str, float]:
    """One epoch's split, in seconds."""
    out = {"bba_bookkeeping": 0.0, "share_issue_host": 0.0, "cp_challenge": 0.0,
           "share_verify_host": 0.0, "engine_pack": 0.0, "engine_unpack": 0.0,
           "propose_kem": 0.0, "engine_in_bba": 0.0}
    for s in ss:
        name, dur = s[0], s[2] - s[1]
        if name == "epoch.bba":
            out["bba_bookkeeping"] += self_s(s, ss)
            out["engine_in_bba"] += merged_us(inside(s, ss, lambda n: n.startswith("engine.")))
        elif name == "coin.issue":
            out["share_issue_host"] += self_s(s, ss)
        elif name == "coin.verify":
            out["share_verify_host"] += self_s(s, ss)
        elif name == "coin.challenge":
            out["cp_challenge"] += dur
        elif name == "engine.pack":
            out["engine_pack"] += dur
        elif name == "engine.unpack":
            out["engine_unpack"] += dur
        elif name == "tpke.kem":
            out["propose_kem"] += dur
    return out


def bba_parts_s(split: Dict[str, float]) -> float:
    """The four BBA host parts plus the engine inside ``epoch.bba``:
    what adds up to ``bba_s``."""
    return (split["bba_bookkeeping"] + split["share_issue_host"] + split["cp_challenge"]
            + split["share_verify_host"] + split["engine_in_bba"])


def per_epoch_ms(epochs: Sequence[dict], key: str, dropped: int) -> Optional[float]:
    """The mean over the window's epochs of split ``key``, in ms, from
    each epoch's ``program_events``; None when the ring dropped events or
    an epoch has none."""
    if dropped or not epochs or any(not ep.get("program_events") for ep in epochs):
        return None
    total = sum(epoch_split(spans(ep["program_events"]))[key] for ep in epochs)
    return total / len(epochs) * 1e3


def coin_useful_pct(epochs: Sequence[dict]) -> Optional[float]:
    """100 x the coin shares issued for an (instance, round) the instance
    reached undecided over all coin shares issued, from the stats."""
    if not epochs or any("coin_useful" not in ep["stats"] for ep in epochs):
        return None
    issued = sum(float(ep["stats"]["coin_issues"]) for ep in epochs)
    if issued <= 0:
        return None
    return 100.0 * sum(float(ep["stats"]["coin_useful"]) for ep in epochs) / issued


# -- one clock with the device trace ---------------------------------------


def clock_offset(anchors: Sequence[Tuple[float, float, float]]) -> Tuple[float, float]:
    """``anchors``, in time order: (program clock before, program clock
    after, profiler microseconds of a span edge read between the two).
    An anchor is as exact as it is narrow, and the first entry of a span
    can take a millisecond.  Returns the offset in seconds, program clock
    less profiler clock, of the narrowest anchor, and the drift: the
    offset of the narrowest anchor of the later half less that of the
    earlier half's."""
    if not anchors:
        raise ValueError("no clock anchors")

    def offset(a):
        return (a[0] + a[1]) / 2 - a[2] / 1e6

    def narrowest(xs):
        return min(xs, key=lambda a: a[1] - a[0])

    half = max(1, len(anchors) // 2)
    early, late = narrowest(anchors[:half]), narrowest(anchors[half:] or anchors)
    return offset(narrowest(anchors)), offset(late) - offset(early)


def to_profiler(ss: Sequence[Span], offset_s: float) -> List[Tuple[str, float, float]]:
    """The spans as (name, start_us, end_us) on the profiler's timeline."""
    return [(name, (a - offset_s) * 1e6, (b - offset_s) * 1e6) for name, a, b, _args in ss]


__all__ = [
    "MEASURED",
    "bba_parts_s",
    "clock_offset",
    "coin_useful_pct",
    "epoch_split",
    "in_window",
    "per_epoch_ms",
    "self_s",
    "spans",
    "to_profiler",
]
