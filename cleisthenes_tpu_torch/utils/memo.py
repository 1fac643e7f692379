"""BoundedFifoMemo: the one bounded-memo eviction discipline.

Several planes memoize pure-function results behind a capacity bound
— the hub's verdict memos (protocol/hub.py), the cluster tx-parse
memo (protocol/honeybadger.py), the shared-prefix frame-decode memo
(transport/message.py).  They must all evict the same way: at the
cap, the OLDEST insertion goes (dict order), never the whole table —
a hot working set sitting near the cap loses one stale entry per
fresh one instead of periodically dropping everything and re-running
its whole wave of pure computations.  Keeping the discipline in ONE
class means an eviction-policy fix lands everywhere at once, and the
transport plane can use it without importing protocol code.
"""

from __future__ import annotations

from typing import Dict


class BoundedFifoMemo:
    """Bounded memo of pure-function results with FIFO eviction."""

    __slots__ = ("map", "cap")

    def __init__(self, cap: int):
        self.map: Dict = {}
        self.cap = cap

    def put(self, key, val) -> None:
        m = self.map
        if len(m) >= self.cap and key not in m:
            del m[next(iter(m))]  # FIFO: oldest insertion goes first
        m[key] = val


__all__ = ["BoundedFifoMemo"]
