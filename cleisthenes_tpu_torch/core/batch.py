"""Committed batch of transactions.

Reference honeybadger.go:10-16: ``Batch{txList []Transaction}`` with
``TxList()``.  Here a batch additionally remembers which proposer
contributed which transactions (the ACS output is a union of per-
proposer contributions, docs/HONEYBADGER-EN.md:85-89), which the
reference leaves implicit because its ACS is absent.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from cleisthenes_tpu_torch.core.queue import Transaction


@dataclasses.dataclass
class Batch:
    """An ordered set of committed transactions (honeybadger.go:10-16)."""

    # proposer id -> that proposer's contributed transactions, in
    # proposal order.  Iteration over proposers is by sorted id so every
    # correct node derives the identical total order (Atomic Broadcast
    # "Total order", docs/HONEYBADGER-EN.md:24-25).
    contributions: Dict[str, List[Transaction]] = dataclasses.field(
        default_factory=dict
    )

    def tx_list(self) -> List[Transaction]:
        """Flattened, deterministically-ordered transactions
        (reference honeybadger.go:14)."""
        out: List[Transaction] = []
        for proposer in sorted(self.contributions):
            out.extend(self.contributions[proposer])
        return out

    def __len__(self) -> int:
        return sum(len(v) for v in self.contributions.values())
