"""The one traffic generator: transactions and their arrivals from the seed.

Transaction i is its index as 8 big-endian bytes, then ``tx_bytes - 8``
bytes cut from a 1 MiB block of random bytes drawn from the seed: every
transaction is distinct, and the same seed gives the same bytes.  A mix
file (``traffic/<mix>.json``) says how they arrive:

- ``"loop": "closed"``: before every epoch the client tops the queues up
  to ``queued_batches`` times the batch size, so every epoch is full.
- ``"loop": "open"``: Poisson arrivals at ``rate_tx_per_s``, due times
  drawn from the seed, submitted at the first epoch boundary at or after
  each is due.

Either way transaction i goes to validator i mod N, in the roster's
sorted order.
"""

from __future__ import annotations

import numpy as np

BLOCK = 1 << 20


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use of the seed (any integer, negative too)."""
    return np.random.default_rng([seed % (1 << 64), stream])


class TxPool:
    def __init__(self, seed: int, tx_bytes: int) -> None:
        if tx_bytes < 8:
            raise ValueError(f"tx_bytes={tx_bytes}: a transaction holds its 8-byte index")
        self.tx_bytes = tx_bytes
        self.body = tx_bytes - 8
        self.block = rng(seed, 1).integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
        self._span = BLOCK - self.body

    def tx(self, i: int) -> bytes:
        off = (i * 4099) % self._span
        return i.to_bytes(8, "big") + self.block[off : off + self.body]

    def txs(self, start: int, count: int) -> list:
        return [self.tx(i) for i in range(start, start + count)]


def index_of(tx: bytes) -> int:
    return int.from_bytes(tx[:8], "big")


def poisson_due(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times in [0, seconds) of Poisson arrivals at ``rate`` a second."""
    gen = rng(seed, 2)
    out = []
    t = 0.0
    while True:
        gaps = gen.exponential(1.0 / rate, max(16, int(rate * seconds) + 64))
        times = t + np.cumsum(gaps)
        keep = times[times < seconds]
        out.append(keep)
        if len(keep) < len(times):
            return np.concatenate(out)
        t = float(times[-1])
