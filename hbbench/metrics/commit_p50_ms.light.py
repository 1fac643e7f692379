"""commit_p50_ms.light: median milliseconds from a transaction's due time
to the end of the epoch that commits it, over every transaction due in the
window (one never committed counts to the end of the drain)."""

from hbbench.readers import latency_pct

LAYER = "client"
SOURCE = "host_clock"
MOVES = "tx_per_s"
UNIT = "ms"


def read(run):
    return latency_pct(run, 50)
