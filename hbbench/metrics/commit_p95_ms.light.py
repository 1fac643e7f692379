"""commit_p95_ms.light: the 95th percentile of the latencies that
``commit_p50_ms.light`` takes the median of."""

from hbbench.readers import latency_pct

LAYER = "client"
SOURCE = "host_clock"
MOVES = "tx_per_s"
UNIT = "ms"


def read(run):
    return latency_pct(run, 95)
