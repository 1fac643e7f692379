"""device_idle_pct.light: ``device_idle_pct`` in the open-loop cell, where
it moves the commit latency."""

from hbbench.readers import device_idle_pct

LAYER = "device"
SOURCE = "device_trace"
MOVES = "tx_per_s"
UNIT = "%"
read = device_idle_pct
