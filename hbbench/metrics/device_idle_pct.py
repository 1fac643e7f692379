"""device_idle_pct: 100 less the share of the traced window in which a
kernel or a copy ran on the card (the union of their intervals)."""

from hbbench.readers import device_idle_pct

LAYER = "device"
SOURCE = "device_trace"
MOVES = "tx_per_s"
UNIT = "%"
read = device_idle_pct
