"""engine_packing_ms: the modexp engine's host time outside its device
leg, ``engine_s - device_s`` (int<->bytes packing), ms an epoch.  Both are
host clocks; ``device_s`` spans upload, kernel and download."""

from hbbench.readers import per_epoch_ms

LAYER = "modexp engine"
SOURCE = "program_span"
MOVES = "tx_per_s"
UNIT = "ms"


def read(run):
    return per_epoch_ms(run, lambda ep: ep["engine_s"] - ep["device_s"])
