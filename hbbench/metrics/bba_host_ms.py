"""bba_host_ms: BBA and coin outside the modexp engine's calls: ``bba_s``
less the engine's ``engine_s`` over the epoch (host clocks), ms an epoch."""

from hbbench.readers import bba_host_ms

LAYER = "BBA and coin protocol"
SOURCE = "program_span"
MOVES = "tx_per_s"
UNIT = "ms"
read = bba_host_ms
