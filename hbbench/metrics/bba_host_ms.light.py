"""bba_host_ms.light: ``bba_host_ms`` in the open-loop cell, where it
moves the commit latency: ``bba_s`` less the engine's ``engine_s``."""

from hbbench.readers import bba_host_ms

LAYER = "BBA and coin protocol"
SOURCE = "program_span"
MOVES = "tx_per_s"
UNIT = "ms"
read = bba_host_ms
