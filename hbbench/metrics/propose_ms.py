"""propose_ms: batch select and TPKE encrypt of the N proposals
(``run_epoch``'s ``propose_s``, host clock), ms an epoch."""

from hbbench.readers import per_epoch_ms, stat

LAYER = "propose"
SOURCE = "program_span"
MOVES = "tx_per_s"
UNIT = "ms"


def read(run):
    return per_epoch_ms(run, stat("propose_s"))
