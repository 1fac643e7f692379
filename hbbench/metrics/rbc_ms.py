"""rbc_ms: RS encode, Merkle forest, the N^2 branch checks and the fused
decode and root recheck (``rbc_encode_s + rbc_verify_s + rbc_decode_s``,
host clock around phases read back to the host), ms an epoch."""

from hbbench.readers import per_epoch_ms, stat

LAYER = "RBC"
SOURCE = "program_span"
MOVES = "tx_per_s"
UNIT = "ms"


def read(run):
    return per_epoch_ms(run, stat("rbc_encode_s", "rbc_verify_s", "rbc_decode_s"))
