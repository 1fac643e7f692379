"""decrypt_commit_ms: the decrypt tail (combine memo hits, tag checks,
transaction-list parse) and the commit rule (``decrypt_s + commit_s``),
ms an epoch."""

from hbbench.readers import per_epoch_ms, stat

LAYER = "decrypt tail and commit"
SOURCE = "program_span"
MOVES = "tx_per_s"
UNIT = "ms"


def read(run):
    return per_epoch_ms(run, stat("decrypt_s", "commit_s"))
