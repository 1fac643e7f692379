"""epoch_ms.light: the window's seconds over its epochs, in ms."""

LAYER = "epoch"
SOURCE = "host_clock"
MOVES = "tx_per_s"
UNIT = "ms"


def read(run):
    if not run.epochs:
        return None
    return run.window_s / len(run.epochs) * 1e3
