"""coin_useful_pct: 100 x the coin shares issued for an (instance, round)
that the instance reached undecided (``run_epoch``'s ``coin_useful``)
over every coin share issued (``coin_issues``), over the window's
epochs; the rest is the doubling blocks' speculation.  None where the
program does not count ``coin_useful``."""

from hbbench.progtrace import coin_useful_pct

LAYER = "BBA and coin protocol"
SOURCE = "program_counter"
MOVES = "tx_per_s"
UNIT = "%"


def read(run):
    return coin_useful_pct(run.epochs)
