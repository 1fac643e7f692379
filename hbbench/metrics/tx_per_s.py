"""tx_per_s: transactions committed in the window over the window's
seconds, first timed epoch's start to the last epoch's end."""

SOURCE = "host_clock"
UNIT = "tx/s"


def read(run):
    if run.window_s <= 0 or not run.committed_in_window:
        return None
    return run.committed_in_window / run.window_s
