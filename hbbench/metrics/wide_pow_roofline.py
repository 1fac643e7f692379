"""wide_pow_roofline: K12 ``wide_pow_kernel``'s share of its roofline: the
frozen bound of every window call of a wide engine's pows, grouped calls
flattened (the fewest Montgomery products its exponents need by
``least_pow``, at the SASS counts by pipe of the family's loop of
squarings, against its bytes at 3.35 TB/s), over the kernel's profiled
device time, summed over the window."""

from hbbench.readers import roofline_pct

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "tx_per_s"
UNIT = "%"


def read(run):
    return roofline_pct(run, "wide_pow_kernel", run.wide_pow_bound_ms)
