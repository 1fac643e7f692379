"""dual_pow_roofline: K8 ``dual_pow_kernel``'s share of its roofline: the
frozen bound of every window call (the fewest Montgomery products its
exponents need by ``least_dual``, by pipe, against its bytes at 3.35 TB/s)
over the kernel's profiled device time, summed over the window."""

from hbbench.readers import roofline_pct

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "tx_per_s"
UNIT = "%"


def read(run):
    return roofline_pct(run, "dual_pow_kernel", run.dual_pow_bound_ms)
