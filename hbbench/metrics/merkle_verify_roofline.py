"""merkle_verify_roofline: K6 ``merkle_verify_kernel``'s share of its
roofline: the frozen ``sha_ops`` bound of every window call from its
shapes, over the kernel's profiled device time, summed over the window."""

from hbbench.readers import roofline_pct

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "tx_per_s"
UNIT = "%"


def read(run):
    return roofline_pct(run, "merkle_verify_kernel", run.merkle_verify_bound_ms)
