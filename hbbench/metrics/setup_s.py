"""setup_s: process start to the first timed epoch (imports, CUDA context,
kernel libraries, key dealing, the cluster, warm-up epochs)."""

SOURCE = "host_clock"
UNIT = "s"


def read(run):
    return run.setup_s
