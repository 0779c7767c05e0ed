"""Device ms a step of the batch-norm chain: kernels launched under a
batch norm's forward range or its grouped backward node, by the benchmark's
frozen families."""

UNIT = "ms"
LAYER = "per-user forward and backward"
MOVES = "samples_per_s"
READS = ("BN forward", "BN backward")


def read(view):
    return view.family_ms(READS)
