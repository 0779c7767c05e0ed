"""Device ms a step of the kernels launched inside the program's own
``gqx_torch::bn.forward`` span: every batch norm's forward (the host ops
round a launch, ``e["ops"]``, hold the span's range)."""

UNIT = "ms"
LAYER = "per-user forward and backward"
MOVES = "samples_per_s"
READS = ("gqx_torch::bn.forward",)


def read(view):
    hit = [e["dur"] for e in view.events if READS[0] in e["ops"]]
    return sum(hit) / view.steps / 1e3 if hit else None
