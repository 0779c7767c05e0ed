"""Device ms a step of the kernels launched under ``gqbench::fwd_bwd``: the
folded forward and backward with the per-user weight gradients
(``train.folded_user_grads``, ``models/folded.py``, ``models/``)."""

UNIT = "ms"
LAYER = "per-user forward and backward"
MOVES = "samples_per_s"
READS = ("gqbench::fwd_bwd",)


def read(view):
    return view.span_ms(READS[0])
