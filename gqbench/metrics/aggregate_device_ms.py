"""Device ms a step of the kernels launched under ``gqbench::aggregate``:
packing into units, the compressors' encodes, draws and decodes, the
server's mean (``parallel/aggregate.py``, ``parallel/packing.py``,
``compress/``)."""

UNIT = "ms"
LAYER = "aggregation and compressors"
MOVES = "samples_per_s"
READS = ("gqbench::aggregate",)


def read(view):
    return view.span_ms(READS[0])
