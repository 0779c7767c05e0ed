"""Host ms a step inside the benchmark's ``gqbench::data`` range: the
pipeline's next global batch, with its native augment; the mean over the
measured window's steps, on the host clock.  ``runner.to_device`` is timed
apart (``gqbench::copy``, the run's ``[window]`` line), on a copy stream of
its own (``program.Session``)."""

UNIT = "ms"
LAYER = "data"
MOVES = "samples_per_s"
READS = ("gqbench::data",)


def read(view):
    return view.run.get("data_ms")
