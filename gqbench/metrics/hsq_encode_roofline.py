"""Share of its roofline that the HSQ encode reaches: the least time of one
step's encode of every user's HSQ units, counted from the configuration and
the mix (``counts.hsq_encode_least_ms``), over the device time a step of
the kernels named in ``READS``."""

from gqbench.harness import counts

UNIT = "%"
LAYER = "HSQ encode (K1)"
MOVES = "samples_per_s"
READS = ("hsq_encode_tc_kernel",)


def read(view):
    ms = view.kernel_ms(READS)
    if not ms or counts.hsq_unit_rows(view.spec, view.traffic) == 0:
        return None
    return 100.0 * counts.hsq_encode_least_ms(view.spec, view.traffic) / ms
