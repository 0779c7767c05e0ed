"""Share of its roofline that the per-user conv weight gradient reaches:
the least time of one step's per-user weight gradients, counted from the
configuration's conv shapes and the users (``counts.per_user_dw_least_ms``),
over the device time a step of the kernels named in ``READS``."""

from gqbench.harness import counts

UNIT = "%"
LAYER = "per-user conv weight gradient (K7)"
MOVES = "samples_per_s"
READS = ("per_user_dw_tc_kernel", "per_user_dw_narrow_kernel",
         "per_user_dw_tc_f32_kernel", "per_user_dw_narrow_f32_kernel")


def read(view):
    ms = view.kernel_ms(READS)
    if not ms:
        return None
    return 100.0 * counts.per_user_dw_least_ms(view.spec, view.traffic) / ms
