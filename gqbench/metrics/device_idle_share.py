"""Share of the measured traced window in which no kernel, copy or set ran
on the device (the spins that open the window left out)."""

UNIT = "%"
LAYER = "device"
MOVES = "samples_per_s"
READS = ()


def read(view):
    if view.window_us <= 0:
        return None
    return 100.0 * (1.0 - view.busy_us / view.window_us)
