"""``device_idle_share.bls``: per cent of the traced window in which no
operation ran on the card: 100 x (1 - the union of the profiler's device
activity intervals / the window).  Layer: the device.  Moves ``sets_per_s``:
the share of the card that the host leaves unused while every verify slot is
busy."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
