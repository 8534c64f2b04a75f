"""idle_share.train: the share of the traced window in which no operation
ran on the card, 1 - busy seconds / the window's seconds, both from the
profiled steps.  (Against the unprofiled step time instead, a card kept
full reads below zero: the profiler stretches device time by ~3%.)"""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
