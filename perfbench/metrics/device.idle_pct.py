"""Share of the traced window in which no kernel, copy or fill ran on the
card, from the profiler's timeline."""


def read(run):
    if run.timeline is None:
        return None
    lo, hi = run.trace_window
    if hi <= lo or not run.timeline.device:
        return None
    return 100.0 * (1.0 - run.timeline.busy(lo, hi) / (hi - lo))
