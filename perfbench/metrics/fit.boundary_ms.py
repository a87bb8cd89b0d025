"""Mean device-idle time at a chunk boundary of the traced window: in each
interval from the end of one launch of the cell's chunk kernel (``Run.kernel``,
the configuration's) to the start of the next, the time no device operation
ran (the metrics fetch, the log lines, the checkpoint's host copy and the
next launch's set-up happen there)."""


def read(run):
    if run.timeline is None:
        return None
    lo, hi = run.trace_window
    launches = run.timeline.kernels(run.kernel, lo, hi)
    if len(launches) < 2:
        return None
    idle = [sum(e - s for s, e in run.timeline.gaps(a_end, b_start))
            for (_, a_end), (b_start, _) in zip(launches, launches[1:])]
    return 1e3 * sum(idle) / len(idle)
