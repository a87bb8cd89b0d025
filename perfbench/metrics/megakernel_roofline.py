"""The chunk kernel's share of its roofline: the least time of the epochs it
ran in the traced window (``perfbench.roofline``: the matrix products at the
H100's TF32 peak, or the bytes at its HBM rate; for the AE kernel every
product, the MLP's included, at the TF32 peak) over the device time of the
cell's chunk kernel (``Run.kernel``: the mega-kernel, or the AE kernel) for
them (the profiler's kernel durations)."""


def read(run):
    if run.timeline is None:
        return None
    lo, hi = run.trace_window
    busy = sum(e - s for s, e in run.timeline.kernels(run.kernel, lo, hi))
    if busy <= 0 or run.seed_epochs <= 0:
        return None
    return 100.0 * (run.seed_epochs // run.seeds) * run.least_epoch_s / busy
