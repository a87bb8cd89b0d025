"""The mega-kernel's share of its roofline: the least time of the epochs it
ran in the traced window (``perfbench.roofline``: the matrix products at the
H100's TF32 peak, or the bytes at its HBM rate) over the kernel's device
time for them (the profiler's kernel durations)."""

MEGAKERNEL = "train_chunk_kernel"


def read(run):
    if run.timeline is None:
        return None
    lo, hi = run.trace_window
    busy = sum(e - s for s, e in run.timeline.kernels(MEGAKERNEL, lo, hi))
    if busy <= 0 or run.seed_epochs <= 0:
        return None
    return 100.0 * (run.seed_epochs // run.seeds) * run.least_epoch_s / busy
