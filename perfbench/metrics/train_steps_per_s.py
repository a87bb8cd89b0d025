"""Seed-epochs completed in the window over the window's wall time (host
clock, from the first fit call to the return of the last, after a
synchronize): epochs/s for one seed, S times epochs/s for S packed seeds."""


def read(run):
    return run.seed_epochs / run.window_s if run.window_s > 0 else None
