"""The whole training step's share of the card's peak: the least time of
the window's epochs (``perfbench.roofline``) over the window's wall time
(host clock). It bounds any one kernel's gain: a kernel taken off the path
leaves its own roofline silent, and this share still counts the step."""


def read(run):
    if run.window_s <= 0 or run.seed_epochs <= 0:
        return None
    return 100.0 * (run.seed_epochs // run.seeds) * run.least_epoch_s / run.window_s
