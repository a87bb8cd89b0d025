"""Share of the AE kernel's clock spent in its row phases, which hold its
fp32-FMA products with X: ``rows.forward`` (the encoder over every row, X·W0
first, and the decoder forward to D6) and ``rows.decoder`` (the factored
AE-MSE's X·V6ᵀ and D6·VV, then the decoder's backward to the latent), over
all its phases, from the kernel clock of the traced run's one launch of
``harness.PHASE_EPOCHS`` epochs after the window (``Run.phases``): the only
clock the AE kernel keeps until its wrapper keeps one per launch."""

ROWS = ("rows.forward", "rows.decoder")


def read(run):
    phases = run.phases
    if not phases or not any(k in phases for k in ROWS):
        return None
    total = sum(phases.values())
    return 100.0 * sum(phases.get(k, 0.0) for k in ROWS) / total if total > 0 else None
