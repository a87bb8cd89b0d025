"""Share of the traced window's mega-kernel launches' kernel clock spent in
the Fourier form's series phases (``series.update``: the series and period
Adamax, B rebuilt from the new series and each block's B Bᵀ partial;
``series.gram``: their reduction) over all its phases, from each launch's
clock as the program kept it (``perfbench.program_spans``). The series'
gradient partials, formed in ``columns.barrier`` and summed in
``finalize``, are not counted here."""

from perfbench import program_spans


def read(run):
    return program_spans.series_pct(run)
