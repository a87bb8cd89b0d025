"""Share of the traced window's mega-kernel launches' kernel clock spent in
X·Bᵀ and AᵀX (``rows.xb``, ``columns.ax``, ``columns.ax_barrier``) over all
its phases, from each launch's clock as the program kept it
(``perfbench.program_spans``)."""

from perfbench import program_spans


def read(run):
    return program_spans.contract_pct(run)
