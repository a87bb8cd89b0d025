"""Mean device-idle ms at a chunk boundary of the traced window put down to the
program's ``fit.fetch`` span (metrics to the host, the finite check, the
history), on the fit's thread; the base is ``fit.boundary_ms``'s, the
launches less one (``perfbench.program_spans``)."""

from perfbench import program_spans


def read(run):
    return program_spans.boundary_ms(run, "fetch")
