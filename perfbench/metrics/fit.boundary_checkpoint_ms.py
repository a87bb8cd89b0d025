"""Mean device-idle ms at a chunk boundary of the traced window put down to the
program's ``fit.checkpoint``, ``fit.drain`` and ``fit.snapshot`` spans (the
checkpoint's host copy and hand-off, or the synchronous write, the wait on
the last write, the rollback snapshot), on the fit's thread; the base is
``fit.boundary_ms``'s, the launches less one (``perfbench.program_spans``)."""

from perfbench import program_spans


def read(run):
    return program_spans.boundary_ms(run, "checkpoint")
