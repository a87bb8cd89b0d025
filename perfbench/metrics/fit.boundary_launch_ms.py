"""Mean device-idle ms at a chunk boundary of the traced window put down to the
program's ``fit.launch`` span and its ``chunk.*`` children (the chunk call:
pack, enqueue, unpack), on the fit's thread; the base is
``fit.boundary_ms``'s, the launches less one (``perfbench.program_spans``)."""

from perfbench import program_spans


def read(run):
    return program_spans.boundary_ms(run, "launch")
