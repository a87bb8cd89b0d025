"""Snapshot I/O: the synthetic generator, the VTK readers and the native loader."""
