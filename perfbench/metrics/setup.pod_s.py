"""Seconds of ``runner.compute_pod`` in set-up (host clock, synchronized
before and after)."""


def read(run):
    return run.setup_spans.get("pod")
