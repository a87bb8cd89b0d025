"""The device timeline of a traced window, from ``torch.profiler``'s Chrome
trace: the operations that ran on the card (kernels, copies, fills), and the
benchmark's own host spans around its calls into the program, on one clock,
in seconds.

The host spans are taken on the host clock (:class:`HostSpans`: two clock
reads a call, so that a log line costs what it costs untraced) and placed on
the trace's clock by one anchor: the ``perfbench.window`` range, which the
profiler records, opens at the host time the harness reads just before it.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "perfbench.window"
# calls of one span name on one thread closer than this merge into one span
# (a chunk boundary's burst of log lines)
MERGE_S = 1e-4


class HostSpans:
    """Spans around the benchmark's calls into the program, on the host
    clock."""

    def __init__(self):
        self.items: list = []  # (name, start, end, thread)

    @contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t, time.perf_counter(), threading.get_ident()))

    def wrap(self, name: str, fn):
        def wrapped(*args):
            with self.span(name):
                return fn(*args)

        return wrapped


@dataclasses.dataclass
class Timeline:
    device: list  # (start, end, name), sorted by start
    spans: list  # (start, end, name, thread), host spans on the trace's clock
    window_span: tuple  # (start, end) of the measured window

    @classmethod
    def load(cls, path: str, host: HostSpans = None, anchor: float = 0.0) -> "Timeline":
        """The timeline of the Chrome trace at ``path``; ``host``'s spans
        placed so that ``anchor`` (host clock) falls on the window's start."""
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        device, window = [], None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            start, end = float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6
            if e.get("cat") in DEVICE_CATS:
                device.append((start, end, e.get("name", "")))
            elif e.get("cat") == "user_annotation" and e.get("name") == WINDOW and window is None:
                window = (start, end)
        if window is None:
            raise ValueError(f"the trace holds no {WINDOW} range")
        device.sort()
        shift = window[0] - anchor
        spans: list = []
        for name, t0, t1, thread in sorted((h for h in (host.items if host else [])), key=lambda h: (h[3], h[0], h[1])):
            s, e = t0 + shift, t1 + shift
            last = spans[-1] if spans else None
            if last and last[2] == name and last[3] == thread and s - last[1] < MERGE_S:
                spans[-1] = (last[0], e, name, thread)
            else:
                spans.append((s, e, name, thread))
        return cls(device, spans, window)

    def busy(self, lo: float, hi: float) -> float:
        """Seconds of [lo, hi] in which some device operation ran."""
        return (hi - lo) - sum(e - s for s, e in self.gaps(lo, hi))

    def gaps(self, lo: float, hi: float) -> list:
        """The intervals of [lo, hi] in which no device operation ran."""
        out, edge = [], lo
        for s, e, _ in self.device:
            if e <= lo or s >= hi:
                continue
            if s > edge:
                out.append((edge, s))
            edge = max(edge, e)
        if hi > edge:
            out.append((edge, hi))
        return out

    def kernels(self, part: str, lo: float, hi: float) -> list:
        """(start, end) of the kernels whose name holds ``part``, in [lo, hi]."""
        return [(s, e) for s, e, name in self.device if part in name and s >= lo and e <= hi]

    def host_at(self, t: float) -> str:
        """The innermost benchmark span open at time ``t``, or "outside fit"."""
        open_ = [(e - s, name) for s, e, name, _ in self.spans if s <= t <= e]
        return min(open_)[1] if open_ else "outside fit"

    def breakdown(self, lo: float, hi: float, top: int = 10) -> dict:
        """The device operations that took most time in [lo, hi], summed by
        name, and the longest idle gaps, each named by what the host was
        doing in its middle."""
        by_name: dict = {}
        for s, e, name in self.device:
            if s >= lo and e <= hi:
                by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(lo, hi), key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[name[:160], sec] for name, sec in ops],
            "idle_gaps": [[self.host_at(0.5 * (s + e)), e - s] for s, e in gaps],
        }

    def idle_by_host(self, lo: float, hi: float) -> dict:
        """Idle seconds of [lo, hi] summed by what the host was doing."""
        out: dict = {}
        for s, e in self.gaps(lo, hi):
            name = self.host_at(0.5 * (s + e))
            out[name] = out.get(name, 0.0) + (e - s)
        return out
