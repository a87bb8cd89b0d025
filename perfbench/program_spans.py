"""The program's own spans and kernel clock in a traced run, placed on the
trace's clock, and what the per-layer metrics built on them read.

The program records its spans (``desmo_tpu_torch.profiling``: name, start and
end on ``time.perf_counter()``, thread, parent, and on a launch's
``chunk.enqueue`` its kernel clock and the time of its launch call) while a
``torch.profiler`` session is active, so a ``--trace 1`` run holds them with no
change to the harness. :func:`offset` places them on the trace's clock as the
harness places its own: the program's first ``fit`` span opens where the
harness's first ``fit`` span (``Timeline.spans``) opens; both are on
``perf_counter``, and the first is taken because the harness merges later
``fit`` spans closer than 0.1 ms. That is good to a few ms: the harness's
anchor is read before its window's range opens, which pays the profiler
session's first event (0.2-4 ms on the card), and on the card the trace's
device stamps part from its host stamps by up to 4 ms within a window (a
kernel stamped before the runtime call that launched it). So the idle of each
boundary is placed by the launch that ends it, where the window's launches
carry their calls (:func:`launch_calls`): the call is put at its kernel's
start, which it precedes by 15-30 us on an idle card.

The device-idle time between two consecutive chunk-kernel launches of the
window is put down, instant by instant, to the innermost program span open on
the fit's thread (spans on other threads, the checkpoint worker's, take none):
a gap is split by overlap. Each span counts under the boundary part whose
subtree holds it (:data:`PARTS`), else under ``other`` (``fit`` itself,
``fit.init``, ``fit.rollback``); idle with no program span open is
``outside``. The parts sum to the idle that ``fit.boundary_ms`` reads.

A program without ``desmo_tpu_torch.profiling``, or a run that recorded no
spans, reads None.
"""

from __future__ import annotations

import bisect
import json

FIT = "fit"
# the mega-kernel's name in the device trace: the boundary parts read its
# cells alone, since the AE kernel's wrapper keeps no ``chunk.*`` spans and no
# launch calls; the rest here takes the cell's own kernel (``Run.kernel``)
MEGAKERNEL = "train_chunk_kernel"
# the boundary part each span's subtree counts under
PARTS = {
    "fit.launch": "launch", "fit.fetch": "fetch", "fit.log": "log",
    "fit.checkpoint": "checkpoint", "fit.drain": "checkpoint", "fit.snapshot": "checkpoint",
}
CATEGORIES = ("launch", "fetch", "log", "checkpoint", "other", "outside")
# the kernel clock's phases of X·Bᵀ and AᵀX
CONTRACT = ("rows.xb", "columns.ax", "columns.ax_barrier")
# the Fourier form's phases: the series and period Adamax with B rebuilt
# from the new series and its B Bᵀ partials, then their reduction
SERIES = ("series.update", "series.gram")


def program_records():
    """The program's span records, or None where the program has no tracer
    or recorded nothing."""
    try:
        from desmo_tpu_torch import profiling
    except ImportError:
        return None
    return profiling.records() or None


def offset(run, records) -> float | None:
    """Seconds to add to a program time to place it on the trace's clock:
    the program's first ``fit`` span onto the harness's."""
    harness = [s[0] for s in run.timeline.spans if s[2] == FIT]
    program = [r.start for r in records if r.name == FIT]
    if not harness or not program:
        return None
    return min(harness) - min(program)


def launch_calls(run, records, off: float) -> list | None:
    """The program times of the calls that launched the window's chunk-kernel
    launches (``Record.launched``, placed in the window by ``off``), one per
    kernel in order, or None where they do not pair one to one."""
    lo, hi = run.trace_window
    kernels = run.timeline.kernels(run.kernel, lo, hi)
    calls = sorted(r.launched for r in records if r.launched is not None and lo <= r.launched + off <= hi)
    return calls if calls and len(calls) == len(kernels) else None


def _parts(records) -> dict:
    """Record id -> boundary part of the subtree that holds it."""
    out: dict = {}
    for r in sorted(records, key=lambda r: r.id):
        out[r.id] = PARTS.get(r.name) or out.get(r.parent, "other")
    return out


def _pieces(spans: list) -> list:
    """Disjoint (start, end, label) pieces of spans nested on one thread,
    each labelled by the innermost span open over it."""
    out, stack, edge = [], [], float("-inf")

    def close(upto):
        nonlocal edge
        while stack and stack[-1][1] <= upto:
            _, end, label = stack.pop()
            if end > edge:
                out.append((edge, end, label))
                edge = end

    for s, e, label in sorted(spans, key=lambda x: (x[0], -x[1])):
        close(s)
        if stack and s > edge:
            out.append((edge, s, stack[-1][2]))
        edge = max(edge, s)
        stack.append((s, e, label))
    close(float("inf"))
    return out


def attribute(run, records=None) -> dict | None:
    """The window's boundary idle by what the fit's thread was doing:
    ``boundaries`` (launches less one), ``idle_s`` by part
    (:data:`CATEGORIES`), ``by_span`` by the innermost span's name
    (``outside`` where none is open) and ``by_launch`` (whether each
    boundary was placed by its launch call)."""
    if run.timeline is None:
        return None
    records = program_records() if records is None else records
    if not records:
        return None
    off = offset(run, records)
    if off is None:
        return None
    lo, hi = run.trace_window
    launches = run.timeline.kernels(run.kernel, lo, hi)
    if len(launches) < 2:
        return None
    calls = launch_calls(run, records, off)
    fit_thread = min((r for r in records if r.name == FIT), key=lambda r: r.start).thread
    parts = _parts(records)
    pieces = _pieces([(r.start, r.end, (parts[r.id], r.name)) for r in records
                      if r.thread == fit_thread and r.end is not None])
    starts = [p[0] for p in pieces]
    idle = dict.fromkeys(CATEGORIES, 0.0)
    by_span: dict = {}
    for b, ((_, a_end), (b_start, _)) in enumerate(zip(launches, launches[1:])):
        # the boundary's spans placed by the call that ends it
        shift = b_start - calls[b + 1] if calls else off
        for s, e in run.timeline.gaps(a_end, b_start):
            s, e = s - shift, e - shift
            covered = 0.0
            k = max(0, bisect.bisect_right(starts, s) - 1)
            while k < len(pieces) and pieces[k][0] < e:
                p0, p1, (part, name) = pieces[k]
                over = min(e, p1) - max(s, p0)
                if over > 0:
                    idle[part] += over
                    by_span[name] = by_span.get(name, 0.0) + over
                    covered += over
                k += 1
            idle["outside"] += (e - s) - covered
            by_span["outside"] = by_span.get("outside", 0.0) + (e - s) - covered
    return {"boundaries": len(launches) - 1, "idle_s": idle, "by_span": by_span, "by_launch": calls is not None}


def boundary_ms(run, part: str, records=None) -> float | None:
    """Mean idle ms a chunk boundary put down to ``part``; None where the
    cell's chunk kernel is not the mega-kernel (:data:`MEGAKERNEL`)."""
    if run.kernel != MEGAKERNEL:
        return None
    att = attribute(run, records)
    if att is None:
        return None
    return 1e3 * att["idle_s"][part] / att["boundaries"]


def clock_records(run, records=None) -> list | None:
    """The kernel clocks (ns by phase) of the launches placed in the
    window."""
    if run.timeline is None:
        return None
    records = program_records() if records is None else records
    if not records:
        return None
    off = offset(run, records)
    if off is None:
        return None
    lo, hi = run.trace_window
    return [r.clock for r in records if r.clock and lo <= r.start + off <= hi]


def phase_pct(run, phases, records=None) -> float | None:
    """The window's launches' share of kernel-clock time in ``phases``,
    over all phases; None where no launch's clock has them."""
    clocks = clock_records(run, records)
    if not clocks or not any(k in c for c in clocks for k in phases):
        return None
    total = sum(sum(c.values()) for c in clocks)
    if total <= 0:
        return None
    return 100.0 * sum(c.get(k, 0) for c in clocks for k in phases) / total


def contract_pct(run, records=None) -> float | None:
    """The window's launches' share of kernel-clock time in X·Bᵀ and AᵀX
    (:data:`CONTRACT`), over all phases."""
    return phase_pct(run, CONTRACT, records)


def series_pct(run, records=None) -> float | None:
    """The window's launches' share of kernel-clock time in the Fourier
    form's series phases (:data:`SERIES`), over all phases."""
    return phase_pct(run, SERIES, records)


def ranges(path: str) -> dict:
    """The ``user_annotation`` ranges of a Chrome trace by name, each a
    sorted list of (start, end) in seconds on the trace's clock."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and "dur" in e:
            t = float(e["ts"]) * 1e-6
            out.setdefault(e["name"], []).append((t, t + float(e["dur"]) * 1e-6))
    return {k: sorted(v) for k, v in out.items()}


def placement_error(run, trace_ranges: dict, records=None, off: float | None = None) -> tuple | None:
    """The largest distance, in seconds, from a placed span's start and end
    (placed by ``off``, by default :func:`offset`) to those of the
    profiler's range of the same name and rank among its name's, and how
    many spans were compared. Names whose count differs from the trace's (a
    thread the profiler does not record) are left out."""
    records = program_records() if records is None else records
    if not records:
        return None
    off = offset(run, records) if off is None else off
    if off is None:
        return None
    by_name: dict = {}
    for s, e, name in ((r.start + off, r.end + off, r.name) for r in records if r.end is not None):
        by_name.setdefault(name, []).append((s, e))
    worst, n = 0.0, 0
    for name, mine in by_name.items():
        theirs = trace_ranges.get(name, [])
        if len(theirs) != len(mine):
            continue
        for (s, e), (ts, te) in zip(sorted(mine), theirs):
            worst = max(worst, abs(s - ts), abs(e - te))
            n += 1
    return worst, n
