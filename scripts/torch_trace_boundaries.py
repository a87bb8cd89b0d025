"""One run of a benchmark cell (``perfbench``) with the program's spans read
out in full: the chunk boundaries' device idle by program span, the parts
against ``fit.boundary_ms``, the kernel clock's shares against
``phase_split``'s, and how far the placed spans land from the profiler's
ranges under the first-``fit`` offset, and how the program's clock meets
the trace's host and device stamps at each launch
(``perfbench.program_spans``). Needs a CUDA card.

    python3 scripts/torch_trace_boundaries.py --workload cylinder.one_seed --seed 7 --seconds 40
    python3 scripts/torch_trace_boundaries.py --workload cylinder.one_seed --seed 7 --seconds 40 --trace 0 --enable

``--trace 0 --enable`` runs the cell untraced with the tracer on
(``profiling.enable()``), to price it. Prints one JSON line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _errors(ranges: dict, recs: list, off: float) -> dict:
    """Per span name, the signed distances (us) of the placed starts and
    ends from the profiler's ranges: median, least and most, and the rank
    of the farthest."""
    import statistics

    by_name: dict = {}
    for r in recs:
        if r.end is not None:
            by_name.setdefault(r.name, []).append((r.start + off, r.end + off))
    out = {}
    for name, mine in by_name.items():
        theirs = ranges.get(name, [])
        if len(theirs) != len(mine):
            continue
        pairs = list(zip(sorted(mine), theirs))
        for edge in (0, 1):
            d = [1e6 * (a[edge] - b[edge]) for a, b in pairs]
            far = max(range(len(d)), key=lambda i: abs(d[i]))
            out[f"{name}.{'start' if edge == 0 else 'end'}"] = [statistics.median(d), min(d), max(d), far, len(d)]
    return out


def _joins(run, recs: list, off: float, runtime_calls: list) -> dict:
    """How the program's clock meets the trace's, per launch of the window
    (us): its kernel's start less its call placed by the first-``fit``
    offset, and less the runtime's launch call on the trace's own host
    timeline (negative where the trace's device stamps run ahead of its
    host stamps), each as [min, median, max] and the series; and, with each
    boundary placed by the call that ends it, the time from the previous
    kernel's end to the end of the ``fit.fetch`` that waited on it (never
    negative where the placement holds)."""
    import statistics

    from perfbench import program_spans

    lo, hi = run.trace_window
    kernels = run.timeline.kernels(program_spans.MEGAKERNEL, lo, hi)
    calls = program_spans.launch_calls(run, recs, off)
    out = {}

    def summary(name, d):
        out[name] = [min(d), statistics.median(d), max(d)]
        out[name + ".series"] = [round(x) for x in d]

    if calls:
        summary("kernel_start_less_call_us", [1e6 * (k[0] - c - off) for k, c in zip(kernels, calls)])
        fetch_ends = sorted(r.end for r in recs if r.name == "fit.fetch" and r.end is not None)
        d = []
        for b in range(len(kernels) - 1):
            shift = kernels[b + 1][0] - calls[b + 1]
            end = kernels[b][1] - shift  # the kernel's end on the program's clock
            after = [f for f in fetch_ends if calls[b] < f < calls[b + 1]]
            if after:
                d.append(1e6 * (after[0] - end))
        if d:
            summary("fetch_end_after_kernel_end_us", d)
    rt = [c for c in runtime_calls if lo <= c <= hi]
    if rt and len(rt) == len(kernels):
        summary("kernel_start_less_runtime_call_us", [1e6 * (k[0] - c) for k, c in zip(kernels, rt)])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=1)
    parser.add_argument("--enable", action="store_true", help="the tracer on without a profiler")
    args = parser.parse_args(argv)

    from desmo_tpu_torch import profiling
    from desmo_tpu_torch.kernels import train_chunk as tc
    from perfbench import harness, program_spans
    from perfbench.timeline import Timeline

    seen: dict = {}
    load = Timeline.load.__func__

    def keep_ranges(cls, path, host=None, anchor=0.0):
        seen["ranges"] = program_spans.ranges(path)
        with open(path) as fh:
            seen["launch_calls"] = sorted(float(e["ts"]) * 1e-6 for e in json.load(fh)["traceEvents"]
                                          if e.get("cat") == "cuda_runtime" and "LaunchCooperativeKernel" in e.get("name", ""))
        return load(cls, path, host, anchor)

    Timeline.load = classmethod(keep_ranges)
    split = tc.phase_split

    def keep_split(*a, **k):
        seen["phase_split"] = split(*a, **k)
        return seen["phase_split"]

    tc.phase_split = keep_split
    reader = harness.reader

    def keep_run(name, root=harness.ROOT):
        read = reader(name, root)

        def wrapped(run):
            seen["run"] = run
            return read(run)

        return wrapped

    harness.reader = keep_run
    if args.enable:
        profiling.enable()
    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload, ROOT)
    result = harness.run(cell, args.seed % 2**63, args.seconds, bool(args.trace), "cuda", T_START)
    out = {"workload": args.workload, "seed": args.seed, "trace": args.trace, "enable": args.enable,
           "card": harness.card_line(), "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
    run = seen.get("run")
    recs = profiling.records()
    if args.trace and run is not None and recs:
        att = program_spans.attribute(run, recs)
        nb = att["boundaries"]
        boundary = out["metrics"]["fit.boundary_ms"]
        parts = {k: 1e3 * v / nb for k, v in att["idle_s"].items()}
        out["boundary_ms_by_part"] = parts
        out["boundary_ms_by_span"] = {k: 1e3 * v / nb for k, v in sorted(att["by_span"].items(), key=lambda kv: -kv[1])}
        out["parts_over_boundary"] = sum(parts.values()) / boundary
        out["outside_share"] = parts["outside"] / boundary
        out["boundaries"] = nb
        out["by_launch"] = att["by_launch"]
        off = program_spans.offset(run, recs)
        worst, n = program_spans.placement_error(run, seen["ranges"], recs, off)
        out["placement_worst_us"] = 1e6 * worst
        out["placement_spans"] = n
        out["placement_us_by_name"] = _errors(seen["ranges"], recs, off)
        out["clock_joins"] = _joins(run, recs, off, seen.get("launch_calls", []))
        if "phase_split" in seen:
            ps = seen["phase_split"]
            total = sum(ps.values())
            out["phase_split_contract_pct"] = 100 * sum(ps[k] for k in program_spans.CONTRACT) / total
            clocks = program_spans.clock_records(run, recs)
            ct = sum(sum(c.values()) for c in clocks)
            out["share_gap_points"] = max(abs(100 * sum(c[k] for c in clocks) / ct - 100 * ps[k] / total)
                                          for k in ps)
            out["launches_with_clock"] = len(clocks)
    out["counters"] = profiling.counters()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
