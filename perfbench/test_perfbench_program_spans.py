"""The readers of the program's spans (``perfbench.program_spans`` and the
metrics built on it) on a synthetic timeline and synthetic records: a gap
split across spans and across a copy, a worker thread's span that takes no
idle, idle outside any span, the launches-less-one base, the sum to
``fit.boundary_ms``, the kernel clock's share, each boundary placed by the
launch call that ends it, and None where there is nothing to read."""

import dataclasses
from typing import Optional

import pytest

from perfbench import harness, program_spans
from perfbench.timeline import Timeline

KERNEL = "void train_chunk_kernel<48, false>(Params)"
SHIFT = 100.0  # the program's clock runs this far ahead of the trace's
BOUNDARY = ("fit.boundary_launch_ms", "fit.boundary_fetch_ms", "fit.boundary_log_ms",
            "fit.boundary_checkpoint_ms")


@dataclasses.dataclass
class Rec:
    id: int
    name: str
    start: float
    end: Optional[float]
    thread: int
    parent: Optional[int]
    clock: Optional[dict] = None
    launched: Optional[float] = None


def records() -> list:
    """Three launches (0.1-0.4, 0.5-0.8, 0.9-1.0 on the trace); the first
    boundary: fetch 20 ms, log 30, checkpoint 20 (its write on a worker
    thread beside it), ``fit`` 10, the next launch's call 20; the second: a
    copy at 0.85-0.86 splits the gap, fetch 30 ms, log 20 + 20 around the
    copy, ``fit`` 10, nothing open 5, the next job's launch call 5."""
    spans = [
        ("fit", 0.0, 0.89, None, 1), ("fit.launch", 0.05, 0.1, 0, 1), ("chunk.pack", 0.05, 0.07, 1, 1),
        ("chunk.enqueue", 0.07, 0.1, 1, 1), ("fit.fetch", 0.4, 0.42, 0, 1), ("fit.log", 0.42, 0.45, 0, 1),
        ("fit.checkpoint", 0.45, 0.47, 0, 1), ("ckpt.write", 0.46, 0.49, 6, 2), ("fit.launch", 0.48, 0.5, 0, 1),
        ("chunk.enqueue", 0.485, 0.5, 8, 1), ("fit.fetch", 0.8, 0.83, 0, 1), ("fit.log", 0.83, 0.88, 0, 1),
        ("fit", 0.895, 1.05, None, 1), ("fit.launch", 0.895, 0.9, 12, 1), ("chunk.enqueue", 0.896, 0.9, 13, 1),
    ]
    out = [Rec(i, name, s + SHIFT, e + SHIFT, th, p) for i, (name, s, e, p, th) in enumerate(spans)]
    clocks = {3: {"rows.xb": 20, "columns.ax": 10, "columns.ax_barrier": 5, "reduce": 65},
              9: {"rows.xb": 10, "columns.ax": 10, "columns.ax_barrier": 0, "reduce": 80},
              14: {"rows.xb": 50, "columns.ax": 0, "columns.ax_barrier": 0, "reduce": 50}}
    for i, clock in clocks.items():
        out[i].clock = clock
    return out


def run(device_extra=(), window=(0.0, 1.1)):
    device = sorted([(0.1, 0.4, KERNEL), (0.5, 0.8, KERNEL), (0.9, 1.0, KERNEL), (0.85, 0.86, "Memcpy DtoH"),
                     *device_extra])
    tl = Timeline(device=device, spans=[(0.0, 1.05, "fit", 1)], window_span=window)
    return harness.Run(setup_s=1.0, window_s=1.0, seed_epochs=6000, seeds=1, least_epoch_s=1e-6,
                       setup_spans={}, kernel="train_chunk_kernel", timeline=tl, trace_window=window)


@pytest.fixture
def synthetic(monkeypatch):
    recs = records()
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    return recs


def test_a_gap_is_split_by_overlap_and_the_worker_takes_none(synthetic):
    att = program_spans.attribute(run())
    assert att["boundaries"] == 2
    assert att["idle_s"] == pytest.approx({"launch": 0.025, "fetch": 0.05, "log": 0.07, "checkpoint": 0.02,
                                           "other": 0.02, "outside": 0.005})
    assert "ckpt.write" not in att["by_span"]
    assert att["by_span"]["chunk.enqueue"] == pytest.approx(0.019)
    assert att["by_span"]["fit.launch"] == pytest.approx(0.006)


def test_the_readers_divide_by_the_launches_less_one(synthetic):
    r = run()
    got = {name: harness.reader(name)(r) for name in BOUNDARY}
    assert got == pytest.approx({"fit.boundary_launch_ms": 12.5, "fit.boundary_fetch_ms": 25.0,
                                 "fit.boundary_log_ms": 35.0, "fit.boundary_checkpoint_ms": 10.0})
    # a fourth launch adds a boundary of 100 ms with no program span open
    r4 = run(device_extra=[(1.1, 1.2, KERNEL)], window=(0.0, 1.3))
    assert harness.reader("fit.boundary_log_ms")(r4) == pytest.approx(70.0 / 3)


def test_the_parts_sum_to_the_boundary(synthetic):
    r = run()
    att = program_spans.attribute(r)
    parts = sum(harness.reader(name)(r) for name in BOUNDARY)
    rest = 1e3 * (att["idle_s"]["other"] + att["idle_s"]["outside"]) / att["boundaries"]
    assert parts + rest == pytest.approx(harness.reader("fit.boundary_ms")(r))


def test_the_kernel_clock_share_reads_the_window_launches(synthetic):
    assert harness.reader("megakernel.contract_pct")(run()) == pytest.approx(100 * 105 / 300)
    # the third launch's call placed after the window closes
    assert harness.reader("megakernel.contract_pct")(run(window=(0.0, 0.8))) == pytest.approx(100 * 55 / 200)


def test_each_boundary_is_placed_by_its_launch_call(synthetic):
    """The harness's anchor 2 ms late and one kernel stamped 3 ms early: the
    boundaries placed by the calls that end them read as placed exactly;
    without the calls the 2 ms misplace them."""
    exact = program_spans.attribute(run())["idle_s"]
    for rec, kernel_start in zip((r for r in synthetic if r.clock), (0.1, 0.5, 0.9)):
        rec.launched = kernel_start + SHIFT
    late = run()
    late.timeline.spans = [(0.002, 1.052, "fit", 1)]
    att = program_spans.attribute(late)
    assert att["by_launch"] and att["idle_s"] == pytest.approx(exact)
    early = run(device_extra=[], window=(0.0, 1.1))
    early.timeline.device = sorted([(0.1, 0.4, KERNEL), (0.497, 0.8, KERNEL), (0.9, 1.0, KERNEL),
                                    (0.85, 0.86, "Memcpy DtoH")])
    att = program_spans.attribute(early)
    # the first boundary's gap is 3 ms shorter; placed by its end, it loses
    # its first 3 ms, the fetch's
    assert att["idle_s"]["fetch"] == pytest.approx(exact["fetch"] - 0.003)
    assert {k: v for k, v in att["idle_s"].items() if k != "fetch"} == pytest.approx(
        {k: v for k, v in exact.items() if k != "fetch"})
    synthetic[3].launched = None  # a call missing: the kernels no longer pair
    att = program_spans.attribute(late)
    assert not att["by_launch"] and att["idle_s"] != pytest.approx(exact)


def test_nothing_to_read_reads_none(monkeypatch):
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    for name in BOUNDARY + ("megakernel.contract_pct",):
        assert harness.reader(name)(run()) is None
        assert harness.reader(name)(dataclasses.replace(run(), timeline=None, trace_window=None)) is None
    assert program_spans.attribute(run(), records=[]) is None


def test_no_tracer_in_the_program_reads_none(monkeypatch):
    """A program without ``desmo_tpu_torch.profiling`` (the parent of the
    change that added it)."""
    import builtins

    real = builtins.__import__

    def without(name, *args, **kwargs):
        if name == "desmo_tpu_torch" and args[2] and "profiling" in args[2]:
            raise ImportError("no profiling")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", without)
    assert program_spans.program_records() is None
    assert harness.reader("fit.boundary_launch_ms")(run()) is None
