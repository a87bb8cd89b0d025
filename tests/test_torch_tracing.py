"""The port's tracer (``desmo_tpu_torch.profiling``) on the CPU: off, it
records nothing and changes nothing; under ``torch.profiler`` the fit loops
record their span tree, the checkpoint worker's span under the boundary that
handed it over; the spans placed on the trace's clock by the benchmark's
rule land on the profiler's ranges; the ensemble's counters; the kernel
clock's copy; ``run --profile``."""

import contextlib
import dataclasses
import json
import os
import statistics
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.autograd.profiler as autograd_profiler  # noqa: E402

from desmo_tpu_torch import configs, ensemble, profiling, runner, train  # noqa: E402
from desmo_tpu_torch.__main__ import main as cli_main  # noqa: E402
from desmo_tpu_torch.io import synthetic  # noqa: E402
from desmo_tpu_torch.kernels import train_chunk  # noqa: E402
from perfbench import program_spans  # noqa: E402
from perfbench.timeline import WINDOW, HostSpans, Timeline  # noqa: E402

CPU = torch.device("cpu")
BOUNDARY = {"fit.launch", "fit.fetch", "fit.log", "fit.checkpoint"}
CHUNK = {"chunk.pack", "chunk.enqueue", "chunk.unpack"}


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


def problem(**override):
    """``(cfg, spec, loss_fn, groups, params, batch, chunk)``: the cylinder
    preset at n=64, m=24, r=2, P=2 through the mega-kernel's plain chunk,
    20-epoch chunks, a log line every 5 epochs."""
    base = dict(n=64, m=24, r=2, poly_order=2, omega_init=1.0, lr_omega=1.0, sched_every=1, patience=5,
                chunk_method="megakernel", checkpoint_every=20, log_every=5, num_epochs=60)
    cfg = dataclasses.replace(configs.get("cylinder"), **{**base, **override})
    x = synthetic.cylinder_wake(cfg.n, cfg.m)
    spec, params, loss_fn, groups = runner.build_model(cfg, CPU)
    p, _ = runner.compute_pod(cfg, x, CPU)
    batch = runner.prepare_batch(x, p.modes, CPU)
    return cfg, spec, loss_fn, groups, params, batch, train_chunk.select_chunk(spec, cfg, CPU)


def fit_one(saved=None, log=None, host=None):
    """``train.fit`` of :func:`problem`, inside ``host``'s span ``fit`` where
    given (the harness's own)."""
    cfg, _, loss_fn, groups, params, batch, chunk = problem()
    ckpt = None if saved is None else (lambda st, ep: saved.append(ep))
    with host.span("fit") if host else contextlib.nullcontext():
        return train.fit(loss_fn, groups, cfg, params, batch, log=log, checkpoint_fn=ckpt, chunk=chunk)


def fit_seeds(saved=None, log=None, **kw):
    cfg, spec, *_, batch, _ = problem()
    ckpt = None if saved is None else (lambda st, ep: saved.append(ep))
    return ensemble.fit(cfg, spec, batch, n_seeds=2, num_epochs=40, log=log, checkpoint_fn=ckpt, **kw)[0]


def children(recs, parent) -> set:
    return {r.name for r in recs if r.parent == parent.id}


def test_the_profiler_flag_the_tracer_reads_exists():
    """``torch.autograd.profiler._is_profiler_enabled`` is what turns the
    tracer on under ``torch.profiler``: a torch that renames it fails here."""
    assert autograd_profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert profiling.tracing()
    assert not profiling.tracing()


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name) or real(name))
    assert profiling.span("a") is profiling.span("b")  # one shared object: no allocation
    fit_one(saved=[], log=lambda line: None)
    fit_seeds(saved=[], log=lambda line: None)
    assert profiling.records() == [] and opened == []
    with profiling.enable():
        with profiling.span("a"):
            pass
    assert [r.name for r in profiling.records()] == ["a"] and opened == ["a"]


@pytest.mark.parametrize("which", ["train", "ensemble"])
def test_tracing_changes_no_bit(which):
    run = fit_one if which == "train" else fit_seeds
    off = run(saved=[], log=lambda line: None)
    with profiling.enable():
        on = run(saved=[], log=lambda line: None)
    assert profiling.records()
    assert list(off.history) == list(on.history)
    for k in off.history:
        np.testing.assert_array_equal(off.history[k], on.history[k])
    for tree in ("params", "mu", "nu"):
        for k, v in getattr(off.state, tree).items():
            assert torch.equal(v, getattr(on.state, tree)[k]), (tree, k)
    assert torch.equal(off.state.sched.lrs, on.state.sched.lrs) and off.state.epoch == on.state.epoch


def test_traced_train_fit_records_its_span_tree():
    saved = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fit_one(saved=saved, log=lambda line: None)
    recs = profiling.records()
    assert all(r.end is not None and r.end >= r.start for r in recs)
    (top,) = [r for r in recs if r.parent is None]
    assert top.name == "fit" and top.thread == threading.get_ident()
    assert children(recs, top) == BOUNDARY | {"fit.drain"}
    launches = [r for r in recs if r.name == "fit.launch"]
    assert len(launches) == 3 and all(children(recs, r) == CHUNK for r in launches)
    assert len([r for r in recs if r.name == "fit.log"]) == 3  # one per boundary, not per line
    writes = [r for r in recs if r.name == "ckpt.write"]
    assert len(writes) == len(saved) == 3
    assert all(r.thread != top.thread and recs[r.parent].name == "fit.checkpoint" for r in writes)
    assert profiling.counters()["ckpt.writes"] == 3


def test_traced_ensemble_fit_records_its_span_tree():
    saved = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fit_seeds(saved=saved, log=lambda line: None)
    recs = profiling.records()
    (top,) = [r for r in recs if r.parent is None]
    assert top.name == "fit" and top.thread == threading.get_ident()
    assert children(recs, top) == BOUNDARY | {"fit.init", "fit.snapshot", "fit.drain"}
    assert all(children(recs, r) == CHUNK for r in recs if r.name == "fit.launch")
    assert len([r for r in recs if r.name == "fit.checkpoint"]) == len(saved) == 2
    writes = [r for r in recs if r.name == "ckpt.write"]
    assert len(writes) == 2
    assert all(r.thread != top.thread and recs[r.parent].name == "fit.checkpoint" for r in writes)
    assert profiling.counters()["ckpt.writes"] == 2


def test_placed_spans_land_on_their_profiler_ranges(tmp_path):
    """The harness's way: its own ``fit`` span on the host clock, anchored at
    the window's range; the program's spans, placed by the offset that maps
    its first ``fit`` onto the harness's, land on the ranges the profiler
    recorded for them: half of them within 20 us plus twice the profiler's
    own cost of a range on this machine (the program reads its clock just
    before each of the range's op calls, which cost a CPU 10-60 us inside a
    fit, 10-20 us empty), and every one within 1 ms (a span misplaced by the
    rule would miss by the length of a chunk). Where the checkpoint worker
    holds the GIL a range's edge waits for it, 0.1-0.2 ms on a CPU. A
    session's first ranges cost most (0.03-4 ms: the op's first lookup, the
    session's first event), and the harness's anchor, read just before its
    window's range, is late by as much: empty ranges before the anchor take
    that cost here; on the card the launches place each boundary
    (``program_spans.launch_calls``)."""
    host = HostSpans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        cost = []
        for k in range(12):
            t = time.perf_counter()
            with torch.profiler.record_function(f"empty{k}"):
                pass
            cost.append(time.perf_counter() - t)
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            for _ in range(2):
                fit_one(saved=[], log=lambda line: None, host=host)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    tl = Timeline.load(path, host, t0)
    run = types.SimpleNamespace(timeline=tl, trace_window=tl.window_span)
    recs = profiling.records()
    off = program_spans.offset(run, recs)
    ranges = program_spans.ranges(path)
    seen: dict = {}
    far = []
    for r in recs:
        if r.thread == threading.get_ident():
            k = seen[r.name] = seen.get(r.name, -1) + 1
            start, end = ranges[r.name][k]
            far += [abs(r.start + off - start), abs(r.end + off - end)]
    assert len(far) == 2 * (7 * 6 + 2 * 2)  # 6 chunks of 7 spans; fit and fit.drain twice
    assert statistics.median(far) < 20e-6 + 2 * statistics.median(cost[2:]), (statistics.median(far), cost)
    assert max(far) < 1e-3
    worst, n = program_spans.placement_error(run, ranges, recs)
    assert worst == max(far) and n == len(far) // 2


def test_rollbacks_and_frozen_seeds_are_counted():
    """``test_fit_rolls_back_and_freezes_diverged_seeds``'s planted
    divergence: seeds 1 and 2 overflow at init (phi jitter 1e200), one
    rollback freezes both."""
    cfg, spec, *_, batch, _ = problem(chunk_method="auto", checkpoint_every=8)
    before = profiling.counters()
    _, best, finals = ensemble.fit(cfg, spec, batch, n_seeds=3, num_epochs=16, phi_sigma=1e200, log=None)
    after = profiling.counters()
    assert best == 0 and np.isinf(finals[1:]).all()
    assert after["ensemble.rollbacks"] - before.get("ensemble.rollbacks", 0) == 1
    assert after["ensemble.frozen_seeds"] - before.get("ensemble.frozen_seeds", 0) == 2


def test_spans_and_counters_from_many_threads():
    """More threads than cores, switching every microsecond: no count is
    lost, every record keeps its own id, and each thread's spans nest under
    that thread's own."""
    threads, rounds = 4 * (os.cpu_count() or 1), 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(rounds):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    profiling.count("stress")

    try:
        with profiling.enable():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    recs = profiling.records()
    assert profiling.counters()["stress"] == threads * rounds
    assert [r.id for r in recs] == list(range(2 * threads * rounds))
    for r in recs:
        assert (r.parent is None) == (r.name == "outer")
        if r.name == "inner":
            assert recs[r.parent].name == "outer" and recs[r.parent].thread == r.thread


def test_kernel_clock_is_kept_only_while_tracing():
    names = ("a", "b", "c")
    ns = torch.tensor([5, 7, 11], dtype=torch.int64)
    work = torch.cat([torch.zeros(3), ns.view(torch.float32), torch.zeros(2)])
    src = work[3:3 + 2 * len(names)]
    profiling.kernel_clock(src, names)  # off: nothing kept
    with profiling.enable():
        with profiling.span("chunk.enqueue"):
            profiling.kernel_clock(src, names)
        with profiling.span("chunk.enqueue"):
            profiling.kernel_clock(src * 0, names)
    first, second = profiling.records()
    assert first.clock == {"a": 5, "b": 7, "c": 11} and second.clock == {"a": 0, "b": 0, "c": 0}


def test_run_profile_writes_the_trace_and_the_spans(tmp_path):
    out = tmp_path / "prof"
    rc = cli_main(["run", "--preset", "cylinder", "--synthetic", "--epochs", "4", "--device", "cpu",
                   "--chunk-method", "megakernel", "--out-dir", str(tmp_path / "runs"), "--profile", str(out)])
    assert rc == 0
    spans = json.loads((out / "spans.json").read_text())
    names = {r["name"] for r in spans["records"]}
    assert {"fit", "fit.launch", "fit.checkpoint", "ckpt.write"} <= names | CHUNK
    assert spans["counters"]["ckpt.writes"] >= 1 and "fused_train_chunk.launches" in spans["counters"]
    ranges = program_spans.ranges(str(out / "trace.json"))
    assert {"fit", "fit.launch", "chunk.enqueue"} <= set(ranges)


def test_ensemble_json_reports_rollbacks_and_frozen_seeds(tmp_path):
    cfg, *_ = problem(chunk_method="auto", n_seeds=2, num_epochs=20)
    x = synthetic.cylinder_wake(cfg.n, cfg.m)
    runner.run(cfg, x, out_dir=str(tmp_path), echo=False, device=CPU)
    report = json.loads((tmp_path / cfg.name / "ensemble.json").read_text())
    assert report["rollbacks"] == 0 and report["frozen_seeds"] == 0
