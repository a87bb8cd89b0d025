"""The harness on the CPU at a tiny size: cells found by name (a packed
Fourier cell added as files alone too), a run that reads correct, each
fault a run can have caught with the timed path broken underneath (and the
Fourier form's own: the periods held, the top harmonic left out of B; the
AE form's: the decoder's term left out, the reference in TF32 in the
chunk's place), the control caught, the timeline's readers, the refusals
(no card, a bare directory, JAX loaded), and one short run on the card."""

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from desmo_tpu_torch import optim, train
from desmo_tpu_torch.kernels import ae_chunk
from desmo_tpu_torch.kernels import train_chunk as tc
from perfbench import check, control, harness
from perfbench.timeline import HostSpans, Timeline

ROOT = harness.ROOT
AE = "ae_cylinder.one_seed"
# the AE cell's entries, which BENCHMARK.json leaves out until the program's
# float32 factored rec is mended (PERF.md §7): the harness runs it as any
# other cell; once BENCHMARK.json has them, these tests take them from there
AE_ENTRIES = {
    "configs": [dict(name="ae_cylinder", source="s", file="perfbench/configs/ae_cylinder.json", reduced=[], why="w")],
    "workloads": [dict(name=AE, config="ae_cylinder", traffic="one_seed", chips=1, why="w")],
    "per_layer": [dict(name="ae_kernel.rows_pct", unit="%", better="lower", source="program_counter",
                       layer="AE kernel", moves="train_steps_per_s", workloads=[AE])],
}
# the AE cell's limits for the tiny runs here. No limits file is committed
# for it: its limits are read at its size, with control.py, once the program
# is mended (PERF.md §7). These stand for no run at the cell's size.
AE_LIMITS = {"pod": 2e-05, "init": 0.0, "loss": 0.001, "ortho": 0.0001, "grad": 0.003, "grad_encoder": 0.05,
             "grad_decoder": 5e-05, "update": 0.3, "update_phi": 0.12, "launch": 1e-05, "launch_ortho": 1e-05,
             "window_loss": 0.003, "window_ortho": 5e-05, "checkpoint": 0.0}
# the root each cell's files are found under, where it is not ROOT
ROOTS = {}


def with_ae(bench: dict) -> dict:
    """``bench`` with the AE cell's entries."""
    return {k: v + AE_ENTRIES[k] if k in AE_ENTRIES else v for k, v in bench.items()}


BENCH = with_ae(harness.load_benchmark())
TINY = dict(n=400, m=80, chunk_method="megakernel")
TINY_TRAFFIC = dict(job_epochs=60, log_every=5, checkpoint_every=10)
CELLS = ["cylinder.one_seed", "aneurysm.seeds4", "fourier_cylinder.one_seed", "fourier_cylinder.seeds8",
         "ae_cylinder.one_seed"]
# the plain chunk each cell's timed path runs on the CPU
PLAIN = {name: (ae_chunk, "ae_chunk_plain") if name.startswith("ae_") else (tc, "train_chunk_plain_packed")
         for name in CELLS}


@pytest.fixture(scope="module", autouse=True)
def _ae_root(tmp_path_factory):
    """A root that holds the AE cell's configuration and traffic, and
    ``AE_LIMITS`` as its limits file."""
    root = tmp_path_factory.mktemp("ae_root")
    for sub in ("configs/ae_cylinder.json", "traffic/one_seed.json"):
        (root / "perfbench" / sub).parent.mkdir(parents=True)
        shutil.copy(ROOT / "perfbench" / sub, root / "perfbench" / sub)
    (root / "perfbench" / "limits").mkdir()
    (root / "perfbench" / "limits" / f"{AE}.json").write_text(json.dumps(AE_LIMITS))
    ROOTS[AE] = root


def find_cell(name: str):
    return harness.find_cell(BENCH, name, ROOTS.get(name, ROOT))


def tiny_cell(name: str):
    cell = find_cell(name)
    cell.config["run_config"].update(TINY)
    cell.traffic.update(TINY_TRAFFIC)
    return cell


def tiny_run(name: str, trace: bool = False, seed: int = 2**31 + 7):
    # a window that reaches the first checkpoint and the epoch after it, which
    # the one-seed cells' window numbers compare, also with the CPU shared
    return harness.run(tiny_cell(name), seed, 2.0, trace, "cpu", time.perf_counter())


def test_every_cell_has_its_files_and_every_metric_a_reader():
    for w in BENCH["workloads"]:
        cell = find_cell(w["name"])
        assert cell.chips == 1 and cell.end_to_end and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]))
        assert {"pod", "init", "loss", "ortho", "grad", "update", "update_phi", "launch", "launch_ortho",
                "checkpoint"} <= set(cell.limits)


def _digests(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in base:
                path = os.path.join(base, f)
                out[os.path.relpath(path, root)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def test_a_cell_added_as_files_is_found_without_editing_one(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "perfbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "perfbench"
    conf = json.loads((pb / "configs" / "cylinder.json").read_text())
    conf["run_config"].update(name="channel", n=16384, m=1000, poly_order=2, beta=1e-6)
    (pb / "configs" / "channel.json").write_text(json.dumps(conf))
    (pb / "traffic" / "seeds3.json").write_text(json.dumps(dict(seeds=3, job_epochs=60000, log_every=10,
                                                                checkpoint_every=2000)))
    (pb / "limits" / "channel.seeds3.json").write_text((pb / "limits" / "aneurysm.seeds4.json").read_text())
    (pb / "metrics" / "ensemble.live_seed_pct.py").write_text("def read(run):\n    return 100.0\n")
    bench["configs"].append(dict(name="channel", source="s", file="perfbench/configs/channel.json", reduced=[],
                                 why="w"))
    bench["workloads"].append(dict(name="channel.seeds3", config="channel", traffic="seeds3", chips=1, why="w"))
    bench["per_layer"].append(dict(name="ensemble.live_seed_pct", unit="%", better="higher", source="program_counter",
                                   layer="ensemble", moves="train_steps_per_s", workloads=["channel.seeds3"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell(bench, "channel.seeds3", tmp_path)
    assert cell.traffic["seeds"] == 3 and cell.config["run_config"]["n"] == 16384
    assert [m["name"] for m in cell.per_layer][-1] == "ensemble.live_seed_pct"
    assert harness.reader("ensemble.live_seed_pct", tmp_path)(None) == 100.0
    assert "ensemble.live_seed_pct" not in [m["name"] for m in harness.find_cell(bench, "cylinder.one_seed",
                                                                                 tmp_path).per_layer]
    # the metrics every train_steps_per_s cell reports reach it too
    assert {"megakernel_roofline", "megakernel.contract_pct", "fit.boundary_ms", "fit.boundary_launch_ms",
            "fit.boundary_fetch_ms", "fit.boundary_log_ms", "fit.boundary_checkpoint_ms", "device.idle_pct",
            "step.mfu"} <= {m["name"] for m in cell.per_layer}
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_packed_fourier_cell_added_as_files_runs_without_editing_one(tmp_path):
    """A packed cell of the Fourier configuration (2 seeds, its own traffic
    and limits files, as ``fourier_cylinder.seeds8`` would come) is found and
    runs correct at the tiny size with no file of the harness edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "perfbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "perfbench"
    (pb / "traffic" / "twin2.json").write_text(json.dumps(dict(seeds=2, job_epochs=100000, log_every=10,
                                                               checkpoint_every=2000)))
    limits = json.loads((pb / "limits" / "fourier_cylinder.one_seed.json").read_text())
    (pb / "limits" / "fourier_cylinder.twin2.json").write_text(json.dumps(
        {k: v for k, v in limits.items() if not k.startswith("window_")}))  # packed cells check no window state
    bench["workloads"].append(dict(name="fourier_cylinder.twin2", config="fourier_cylinder", traffic="twin2", chips=1,
                                   why="w"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell(bench, "fourier_cylinder.twin2", tmp_path)
    assert cell.traffic["seeds"] == 2 and cell.config["reference"] == "fourier"
    cell.config["run_config"].update(TINY)
    cell.traffic.update(TINY_TRAFFIC)
    out = harness.run(cell, 2**31 + 7, 0.5, False, "cpu", time.perf_counter())
    assert out["correct"] is True, out["compared"]
    assert "window_loss" not in out["compared"] and out["compared"]["init"]["value"] == 0.0
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("name", CELLS)
def test_a_run_on_the_cpu_reads_correct(name):
    out = tiny_run(name)
    assert out["correct"] is True, out["compared"]
    assert set(out["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    assert all(v["value"] <= v["limit"] for v in out["compared"].values())
    # the last checkpoint's .pt, read back by the reference's key scheme, exactly
    assert out["compared"]["checkpoint"]["value"] == 0.0


@pytest.mark.parametrize("name", ["cylinder.one_seed", "ae_cylinder.one_seed"])
def test_a_traced_run_reads_the_per_layer_metrics_it_finds(name):
    out = tiny_run(name, trace=True)
    assert out["correct"] is True
    # no device on the CPU: only the host-clock readings are there
    assert set(out["metrics"]) == {"step.mfu", "setup.pod_s"}
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def _unchanged(real):
    def chunk(state, batch, num_steps, spec, cfg, *hypers):
        _, mets = real(state, batch, num_steps, spec, cfg, *hypers)
        return state, mets

    return chunk


def _half_rows(real):
    """The first half of the rows: of X, of the POD modes or X's column sums,
    and of the masks where the state has them (the AE's MLP every row
    shares)."""

    def chunk(state, batch, num_steps, spec, cfg, *hypers):
        h = batch["x"].shape[0] // 2
        part = {"x": batch["x"][:h].contiguous()}
        part["x_sq"] = torch.sum(part["x"] * part["x"])
        if "pod_modes" in batch:
            part["pod_modes"] = batch["pod_modes"][:h].contiguous()
        else:
            part["x_colsum"] = torch.sum(part["x"], dim=0)
        rowed = [k for k in ("phi",) if k in state.params]

        def rows(tree):
            return dict(tree, **{k: tree[k][..., :h].contiguous() for k in rowed})

        half = dataclasses.replace(state, params=rows(state.params), mu=rows(state.mu), nu=rows(state.nu))
        out, mets = real(half, part, num_steps, spec, cfg, *hypers)

        def back(new, old):
            return dict(new, **{k: torch.cat([new[k], old[k][..., h:]], dim=-1) for k in rowed})

        return dataclasses.replace(out, params=back(out.params, state.params), mu=back(out.mu, state.mu),
                                   nu=back(out.nu, state.nu)), mets

    return chunk


def _later(real):
    """Sound in a launch of one epoch; on half the rows from the second epoch
    of a longer launch on."""
    half = _half_rows(real)

    def chunk(state, batch, num_steps, spec, cfg, *hypers):
        state, first = real(state, batch, 1, spec, cfg, *hypers)
        if num_steps == 1:
            return state, first
        state, rest = half(state, batch, num_steps - 1, spec, cfg, *hypers)
        return state, {k: torch.cat([first[k], rest[k]]) for k in first}

    return chunk


def _moments_dropped(real):
    """Sound in a launch of one epoch; the optimizer's moments dropped after
    the first epoch of a longer launch."""

    def chunk(state, batch, num_steps, spec, cfg, *hypers):
        state, first = real(state, batch, 1, spec, cfg, *hypers)
        if num_steps == 1:
            return state, first
        zero = {k: torch.zeros_like(v) for k, v in state.mu.items()}
        state = dataclasses.replace(state, mu=zero, nu=dict(zero))
        state, rest = real(state, batch, num_steps - 1, spec, cfg, *hypers)
        return state, {k: torch.cat([first[k], rest[k]]) for k in first}

    return chunk


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_rows, _later, _moments_dropped])
def test_a_fault_under_the_timed_path_reads_not_correct(monkeypatch, name, fault):
    module, target = PLAIN[name]
    monkeypatch.setattr(module, target, fault(getattr(module, target)))
    out = tiny_run(name)
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["compared"].values())


def _decoder_dropped(real):
    """The AE's decoder term left out of the loss (``ae_beta`` 0); its ae
    still reported."""

    def chunk(state, batch, num_steps, spec, cfg):
        return real(state, batch, num_steps, spec, dataclasses.replace(cfg, ae_beta=0.0))

    return chunk


def _reference_tf32(real):
    """The plain reference in the chunk's place, its products in TF32 (the
    control), stepping the program's own state."""
    ref = check.reference_module("ae")

    def chunk(state, batch, num_steps, spec, cfg):
        st = {"params": dict(state.params), "mu": dict(state.mu), "nu": dict(state.nu), "count": state.count,
              "lrs": state.sched.lrs.clone(), "best": float(state.sched.best), "num_bad": int(state.sched.num_bad),
              "epoch": state.epoch}
        rows = []
        for _ in range(num_steps):
            m, _, st = ref.epoch(st, batch["x"], None, dataclasses.asdict(cfg), cfg.beta, cfg.l1_lambda, True)
            rows.append(m)
        sched = optim.PlateauState(lrs=st["lrs"], best=torch.tensor(st["best"], dtype=torch.float32),
                                   num_bad=torch.tensor(st["num_bad"], dtype=torch.int32))
        mets = {k: torch.tensor([r[k] for r in rows], dtype=torch.float32) for k in ref.METRICS}
        mets["max_arg"] = torch.zeros(num_steps)
        return train.TrainState(params=st["params"], mu=st["mu"], nu=st["nu"], count=st["count"], sched=sched,
                                epoch=st["epoch"]), mets

    return chunk


@pytest.mark.parametrize("fault", [_decoder_dropped, _reference_tf32])
def test_an_ae_fault_under_the_timed_path_reads_not_correct(monkeypatch, fault):
    monkeypatch.setattr(ae_chunk, "ae_chunk_plain", fault(ae_chunk.ae_chunk_plain))
    out = tiny_run("ae_cylinder.one_seed")
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["compared"].values())


def _periods_held(real):
    """The Fourier form's periods' step dropped: each epoch runs as one
    launch, and ``period`` and ``trig_period`` leave it as they came."""

    def chunk(state, batch, num_steps, spec, cfg, betas=None, lams=None):
        rows = []
        for _ in range(num_steps):
            held = {k: state.params[k] for k in ("period", "trig_period")}
            state, m = real(state, batch, 1, spec, cfg, betas, lams)
            state = dataclasses.replace(state, params=dict(state.params, **held))
            rows.append(m)
        return state, {k: torch.cat([m[k] for m in rows]) for k in rows[0]}

    return chunk


def _top_harmonic_dropped(real):
    """B built without the series' top harmonic (its coefficients read as
    0); the series' gradients as before."""

    def forward(zc, per, tw):
        return real(torch.cat([zc[:, :-2], torch.zeros_like(zc[:, -2:])], dim=1), per, tw)

    return forward


@pytest.mark.parametrize("target,fault", [("train_chunk_plain_packed", _periods_held),
                                          ("series_forward", _top_harmonic_dropped)])
def test_a_fourier_fault_under_the_timed_path_reads_not_correct(monkeypatch, target, fault):
    monkeypatch.setattr(tc, target, fault(getattr(tc, target)))
    out = tiny_run("fourier_cylinder.one_seed")
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["compared"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_and_the_faults_in_the_programs_place_read_not_correct(name):
    """The reference in TF32 (the control), trained on half the rows (from
    the first epoch, or from a launch's second), with its moments dropped
    after a launch's first epoch, or returning its state unchanged, in the
    program's place, fails the cell's limits; at a Fourier cell also with
    its periods held and with the top harmonic left out of B; at the AE
    cell also with the decoder's term left out."""
    cell = tiny_cell(name)
    _, window, _ = control.program_numbers(cell, 5, "cpu")
    for side in control.sides(cell.config["run_config"]):
        numbers = control.side_numbers(cell, 5, side, "cpu", window)
        numbers.pop("leaves")
        limits = {k: v for k, v in cell.limits.items() if k in numbers}
        ok, _ = harness.check.judge(numbers, limits)
        assert not ok, (side, numbers)


def test_timeline_readers():
    """A window of 1 s with two mega-kernel launches, a copy between them and
    the host in ``log`` (two calls, one burst) and ``chunk``, its spans on
    the host clock 100 s ahead of the trace's."""
    us = 1e6

    def ev(cat, name, t0, t1):
        return {"ph": "X", "cat": cat, "name": name, "ts": t0 * us, "dur": (t1 - t0) * us}

    events = [
        ev("user_annotation", "perfbench.window", 0.0, 1.0),
        ev("kernel", "void train_chunk_kernel<48, false>(Params)", 0.1, 0.4),
        ev("gpu_memcpy", "Memcpy DtoH", 0.4, 0.41),
        ev("kernel", "void train_chunk_kernel<48, false>(Params)", 0.45, 0.8),
        ev("cpu_op", "aten::stack", 0.0, 0.01),
    ]
    host = HostSpans()
    host.items += [("fit", 100.0, 101.0, 1), ("chunk", 100.05, 100.1, 1), ("log", 100.41, 100.42, 1),
                   ("log", 100.42002, 100.44, 1), ("checkpoint_fn", 100.81, 100.9, 2)]
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"timeline_{os.getpid()}.json")
    with open(path, "w") as fh:
        json.dump({"traceEvents": events}, fh)
    try:
        tl = Timeline.load(path, host, anchor=100.0)
    finally:
        os.unlink(path)
    lo, hi = tl.window_span
    assert (lo, hi) == (0.0, 1.0)
    assert [s[2] for s in tl.spans].count("log") == 1
    assert tl.busy(lo, hi) == pytest.approx(0.66)
    run = harness.Run(setup_s=1.0, window_s=1.0, seed_epochs=4000, seeds=1, least_epoch_s=1e-6,
                      setup_spans={"pod": 0.5}, kernel="train_chunk_kernel", timeline=tl, trace_window=(lo, hi))
    assert harness.reader("fit.boundary_ms")(run) == pytest.approx(40.0)
    assert harness.reader("device.idle_pct")(run) == pytest.approx(34.0)
    assert harness.reader("megakernel_roofline")(run) == pytest.approx(100 * 4000e-6 / 0.65)
    assert harness.reader("step.mfu")(run) == pytest.approx(100 * 4000e-6)
    assert harness.reader("setup.pod_s")(run) == 0.5
    assert harness.reader("train_steps_per_s")(run) == 4000.0
    br = tl.breakdown(lo, hi)
    assert br["device_ops"][0] == ["void train_chunk_kernel<48, false>(Params)", pytest.approx(0.65)]
    assert br["idle_gaps"][0] == ["checkpoint_fn", pytest.approx(0.2)]
    assert br["idle_gaps"][1] == ["chunk", pytest.approx(0.1)]
    assert br["idle_gaps"][2] == ["log", pytest.approx(0.04)]
    assert tl.idle_by_host(lo, hi) == pytest.approx({"checkpoint_fn": 0.2, "chunk": 0.1, "log": 0.04})
    # no kernel clock
    assert harness.reader("ae_kernel.rows_pct")(run) is None


def test_the_ae_kernel_readers():
    """Two AE launches of 0.3 s in a window of 1 s, and the kernel clock of
    the phase_split launch: the boundary and the roofline share by the AE
    kernel's name, its row phases' share, and None from the readers of the
    mega-kernel's launch calls and clock."""
    kernel = "void (anonymous namespace)::ae_chunk_kernel(Args)"
    tl = Timeline(device=[(0.1, 0.4, kernel), (0.45, 0.75, kernel), (0.8, 0.85, "train_chunk_kernel")], spans=[],
                  window_span=(0.0, 1.0))
    phases = {"prologue": 1.0, "rows.forward": 20.0, "rows.decoder": 30.0, "finalize": 49.0}
    run = harness.Run(setup_s=1.0, window_s=1.0, seed_epochs=400, seeds=1, least_epoch_s=1e-4, setup_spans={},
                      kernel="ae_chunk_kernel", timeline=tl, trace_window=(0.0, 1.0), phases=phases)
    assert harness.reader("fit.boundary_ms")(run) == pytest.approx(50.0)
    assert harness.reader("megakernel_roofline")(run) == pytest.approx(100 * 400e-4 / 0.6)
    for name in ("fit.boundary_launch_ms", "fit.boundary_fetch_ms", "fit.boundary_log_ms",
                 "fit.boundary_checkpoint_ms", "megakernel.contract_pct", "megakernel.series_pct"):
        assert harness.reader(name)(run) is None, name
    assert harness.reader("ae_kernel.rows_pct")(run) == pytest.approx(50.0)
    assert harness.reader("ae_kernel.rows_pct")(dataclasses.replace(run, phases={"finalize": 1.0})) is None


def _run_py(cwd, *args):
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=str(cwd), capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_exits_nonzero_without_a_result():
    out = _run_py(ROOT, "--workload", "cylinder.one_seed", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and '"correct"' not in out.stdout
    assert "needs 1 CUDA card" in out.stderr


def test_a_bare_directory_exits_nonzero_without_a_result(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys, time; sys.path.insert(0, '.'); from perfbench import harness; "
            "cell = harness.find_cell(harness.load_benchmark(), 'cylinder.one_seed'); "
            "harness.run(cell, 1, 0.5, False, 'cpu', time.perf_counter())")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and "desmo_tpu_torch" in out.stderr and '"correct"' not in out.stdout


_BLOCK = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "desmo_tpu"):
            raise ModuleNotFoundError(f"blocked in this process: {name}")
        return None
sys.meta_path.insert(0, _NoJax())
"""


def test_nothing_the_harness_runs_imports_jax(tmp_path):
    """Every module of the harness, every metric's reader and a whole tiny
    run of a desmo, a Fourier and an AE cell, in a process whose import system
    refuses jax, jaxlib, flax and the JAX package by whole top-level name (so
    that desmo_tpu_torch passes)."""
    code = _BLOCK + f"""
import importlib, time
from pathlib import Path
sys.path.insert(0, {str(ROOT)!r})
for name in ("perfbench.run", "perfbench.harness", "perfbench.check", "perfbench.control", "perfbench.roofline",
             "perfbench.timeline", "perfbench.synthetic", "perfbench.program_spans", "perfbench.reference.desmo",
             "perfbench.reference.fourier", "perfbench.reference.ae"):
    importlib.import_module(name)
from perfbench import harness
bench = harness.load_benchmark()
bench.update({{k: bench[k] + v for k, v in {AE_ENTRIES!r}.items()}})
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.reader(m["name"])
roots = {{k: Path(v) for k, v in {({k: str(v) for k, v in ROOTS.items()})!r}.items()}}
for name in ("cylinder.one_seed", "fourier_cylinder.one_seed", "ae_cylinder.one_seed"):
    cell = harness.find_cell(bench, name, roots.get(name, harness.ROOT))
    cell.config["run_config"].update({TINY!r})
    cell.traffic.update({TINY_TRAFFIC!r})
    out = harness.run(cell, 3, 2.0, False, "cpu", time.perf_counter())
    assert out["correct"], out
assert harness.forbidden_modules() == [], harness.forbidden_modules()
sys.modules["jaxlib_extra"] = sys
assert harness.forbidden_modules() == []
sys.modules["jax.numpy"] = sys
assert harness.forbidden_modules() == ["jax"]
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.gpu
def test_a_short_run_on_the_card_reads_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "cylinder.one_seed", "--seed", "5",
                          "--seconds", "3", "--trace", "1"], cwd=str(ROOT), capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert {"fit.boundary_ms", "device.idle_pct", "megakernel_roofline", "step.mfu"} <= set(result["metrics"])
