"""One run of one cell: set-up, the measured window, the readings, and the
comparison that decides ``correct``.

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json``, its configuration's file (``configs/<name>.json``: the
program's ``RunConfig`` as it is run; the name of its plain reference under
``reference/``, a module with the interface ``reference/desmo.py``'s
docstring states: the state's leaves ``LEAVES``, which the harness reads
back from the program's states, checkpoints and exports, the terms of the
loss ``METRICS``, whether the batch carries the POD modes, the ``.pt`` keys,
and the reference's functions, which take the configuration's whole
``run_config``; and ``kernel``, the program's chunk kernel: its ``name`` in
the device trace and the ``module`` whose ``phase_split`` reads its clock),
its traffic mix (``traffic/<name>.json``: the packed seeds, a job's epochs,
the log and checkpoint cadence), the limits of its
compared numbers (``limits/<cell>.json``) and one reader per metric
(``metrics/<metric>.py``, a function ``read(run)`` that returns the number,
or None where it finds nothing to read).

A run, for a cell of S packed seeds:

1. Set-up: X from the seed (``synthetic.wake``) at the configuration's
   (n, m); the POD (``runner.compute_pod``), the batch
   (``runner.prepare_batch``, with the POD modes or, where the reference's
   latents do not come from them, X's column sums) and the model
   (``runner.build_model``); the chunk the window's fit launches
   (``kernels.train_chunk.select_chunk``, or for S > 1
   ``select_ensemble_chunk``, which ``ensemble.fit`` calls with
   the same arguments) and the initial state; the first three epochs from
   that state, one launch each, kept for the comparison (the chunk returns
   new states, so the initial state is left as it was); one checkpoint
   written and removed.
2. The window: jobs of the traffic's epochs, one after another, each from
   the initial state at epoch 0, through ``train.fit`` (one seed) or
   ``ensemble.fit`` (S seeds, which builds the same initial state itself),
   with the arguments ``runner.run`` gives them: the chunk, the cadence, a
   ``checkpoint_fn`` that writes what ``runner.run``'s export writes under
   ``TMPDIR``, and a ``log`` that appends each line to a file there. At
   ``seconds`` a timer calls ``train.request_preemption``: the fit stops at
   its next chunk boundary with its final checkpoint, and the window ends
   when it returns. With ``trace`` the window runs under ``torch.profiler``
   with the benchmark's spans around each fit, chunk call, ``checkpoint_fn``
   and ``log`` call, and after the window one launch of ``PHASE_EPOCHS``
   epochs reads the kernel's clock (``phase_split``).
3. The comparison (``check.compare``), after the program's state is freed.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from perfbench import check, roofline, synthetic
from perfbench.timeline import WINDOW, HostSpans, Timeline

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "desmo_tpu")
FIRST_STEPS = 3
PHASE_EPOCHS = 200


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json's entries this cell reports
    per_layer: list


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    setup_s: float
    window_s: float  # host clock, first call to the last return
    seed_epochs: int
    seeds: int
    least_epoch_s: float  # roofline.least_epoch_s of one epoch of the packed seeds
    setup_spans: dict  # seconds of set-up steps by name
    kernel: str  # the chunk kernel's name in the device trace
    timeline: Optional[Timeline] = None
    trace_window: Optional[tuple] = None
    phases: Optional[dict] = None  # seconds by part of the traced run's phase_split launch


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with its files, found by name."""
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(
        name=name, chips=int(w["chips"]), config=_json(root / conf["file"]),
        traffic=_json(root / BENCH_DIR.name / "traffic" / f"{w['traffic']}.json"),
        limits=_json(root / BENCH_DIR.name / "limits" / f"{name}.json"), end_to_end=e2e, per_layer=per_layer,
    )


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / BENCH_DIR.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """The modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not available ({exc})"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_config(cell: Cell, seed: int):
    """The program's ``RunConfig`` of the cell: the configuration's file,
    with the traffic's seeds, job length and cadence, and the run's seed."""
    from desmo_tpu_torch import configs

    rc = {k: tuple(v) if isinstance(v, list) else v for k, v in cell.config["run_config"].items()}
    t = cell.traffic
    return dataclasses.replace(
        configs.RunConfig(**rc), seed=seed, n_seeds=int(t["seeds"]), num_epochs=int(t["job_epochs"]),
        log_every=int(t["log_every"]), checkpoint_every=int(t["checkpoint_every"]),
    )


def host_states(state, seeds: int, stacked: bool, leaves) -> list:
    """The program's ``TrainState`` as reference-format states on the host,
    one per seed, of the reference's ``leaves``."""
    out = []
    for s in range(seeds):
        def pick(t):
            return t[s] if stacked else t

        def tree(d):
            return {k: pick(d[k]).detach().to("cpu", copy=True) for k in leaves}

        sched = state.sched
        out.append({
            "params": tree(state.params), "mu": tree(state.mu), "nu": tree(state.nu), "count": int(state.count),
            "lrs": pick(sched.lrs).detach().to("cpu", copy=True), "best": float(pick(sched.best)),
            "num_bad": int(pick(sched.num_bad)), "epoch": int(state.epoch),
        })
    return out


def seed_metrics(mets: dict, seeds: int, keys, row: int = 0) -> list:
    """One epoch's metrics per seed from a chunk's metrics, those named by
    ``keys`` (the reference's ``METRICS``)."""
    v = {k: t.detach().to("cpu", torch.float64).numpy() for k, t in mets.items()}
    if "total_s" in v:
        return [{"rec": v["rec"][row, s], "ortho": v["ortho"][row, s], "l1": v["l1"][row, s],
                 "total": v["total_s"][row, s]} for s in range(seeds)]
    return [{k: v[k][row] for k in keys}]


def flat_state(state, leaves) -> dict:
    """The ``leaves`` of a one-model ``TrainState`` by the keys
    ``save_state`` writes, as arrays."""
    def arr(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    out = {f"params/{k}": arr(state.params[k]) for k in leaves}
    out.update({f"opt/mu/{k}": arr(state.mu[k]) for k in leaves})
    out.update({f"opt/nu/{k}": arr(state.nu[k]) for k in leaves})
    out.update({"sched/lrs": arr(state.sched.lrs), "sched/best": arr(state.sched.best),
                "sched/num_bad": arr(state.sched.num_bad), "opt/count": np.asarray(state.count),
                "epoch": np.asarray(state.epoch)})
    return out


def pt_params(path: str, ref) -> dict:
    """The parameters of an exported ``.pt``, read by the reference module
    ``ref``'s key scheme (``ref.pt_params``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {f"pt/params/{k}": v for k, v in ref.pt_params(sd).items()}


def npz_state(path: str) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@dataclasses.dataclass
class Setup:
    """What set-up built: the program's objects for the window, and the
    first epochs for the comparison."""

    cfg: object  # the program's RunConfig
    dev: torch.device
    x: torch.Tensor  # the benchmark's input, on the device
    modes: torch.Tensor  # the program's POD modes
    batch: dict
    spec: object
    params: dict
    loss_fn: object
    groups: dict
    chunk: object  # the chunk the window's fit launches
    state: object  # the initial state, which every job of the window starts from
    states: list  # [s0, s1, s2, s3], each a list of per-seed host states
    mets: list  # [m1, m2, m3], each a list of per-seed metrics
    spans: dict  # seconds of set-up steps by name
    ref: object  # the reference module


def set_up(cell: Cell, seed: int, device: str) -> Setup:
    """Set-up of a run of ``cell`` on ``device`` (step 1 of the module's
    docstring), up to the checkpoint's warm-up."""
    from desmo_tpu_torch import ensemble, runner, train
    from desmo_tpu_torch import device as device_mod
    from desmo_tpu_torch.kernels import train_chunk as tc

    spans: dict = {}
    t = time.perf_counter()

    def mark(name: str) -> None:
        nonlocal t
        _sync(dev)
        now = time.perf_counter()
        spans[name] = now - t
        t = now

    dev = device_mod.resolve(device)
    cfg = run_config(cell, seed)
    ref = check.reference_module(cell.config["reference"])
    leaves = ref.LEAVES
    S = cfg.n_seeds
    torch.empty(1, device=dev)
    mark("device")
    x = synthetic.wake(cfg.n, cfg.m, seed, dev)
    x_host = x.cpu().numpy()
    if dev.type == "cuda":
        # the peak is the program's: the float64 build of X is the benchmark's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    mark("x")
    pod, _ = runner.compute_pod(cfg, x_host, dev)
    mark("pod")
    batch = runner.prepare_batch(x_host, pod.modes if ref.LATENT_FROM_POD else None, dev)
    spec, params, loss_fn, groups = runner.build_model(cfg, dev)
    mark("model")
    if S == 1:
        chunk = tc.select_chunk(spec, cfg, dev)
        state = train.init_state(params, cfg)
    else:
        chunk = tc.select_ensemble_chunk(spec, cfg, S, dev)
        state = ensemble.init_state(
            ensemble.init_params(spec, S, seed=seed, phi_sigma=cfg.seed_phi_sigma,
                                 omega_spread=cfg.seed_omega_spread, device=dev), cfg, S)
    if chunk is None:
        raise RuntimeError(f"no mega-kernel chunk for cell {cell.name} on {dev}: chunk_method={cfg.chunk_method!r}")
    init = state
    states, mets = [host_states(state, S, S > 1, leaves)], []
    for _ in range(FIRST_STEPS):
        state, m = chunk(state, batch, 1)
        mets.append(seed_metrics(m, S, ref.METRICS))
        states.append(host_states(state, S, S > 1, leaves))
    mark("first_epochs")
    return Setup(cfg, dev, x, pod.modes, batch, spec, params, loss_fn, groups, chunk, init, states, mets, spans, ref)


def observed(su: Setup) -> check.Observed:
    """The first epochs of ``su`` for the comparison."""
    S = su.cfg.n_seeds
    return check.Observed(
        x=su.x, modes=su.modes.detach().clone(),
        states=[[st[s] for st in su.states] for s in range(S)],
        metrics=[[m[s] for m in su.mets] for s in range(S)],
    )


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float, err=sys.stderr) -> dict:
    """One run of ``cell``; returns the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``,
    ``compared``)."""
    from desmo_tpu_torch import checkpoint, ensemble, runner, train

    work_dir = tempfile.mkdtemp(prefix="perfbench-")
    try:
        su = set_up(cell, seed, device)
        cfg, dev, batch, spec, chunk = su.cfg, su.dev, su.batch, su.spec, su.chunk
        params, loss_fn, groups = su.params, su.loss_fn, su.groups
        S = cfg.n_seeds
        start, spans, ref = su.state, su.spans, su.ref
        leaves = ref.LEAVES
        written: list = []
        # block-buffered, as the runner's output redirected to a file
        log_file = open(os.path.join(work_dir, "run.log"), "w")

        def log(line: str) -> None:
            print(line, file=log_file)

        def export(st, epoch: int) -> None:
            tag = f"epoch{epoch}"
            checkpoint.save_state(os.path.join(work_dir, f"state_{tag}.npz"), st)
            checkpoint.save_pt(os.path.join(work_dir, f"{cfg.name}_r{cfg.r}_{tag}.pt"),
                               checkpoint.state_dict_from_params(st.params, cfg.variant))
            written.append(epoch)

        if S == 1:
            snap, event = train.host_snapshot(start)
            if event is not None:
                event.synchronize()
            export(snap, 0)
        else:
            export(ensemble.seed_state(start, cfg, 0), 0)
        for name in os.listdir(work_dir):
            if name.endswith((".npz", ".pt")):
                os.unlink(os.path.join(work_dir, name))
        _sync(dev)
        setup_s = time.perf_counter() - t_start
        print("set-up, s: " + json.dumps(dict(spans, all=setup_s)), file=err)

        # ---- the window
        method = runner.resolve_loss_method(cfg, dev)
        host = HostSpans()
        fit_chunk = host.wrap("chunk", chunk) if trace else chunk
        fit_log = host.wrap("log", log) if trace else log
        fit_export = host.wrap("checkpoint_fn", export) if trace else export
        fit_span = host.span if trace else (lambda name: nullcontext())
        jobs = []
        seed_epochs = 0
        timer = threading.Timer(seconds, train.request_preemption)
        profiler = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                           + ([torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else []))
                    if trace else nullcontext())
        with profiler:
            t0 = time.perf_counter()
            with torch.profiler.record_function(WINDOW) if trace else nullcontext():
                timer.start()
                while True:
                    written = []
                    with fit_span("fit"):
                        if S == 1:
                            res = train.fit(loss_fn, groups, cfg, params, batch, num_epochs=cfg.num_epochs,
                                            log=fit_log, checkpoint_fn=fit_export, state=start, chunk=fit_chunk)
                            best = 0
                        else:
                            res, best, _ = ensemble.fit(
                                cfg, spec, batch, n_seeds=S, num_epochs=cfg.num_epochs, seed=seed,
                                phi_sigma=cfg.seed_phi_sigma, omega_spread=cfg.seed_omega_spread, method=method,
                                log=fit_log, checkpoint_fn=fit_export)
                    ran = len(res.history["rec"]) if res.history else 0
                    jobs.append((res, best, list(written)))
                    seed_epochs += ran * S
                    if res.preempted or time.perf_counter() - t0 >= seconds:
                        break
                _sync(dev)
                t1 = time.perf_counter()
        timer.cancel()
        train.clear_preemption()
        log_file.close()
        window_s = t1 - t0
        peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

        timeline = trace_window = phases = None
        if trace:
            path = os.path.join(work_dir, "trace.json")
            profiler.export_chrome_trace(path)
            timeline = Timeline.load(path, host, t0)
            trace_window = timeline.window_span
            os.unlink(path)
            print("device idle, s, by what the host was doing: "
                  + json.dumps(timeline.idle_by_host(*trace_window)), file=err)
            if dev.type == "cuda":
                kernel = importlib.import_module(cell.config["kernel"]["module"])
                phases = kernel.phase_split(start, batch, PHASE_EPOCHS, spec, cfg)
                print("kernel clock, us an epoch over a launch of "
                      f"{PHASE_EPOCHS} epochs: " + json.dumps({k: v * 1e6 / PHASE_EPOCHS for k, v in phases.items()}),
                      file=err)

        # ---- what the window left, then the program's state freed
        obs = observed(su)
        last = [j for j in jobs if len(j[2]) >= 1][-1]
        res, best, ckpts = last
        final = npz_state(os.path.join(work_dir, f"state_epoch{ckpts[-1]}.npz"))
        final.update(pt_params(os.path.join(work_dir, f"{cfg.name}_r{cfg.r}_epoch{ckpts[-1]}.pt"), ref))
        returned = flat_state(res.state, leaves)
        returned.update({f"pt/{k}": v for k, v in returned.items() if k.startswith("params/")})
        obs.checkpoint = (final, returned)
        # the window's first launch: its first epochs, of the seed the fit
        # reports, from the initial state
        res0, best0, ck0 = jobs[0]
        launch = [{key: float(res0.history[key][k]) for key in ref.METRICS} for k in range(FIRST_STEPS)]
        obs.launch.append((best0, launch))
        b = cfg.checkpoint_every
        if S == 1 and b in ck0 and len(res0.history["rec"]) > b:
            # the first job's first checkpoint (every job starts from the
            # same state, so a later job rewrote the same file), against the
            # metrics the job recorded for the epoch that starts there
            saved = npz_state(os.path.join(work_dir, f"state_epoch{b}.npz"))
            obs.window.append((
                {leaf: torch.as_tensor(saved[f"params/{leaf}"]) for leaf in leaves},
                {key: float(res0.history[key][b]) for key in ref.METRICS},
            ))
        del jobs, res, start, batch, chunk, fit_chunk, params, su
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        hypers = [(cfg.beta, cfg.l1_lambda)] * S
        numbers = check.compare(obs, cell.config["run_config"], hypers, cell.config["reference"], seed)
        correct, compared = check.judge(numbers, cell.limits)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    least = roofline.config_least_epoch_s(cell.config["run_config"], S, cfg.checkpoint_every)
    reading = Run(setup_s=setup_s, window_s=window_s, seed_epochs=seed_epochs, seeds=S, least_epoch_s=least,
                  setup_spans=spans, kernel=cell.config["kernel"]["name"], timeline=timeline,
                  trace_window=trace_window, phases=phases)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for entry in entries:
        value = reader(entry["name"])(reading)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    out = {"correct": correct, "attempted": seed_epochs, "failed": 0, "metrics": metrics, "device": device_info}
    if trace:
        lo, hi = trace_window
        device_info["busy_s"] = timeline.busy(lo, hi)
        device_info["window_s"] = hi - lo
        out["breakdown"] = timeline.breakdown(lo, hi)
    out["compared"] = compared
    if not all(math.isfinite(v["value"]) for v in metrics.values()):
        raise FloatingPointError(f"a metric is not finite: {metrics}")
    return out
