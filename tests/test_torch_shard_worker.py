"""One rank of a CPU (gloo) run of the port's sharded chunk; a script, with
no tests of its own.

Started by ``tests/test_torch_shard_step.py``, one process per rank, with
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set as
``torchrun`` sets them; imports nothing of jax. It reads the problems from
an ``.npz`` the test wrote (data, POD modes, the JAX package's initial
parameters and the configs as JSON) and writes what each task produced, as
seen from its rank, to ``<out_dir>/rank<k>.npz``.

Usage: python test_torch_shard_worker.py <in.npz> <out_dir> <task>[,<task>...]

Tasks: ``desmo`` and ``fourier`` (25 steps from the problem's state),
``resume`` (10 + 10 steps and 20 steps of the desmo problem), ``ortho`` (one
step of the problem built so that the ranks' latent Grams have signs other
than the summed one), ``runner`` (``runner.run`` of a small cylinder with
the mesh), ``ensemble`` (the sharded packed chunk of each seed-packed
problem ``ens_<case>`` from its stacked initial parameters and hyperparameters)
``runner_seeds`` (``runner.run`` of the small cylinder with two seeds),
``runner_resume`` (``runner.run`` of the small cylinder for its 20 epochs,
and for 10 then resumed from ``state_epoch10.npz`` for 10 more) and
``preempt`` (``train.fit`` of the desmo problem's sharded chunk, 3 chunks of
10 steps, with a preemption requested on rank 1 alone after the first
chunk; then resumed from the checkpoint it wrote, against 30 steps
straight) and ``multistart`` (``runner.run`` of the Fourier problem
``multistart/cfg`` on ``multistart/x`` with its holdout
``multistart/holdout``: the period multi-start's probes and the holdout
fit through the sharded chunk, with the multi-start's log lines; started by
``tests/test_torch_forecast.py``).
"""

import json
import os
import sys

import numpy as np
import torch

from desmo_tpu_torch import checkpoint, configs, ensemble, parallel, runner, train
from desmo_tpu_torch.kernels import shard_step
from desmo_tpu_torch.models import desmo, fourier


def spec_of(cfg):
    if cfg.variant == "fourier":
        return fourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier,
                                   cfg.period_init)
    return desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)


def run_ensemble_chunk(inp, key, mesh):
    """The seed-packed problem ``key``'s state after one sharded packed
    chunk of its steps, and its metrics."""
    cfg = configs.RunConfig(**json.loads(str(inp[f"{key}/cfg"])))
    x = torch.as_tensor(inp[f"{key}/x"])
    batch = {"x": x, "x_sq": torch.sum(x * x), "pod_modes": torch.as_tensor(inp[f"{key}/modes"])}
    names = [k.split("/", 2)[2] for k in inp.files if k.startswith(f"{key}/params/")]
    params = checkpoint.params_from_jax({k: inp[f"{key}/params/{k}"] for k in names}, "cpu")
    hyp = {k: inp[f"{key}/{k}"] for k in ("betas", "lams", "lr_scales") if f"{key}/{k}" in inp.files}
    S = params["phi"].shape[0]
    state = parallel.local_state(ensemble.init_state(params, cfg, S, lr_scales=hyp.get("lr_scales")), mesh)
    chunk = shard_step.make_sharded_fused_ensemble_chunk(spec_of(cfg), cfg, mesh, S, betas=hyp.get("betas"),
                                                         lams=hyp.get("lams"))
    return chunk(state, parallel.shard_batch(batch, mesh), int(inp[f"{key}/steps"]))


def run_chunks(inp, key, mesh, chunks):
    """The problem ``key``'s state after ``chunks`` sharded chunks, and their metrics."""
    cfg = configs.RunConfig(**json.loads(str(inp[f"{key}/cfg"])))
    spec = spec_of(cfg)
    x = torch.as_tensor(inp[f"{key}/x"])
    batch = {"x": x, "x_sq": torch.sum(x * x), "pod_modes": torch.as_tensor(inp[f"{key}/modes"])}
    names = [k.split("/", 2)[2] for k in inp.files if k.startswith(f"{key}/params/")]
    params = checkpoint.params_from_jax({k: inp[f"{key}/params/{k}"] for k in names}, "cpu")
    state = parallel.local_state(train.init_state(params, cfg), mesh)
    chunk = shard_step.make_sharded_fused_chunk(spec, cfg, mesh)
    local = parallel.shard_batch(batch, mesh)
    mets = []
    for steps in chunks:
        state, m = chunk(state, local, steps)
        mets.append(m)
    return state, {k: torch.cat([m[k] for m in mets]) for k in mets[0]}


def fit_desmo(inp, mesh, out_dir, num_epochs, state=None, preempt_on_rank=None):
    """``train.fit`` of the desmo problem over ``mesh`` in chunks of 10
    steps, its checkpoints (gathered, rank 0's) in ``<out_dir>/fit``; with
    ``preempt_on_rank`` that rank alone requests preemption after its first
    chunk."""
    cfg = configs.RunConfig(**{**json.loads(str(inp["desmo/cfg"])), "checkpoint_every": 10})
    x = torch.as_tensor(inp["desmo/x"])
    batch = {"x": x, "x_sq": torch.sum(x * x), "pod_modes": torch.as_tensor(inp["desmo/modes"])}
    names = [k.split("/", 2)[2] for k in inp.files if k.startswith("desmo/params/")]
    params = checkpoint.params_from_jax({k: inp[f"desmo/params/{k}"] for k in names}, "cpu")
    chunk = shard_step.make_sharded_fused_chunk(spec_of(cfg), cfg, mesh)
    calls = []

    def counted(state, batch, num_steps):
        calls.append(num_steps)
        if mesh.rank == preempt_on_rank and len(calls) == 1:
            train.request_preemption()
        return chunk(state, batch, num_steps)

    os.makedirs(os.path.join(out_dir, "fit"), exist_ok=True)

    def save(state, epoch):
        if mesh.rank == 0:
            checkpoint.save_state(os.path.join(out_dir, "fit", f"state_epoch{epoch}.npz"), state)

    start = parallel.local_state(state or train.init_state(params, cfg), mesh)
    result = train.fit(None, {}, cfg, params, parallel.shard_batch(batch, mesh), num_epochs=num_epochs,
                       chunk_size=10, log=None, checkpoint_fn=save, state=start, chunk=counted, device_mesh=mesh)
    result.state = parallel.gather_state(result.state, mesh, cfg.n)
    return result, cfg, params


def main() -> int:
    src, out_dir, tasks = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
    mesh = parallel.make_mesh(int(os.environ["WORLD_SIZE"]), device="cpu")
    inp = np.load(src)
    out = {}

    def keep(prefix, state, mets):
        for k, v in state.params.items():
            out[f"{prefix}/params/{k}"] = v.numpy()
        out[f"{prefix}/mu/phi"] = state.mu["phi"].numpy()
        out[f"{prefix}/nu/phi"] = state.nu["phi"].numpy()
        out[f"{prefix}/lrs"] = state.sched.lrs.numpy()
        out[f"{prefix}/count_epoch"] = np.array([state.count, state.epoch])
        for k, v in mets.items():
            out[f"{prefix}/metrics/{k}"] = v.numpy()

    for task in tasks:
        if task in ("desmo", "fourier"):
            keep(task, *run_chunks(inp, task, mesh, [25]))
        elif task == "resume":
            keep("split", *run_chunks(inp, "desmo", mesh, [10, 10]))
            keep("whole", *run_chunks(inp, "desmo", mesh, [20]))
        elif task == "ortho":
            keep("ortho", *run_chunks(inp, "ortho", mesh, [1]))
        elif task == "runner":
            cfg = configs.RunConfig(**json.loads(str(inp["runner/cfg"])))
            art = runner.run(cfg, inp["runner/x"], out_dir=os.path.join(out_dir, "runs"), echo=False,
                             device="cpu", device_mesh=mesh)
            for k, v in art.history.items():
                out[f"runner/history/{k}"] = v
            for k, v in art.state.params.items():
                out[f"runner/params/{k}"] = v.numpy()
            out["runner/relative_error"] = np.array(art.relative_error)
        elif task == "ensemble":
            for key in sorted({k.split("/")[0] for k in inp.files if k.startswith("ens_")}):
                keep(key, *run_ensemble_chunk(inp, key, mesh))
        elif task == "runner_seeds":
            cfg = configs.RunConfig(**{**json.loads(str(inp["runner/cfg"])), "n_seeds": 2})
            art = runner.run(cfg, inp["runner/x"], out_dir=os.path.join(out_dir, "runs_seeds"), echo=False,
                             device="cpu", device_mesh=mesh)
            for k, v in art.history.items():
                out[f"runner_seeds/history/{k}"] = v
            out["runner_seeds/params/phi"] = art.state.params["phi"].numpy()
        elif task == "runner_resume":
            cfg = configs.RunConfig(**json.loads(str(inp["runner/cfg"])))
            runs = os.path.join(out_dir, "runs_resume")
            for tag, kw in (("straight", {}), ("first", {"num_epochs": 10})):
                art = runner.run(cfg, inp["runner/x"], out_dir=os.path.join(runs, tag), echo=False, device="cpu",
                                 device_mesh=mesh, **kw)
                out[f"runner_resume/{tag}/preempted"] = np.array(art.preempted)
            art = runner.run(cfg, inp["runner/x"], out_dir=os.path.join(runs, "resumed"), num_epochs=10,
                             echo=False, device="cpu", device_mesh=mesh,
                             resume_from=os.path.join(runs, "first", cfg.name, "state_epoch10.npz"))
            keep("runner_resume/resumed", art.state, {k: torch.as_tensor(v) for k, v in art.history.items()})
        elif task == "preempt":
            preempted, cfg, params = fit_desmo(inp, mesh, out_dir, 30, preempt_on_rank=1)
            out["preempt/preempted"] = np.array(preempted.preempted)
            out["preempt/epoch"] = np.array(preempted.state.epoch)
            out["preempt/latch_after"] = np.array(train.preemption_requested())
            torch.distributed.barrier(group=mesh.group)  # rank 0's checkpoint is on disk
            saved = checkpoint.load_state(os.path.join(out_dir, "fit", "state_epoch10.npz"),
                                          train.init_state(params, cfg))
            resumed, _, _ = fit_desmo(inp, mesh, out_dir + "_resumed", 20, state=saved)
            keep("preempt/resumed", resumed.state, {k: torch.as_tensor(v) for k, v in resumed.history.items()})
            straight, _, _ = fit_desmo(inp, mesh, out_dir + "_straight", 30)
            keep("preempt/straight", straight.state, {k: torch.as_tensor(v) for k, v in straight.history.items()})
        elif task == "multistart":
            cfg = configs.RunConfig(**json.loads(str(inp["multistart/cfg"])))
            lines = []
            probe = runner.fourier_period_multistart

            def logged(*args, **kw):
                return probe(*args, **{**kw, "log": lines.append})

            runner.fourier_period_multistart = logged
            try:
                art = runner.run(cfg, inp["multistart/x"], out_dir=os.path.join(out_dir, "runs_multistart"),
                                 echo=False, device="cpu", device_mesh=mesh, holdout=float(inp["multistart/holdout"]))
            finally:
                runner.fourier_period_multistart = probe
            out["multistart/log"] = np.array(lines)
            for k, v in art.history.items():
                out[f"multistart/history/{k}"] = v
            for k, v in art.state.params.items():
                out[f"multistart/params/{k}"] = v.numpy()
            out["multistart/epoch"] = np.array(art.state.epoch)
            out["multistart/relative_error"] = np.array(art.relative_error)
            out["multistart/holdout_error"] = np.array(
                np.nan if art.forecast is None else art.forecast["holdout_error"])
        else:
            raise SystemExit(f"unknown task {task!r}")
    if any(name.split(".")[0] in ("jax", "jaxlib", "desmo_tpu") for name in sys.modules):
        raise SystemExit("the worker imported jax or desmo_tpu")
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
