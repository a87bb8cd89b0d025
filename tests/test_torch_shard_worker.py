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
and ``runner_seeds`` (``runner.run`` of the small cylinder with two seeds).
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
        else:
            raise SystemExit(f"unknown task {task!r}")
    if any(name.split(".")[0] in ("jax", "jaxlib", "desmo_tpu") for name in sys.modules):
        raise SystemExit("the worker imported jax or desmo_tpu")
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
