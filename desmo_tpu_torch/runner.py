"""End-to-end pipeline: load -> preprocess -> POD -> train -> error ->
sparsify -> export. Port of ``desmo_tpu/runner.py`` for the desmo and Fourier
variants on one device, one seed, with no holdout and no figures.

What the port does not run yet raises ``NotImplementedError`` naming its
``ROADMAP.md`` item; nothing falls back silently.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from desmo_tpu_torch import checkpoint, configs, losses, pod, sparsify, train
from desmo_tpu_torch import data as data_mod
from desmo_tpu_torch import device as device_mod
from desmo_tpu_torch.kernels import train_chunk
from desmo_tpu_torch.logging_utils import MetricsLogger
from desmo_tpu_torch.models import desmo as desmo_model
from desmo_tpu_torch.models import fourier as fourier_model


@dataclasses.dataclass
class RunArtifacts:
    config: configs.RunConfig
    state: train.TrainState
    history: dict
    relative_error: float
    pod_error_r: float
    pod_error_2r: float
    steps_per_sec: float
    sweep: list
    out_dir: str


def load_data(
    cfg: configs.RunConfig,
    data_dir: Optional[str] = None,
    filename: str = "velocity_",
    extension: str = ".vtu",
    array: str = "velocity",
    location: str = "point",
    t_start: int = 0,
    t_end: Optional[int] = None,
    npz_path: Optional[str] = None,
    synthetic: bool = False,
    dim: Optional[int] = None,
):
    """The preprocessed snapshot matrix X (n, m) from a VTK series, an npz
    file (key 'X') or the synthetic generator; returns ``(x, mesh)``."""
    if dim is None:
        dim = cfg.dim
    if synthetic:
        from desmo_tpu_torch.io import synthetic as synth

        return synth.cylinder_wake(cfg.n, cfg.m, seed=cfg.seed), None
    mesh = None
    if npz_path is not None:
        with np.load(npz_path) as d:
            x = d["X"].astype(np.float32)
    elif data_dir is not None:
        from desmo_tpu_torch.io import native, vtk as vio

        stop = t_end if t_end is not None else t_start + cfg.m * cfg.time_stride
        x = None
        if native.available():
            try:
                x = native.read_snapshot_series_native(
                    data_dir, filename, t_start, stop,
                    extension=extension, array=array, location=location,
                )
                sep = "" if data_dir.endswith("/") else "/"
                mesh = vio.read_mesh(f"{data_dir}{sep}{filename}{t_start}{extension}")
            except RuntimeError:
                x = None  # a sub-format the native reader does not take
        if x is None:
            x, mesh = vio.read_snapshot_series(
                data_dir, filename, t_start, stop,
                extension=extension, array=array, location=location,
            )
    else:
        raise ValueError("provide data_dir, npz_path, or synthetic=True")
    x, _mean = data_mod.preprocess(
        x,
        dim=dim,
        magnitude=True,
        mean_subtract=True,
        time_stride=cfg.time_stride,
        inv_sqrt_m=cfg.scale_inv_sqrt_m,
    )
    return x, mesh


def resolve_loss_method(cfg: configs.RunConfig, device: torch.device) -> str:
    """The eager loop's loss: ``auto`` is the dual-contraction kernel on a GPU
    and the factored Gram products on the CPU, as the JAX package picks its
    Pallas kernel on a TPU only. The mega-kernel's chunk computes its own."""
    if cfg.loss_method != "auto":
        return cfg.loss_method
    return "fused" if device.type == "cuda" else "factored"


def check_supported(cfg: configs.RunConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    todo = []
    if cfg.variant not in ("desmo", "fourier"):
        todo.append(f"variant {cfg.variant!r} (ROADMAP queue 1, item 7)")
    if cfg.variant == "fourier" and cfg.period_multistart > 1:
        todo.append("the Fourier period multi-start, period_multistart > 1 (ROADMAP queue 1, item 5b)")
    if cfg.n_seeds > 1 or cfg.sweep_beta or cfg.sweep_lam or cfg.sweep_lr_scale:
        todo.append("multi-seed and hyperparameter multi-start (ROADMAP queue 1, item 6)")
    if cfg.pod_method != "host":
        todo.append(f"pod_method={cfg.pod_method!r} (ROADMAP queue 1, item 9)")
    if cfg.run_greedy_prune:
        todo.append("greedy pruning, run_greedy_prune=True (ROADMAP queue 1, item 3)")
    if todo:
        raise NotImplementedError("desmo_tpu_torch does not run " + "; ".join(todo) + " yet")


def build_model(cfg: configs.RunConfig, device: torch.device):
    """``(spec, params, loss_fn, groups)`` for the config's variant on ``device``."""
    check_supported(cfg)
    method = resolve_loss_method(cfg, device)
    if cfg.variant == "fourier":
        spec = fourier_model.FourierSpec(
            cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier, cfg.period_init
        )
        params = fourier_model.Fourier(spec, device=device).params()
        loss_fn = fourier_model.build_loss(spec, cfg.beta, cfg.l1_lambda, method=method)
    else:
        spec = desmo_model.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
        params = desmo_model.Desmo(spec, device=device).params()
        loss_fn = desmo_model.build_loss(spec, cfg.beta, cfg.l1_lambda, method=method)
    return spec, params, loss_fn, desmo_model.param_groups(params)


def compute_pod(cfg: configs.RunConfig, x: np.ndarray, device: torch.device):
    """Rank-r and rank-2r POD of X from one host SVD."""
    if cfg.pod_method != "host":
        check_supported(cfg)
    p2 = pod.pod_host(x, 2 * cfg.r, device)
    return pod.truncate(p2, cfg.r), p2


def prepare_batch(x: np.ndarray, pod_modes: torch.Tensor, device: torch.device) -> dict:
    """The training batch: fp32 X, its precomputed ``sum(X*X)`` and the POD
    modes, on ``device``. The TPU's bf16 hi/lo planes of X do not carry over:
    the CUDA kernel reads fp32 X."""
    xd = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)
    return {"x": xd, "x_sq": torch.sum(xd * xd), "pod_modes": pod_modes.contiguous()}


def run(
    cfg: configs.RunConfig,
    x: np.ndarray,
    out_dir: str = "./runs",
    num_epochs: Optional[int] = None,
    echo: bool = True,
    *,
    device: str | torch.device = "cuda",
    holdout: float = 0.0,
) -> RunArtifacts:
    """Train, report and export one preset on ``device``.

    Writes ``<out_dir>/<name>/``: the CSV/JSONL metrics, ``state_final.npz``,
    ``<name>_r<r>_final.pt`` and, every ``checkpoint_every`` epochs,
    ``state_epoch<N>.npz`` and ``<name>_r<r>_epoch<N>.pt``. The chunks run
    through the mega-kernel or the eager loop as
    ``kernels.train_chunk.select_chunk`` decides. ``ga_single_pass`` is a
    TPU shortcut of the mega-kernel's Gram and is ignored: the port's kernel
    computes the exact Gram. ``holdout`` (forecasting at held-out times) is
    not ported yet and raises when set."""
    if holdout:
        raise NotImplementedError(
            "desmo_tpu_torch does not run holdout forecasting (ROADMAP queue 1, item 5b) yet"
        )
    dev = device_mod.resolve(device)
    cfg = dataclasses.replace(cfg, n=x.shape[0], m=x.shape[1])
    check_supported(cfg)
    out_dir = os.path.join(out_dir, cfg.name)
    os.makedirs(out_dir, exist_ok=True)
    spec, params, loss_fn, groups = build_model(cfg, dev)
    p, p2 = compute_pod(cfg, x, dev)
    batch = prepare_batch(x, p.modes, dev)

    logger = MetricsLogger(out_dir, cfg.name, echo=False)

    def export(state: train.TrainState, tag: str) -> None:
        checkpoint.save_state(os.path.join(out_dir, f"state_{tag}.npz"), state)
        checkpoint.save_pt(
            os.path.join(out_dir, f"{cfg.name}_r{cfg.r}_{tag}.pt"),
            checkpoint.state_dict_from_params(state.params, cfg.variant),
        )

    n_epochs = num_epochs if num_epochs is not None else cfg.num_epochs
    result = train.fit(
        loss_fn, groups, cfg, params, batch,
        num_epochs=n_epochs,
        log=(lambda line: print(line, flush=True)) if echo else None,
        checkpoint_fn=lambda state, epoch: export(state, f"epoch{epoch}"),
        chunk=train_chunk.select_chunk(spec, cfg, dev),
    )
    for i in range(0, result.state.epoch, cfg.log_every):
        logger.log_epoch(i, n_epochs, {k: v[i] for k, v in result.history.items()})
    logger.close()

    with torch.no_grad():
        model = fourier_model if cfg.variant == "fourier" else desmo_model
        recon = model.apply(result.state.params, batch["pod_modes"], spec)[0]
        err = float(losses.relative_frobenius_error(batch["x"], recon))
        err_pod = pod.pod_relative_error(batch["x"], p)
        err_pod2 = pod.pod_relative_error(batch["x"], p2)
    if echo:
        print(f"DESMO error with {cfg.r} modes: {err}")
        print(f"POD error with {cfg.r} modes: {err_pod}")
        print(f"POD error with {2 * cfg.r} modes: {err_pod2}")

    sweep = sparsify.threshold_sweep(
        result.state.params, batch, spec, log=print if echo else None
    )
    export(result.state, "final")
    return RunArtifacts(
        config=cfg,
        state=result.state,
        history=result.history,
        relative_error=err,
        pod_error_r=err_pod,
        pod_error_2r=err_pod2,
        steps_per_sec=result.steps_per_sec,
        sweep=sweep,
        out_dir=out_dir,
    )
