"""End-to-end pipeline: load -> preprocess -> POD -> train -> error ->
sparsify -> export, and inference from a checkpoint. Port of
``desmo_tpu/runner.py`` for the desmo, Fourier and AE variants on one
device, one seed or (desmo and Fourier) a seed-packed ensemble
(``n_seeds > 1``, ``ensemble.fit``), and for desmo or Fourier, one seed or
packed seeds, with the rows sharded over a device mesh (``device_mesh``,
the sharded step kernel), with resume, graceful preemption, greedy pruning,
the Fourier period multi-start, the Fourier holdout forecast, the host or
device POD (``pod_method``) and :func:`evaluate`, and with no figures.

What the port does not run yet raises ``NotImplementedError`` naming its
``ROADMAP.md`` item; nothing falls back silently.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional

import numpy as np
import torch

from desmo_tpu_torch import checkpoint, configs, ensemble, losses, parallel, pod, sparsify, train
from desmo_tpu_torch import data as data_mod
from desmo_tpu_torch import device as device_mod
from desmo_tpu_torch.kernels import shard_step, train_chunk
from desmo_tpu_torch.logging_utils import MetricsLogger
from desmo_tpu_torch.models import autoencoder as ae_model
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
    # stopped early by a preemption request: state_final.npz and the final
    # .pt hold the state to resume from; no sweep ran
    preempted: bool = False
    greedy: list = dataclasses.field(default_factory=list)
    # the holdout forecast record (Fourier variant, run(holdout=f)): m_train,
    # m_holdout, train_error, holdout_error, the baselines and per-snapshot
    # errors; None without a holdout
    forecast: Optional[dict] = None


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
    """Raise ``NotImplementedError`` for what the port does not run yet, and
    ``ValueError`` for what the JAX package refuses too (several seeds of the
    AE variant)."""
    if cfg.variant == "ae" and cfg.n_seeds > 1:
        raise ValueError("n_seeds > 1 requires the desmo or fourier variant (ensemble.py scope)")
    if cfg.variant not in ("desmo", "fourier", "ae"):
        raise NotImplementedError(f"desmo_tpu_torch does not run variant {cfg.variant!r} yet")


def single_seed_sweep(cfg: configs.RunConfig) -> configs.RunConfig:
    """Sweep lists on a one-seed config (``desmo_tpu/runner.py:324-349``): a
    grid of more than one combo needs ``n_seeds > 1`` and raises; a single
    combo away from the config's values is an override of beta, lambda and
    the LRs."""
    if cfg.n_seeds > 1:
        return cfg
    hyp = ensemble.resolve_hypers(cfg, 1, warn=False)
    if hyp is None:
        return cfg
    if len(hyp["combos"]) > 1:
        raise ValueError(
            "a hyperparameter sweep (sweep_beta/sweep_lam/sweep_lr_scale with more than one combo) needs "
            "n_seeds > 1 — pass --seeds, or omit it and the CLI defaults n_seeds to the combo-grid size"
        )
    beta, lam, scale = hyp["combos"][0]
    return dataclasses.replace(
        cfg, beta=beta, l1_lambda=lam, lr_coef=cfg.lr_coef * scale, lr_phi=cfg.lr_phi * scale,
        lr_z=cfg.lr_z * scale, lr_omega=cfg.lr_omega * scale, lr_period=cfg.lr_period * scale,
        sweep_beta=(), sweep_lam=(), sweep_lr_scale=(),
    )


def _finite_or_none(v) -> float | None:
    return float(v) if np.isfinite(v) else None


def run_ensemble(cfg, spec, batch, n_epochs, device, out_dir, export, log, device_mesh=None) -> train.TrainResult:
    """The ``n_seeds > 1`` branch of ``desmo_tpu/runner.py:509-684``:
    ``ensemble.fit`` (over ``device_mesh`` when given), then
    ``ensemble.json`` (the winner, every seed's final total and rec, the
    diverged seeds, seed-steps/s, the jitter and the hyperparameter grid)
    and, with two or more live seeds, ``term_stability.json``, both from
    rank 0 alone; the best seed's state, phi whole, is exported at the last
    epoch. The per-seed rec figure is not drawn (figures are not
    ported)."""
    method = resolve_loss_method(cfg, device)
    if method not in ("factored", "fused"):
        if log is not None:
            log(f"[ensemble] loss_method={method!r} has no packed form; using the factored loss")
        method = "factored"
    report: dict = {}
    result, best_seed, finals = ensemble.fit(
        cfg, spec, batch, n_seeds=cfg.n_seeds, num_epochs=n_epochs, seed=cfg.seed,
        phi_sigma=cfg.seed_phi_sigma, omega_spread=cfg.seed_omega_spread, method=method, log=log,
        checkpoint_fn=lambda state, epoch: export(state, f"epoch{epoch}"), device_mesh=device_mesh, report=report,
    )
    if device_mesh is not None and device_mesh.rank != 0:
        return result  # rank 0 writes the reports and exports
    sps = result.steps_per_sec
    if log is not None:
        rate = f"; {sps:.1f} seed-steps/s" if np.isfinite(sps) else ""
        log(f"[ensemble] kept seed {best_seed}/{cfg.n_seeds} (finals: {finals}){rate}")
    hyp = report.get("hypers")
    with open(os.path.join(out_dir, "ensemble.json"), "w") as fh:
        json.dump({
            "n_seeds": int(cfg.n_seeds),
            "best_seed": int(best_seed),
            # diverged (frozen) seeds report inf: null here, with their indices
            "final_totals": [_finite_or_none(v) for v in finals],
            "final_recs": [_finite_or_none(v) for v in report.get("final_recs", [])],
            "diverged_seeds": [int(i) for i in np.nonzero(~np.isfinite(finals))[0]],
            "seed_steps_per_sec": _finite_or_none(sps),
            "seed_phi_sigma": float(cfg.seed_phi_sigma),
            "seed_omega_spread": float(cfg.seed_omega_spread),
            "hypers": None if hyp is None else {
                "combos": [list(c) for c in hyp["combos"]],
                "betas": hyp["betas"].tolist(),
                "lams": hyp["lams"].tolist(),
                "lr_scales": hyp["lr_scales"].tolist(),
                "best_combo": [float(hyp["betas"][best_seed]), float(hyp["lams"][best_seed]),
                               float(hyp["lr_scales"][best_seed])],
            },
        }, fh, indent=1)
    live_params, live_idx = report.get("seed_params", []), list(report.get("live_seeds", []))
    hyper_group = None
    if hyp is not None and live_params:
        # under a sweep the seeds' objectives differ: the stability report
        # pools only the live seeds of the winner's (beta, lambda)
        bw, lw = float(hyp["betas"][best_seed]), float(hyp["lams"][best_seed])
        keep = [k for k, i in enumerate(live_idx) if float(hyp["betas"][i]) == bw and float(hyp["lams"][i]) == lw]
        live_params, live_idx = [live_params[k] for k in keep], [live_idx[k] for k in keep]
        hyper_group = {"beta": bw, "l1_lambda": lw}
    if len(live_params) >= 2:
        stab = ensemble.term_stability(live_params, spec)
        with open(os.path.join(out_dir, "term_stability.json"), "w") as fh:
            json.dump({
                "threshold": stab["threshold"],
                "live_seeds": live_idx,
                "hyper_group": hyper_group,
                "names": stab["names"],
                "frequency": stab["frequency"].tolist(),
                "energy_mean": stab["mean"].tolist(),
                "energy_std": stab["std"].tolist(),
            }, fh, indent=1)
        if log is not None:
            grp = (f" (winning hyper group beta={hyper_group['beta']:g}, lambda={hyper_group['l1_lambda']:g})"
                   if hyper_group is not None else "")
            unstable = [(nm, f) for nm, f in zip(stab["names"], stab["frequency"]) if 0.0 < f < 1.0]
            if unstable:
                log(f"[ensemble] init-sensitive terms (selection frequency < 1 at threshold "
                    f"{stab['threshold']:g}{grp}): " + ", ".join(f"{nm}={f:.2f}" for nm, f in unstable))
            else:
                log(f"[ensemble] term selection is stable across all {len(live_idx)} seeds "
                    f"(threshold {stab['threshold']:g}{grp})")
    export(result.state, f"epoch{result.state.epoch}")
    return result


def select_sharded_chunk(spec, cfg: configs.RunConfig, mesh: parallel.SpaceMesh) -> train.ChunkFn:
    """The chunk of a run over a device mesh, the policy of
    ``desmo_tpu/runner.py:367-402``: the sharded step kernel's chunk
    (``kernels.shard_step``) for the desmo and Fourier variants under
    ``chunk_method`` 'auto' (with the loss method 'auto' or 'fused') or
    'megakernel'. 'megakernel' on a configuration the kernel does not take
    raises ``ValueError``; what the JAX package runs through its eager path
    over the mesh instead raises ``NotImplementedError``. Several seeds take
    ``ensemble.fit(device_mesh=...)`` and its policy
    (``kernels.train_chunk.select_ensemble_chunk``) instead."""
    method = cfg.chunk_method
    kernel_ok = method == "megakernel" or cfg.loss_method in ("auto", "fused")
    if method != "scan" and kernel_ok and shard_step.supports_sharded(spec, cfg):
        return shard_step.make_sharded_fused_chunk(spec, cfg, mesh)
    if method == "megakernel":
        raise ValueError(
            f"chunk_method='megakernel' but preset {cfg.name!r} has no sharded mega-kernel (variant/terms) "
            "— see kernels.shard_step.supports_sharded"
        )
    raise NotImplementedError(
        f"desmo_tpu_torch does not run the eager loop over a device mesh (variant {cfg.variant!r}, "
        f"chunk_method={method!r}, loss_method={cfg.loss_method!r}) yet "
        "(ROADMAP queue 1, item 5.2: the eager path over a mesh)"
    )


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
    elif cfg.variant == "ae":
        spec = ae_model.AESpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
        params = ae_model.init_params(spec, seed=cfg.seed, device=device)
        loss_fn = ae_model.build_loss(spec, cfg.beta, cfg.l1_lambda, cfg.ae_beta, method=method)
        return spec, params, loss_fn, ae_model.param_groups(params)
    else:
        spec = desmo_model.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
        params = desmo_model.Desmo(spec, device=device).params()
        loss_fn = desmo_model.build_loss(spec, cfg.beta, cfg.l1_lambda, method=method)
    return spec, params, loss_fn, desmo_model.param_groups(params)


def compute_pod(cfg: configs.RunConfig, x: np.ndarray, device: torch.device):
    """Rank-r and rank-2r POD of X from one factorization, under one sign
    convention shared by :func:`run` and :func:`evaluate`: 'host' (the
    default) is ``np.linalg.svd`` with the reference's signs, which imported
    checkpoints' frozen masks pair with; any other ``cfg.pod_method``
    ('snapshots', 'svd', 'randomized') runs ``pod.pod`` on ``device`` under
    ``pod.canonical_signs``, so that evaluating a checkpoint with the method
    it was trained under rebuilds the same modes."""
    if cfg.pod_method == "host":
        p2 = pod.pod_host(x, 2 * cfg.r, device)
    else:
        p2 = pod.canonical_signs(pod.pod(x, 2 * cfg.r, method=cfg.pod_method, device=device))
    return pod.truncate(p2, cfg.r), p2


def prepare_batch(x: np.ndarray, pod_modes: torch.Tensor | None, device: torch.device) -> dict:
    """The training batch: fp32 X, its precomputed ``sum(X*X)`` and the POD
    modes, on ``device``; with ``pod_modes=None`` (the AE variant, whose
    latent comes from its encoder) X's column sums ``x_colsum`` instead. The
    TPU's bf16 hi/lo planes of X do not carry over: the CUDA kernels read
    fp32 X."""
    xd = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)
    batch = {"x": xd, "x_sq": torch.sum(xd * xd)}
    if pod_modes is None:
        batch["x_colsum"] = torch.sum(xd, dim=0)
    else:
        batch["pod_modes"] = pod_modes.contiguous()
    return batch


def reconstruct(params: dict, batch: dict, spec, variant: str) -> torch.Tensor:
    """The model's reconstruction of X (n, m)."""
    if variant == "ae":
        return ae_model.apply(params, batch["x"], spec)[0]
    model = fourier_model if variant == "fourier" else desmo_model
    return model.apply(params, batch["pod_modes"], spec)[0]


def ae_recipe_cfg(cfg: configs.RunConfig) -> configs.RunConfig:
    """The AE recipe's clamps, applied after the live init
    (``desmo_tpu/runner.py:170-185``): the MLP LR capped at 1e-3 (at the
    preset's 1e-2 the encoder collapses to spatially constant latents) and
    ``ae_beta`` floored at 10, which anchors the latents against that
    collapse."""
    return dataclasses.replace(cfg, lr_z=min(cfg.lr_z, 1e-3), ae_beta=max(cfg.ae_beta, 10.0))


def ae_recipe(cfg, spec, params, groups, batch, device, log):
    """The AE convergence recipe (``desmo_tpu/runner.py:451-490``): the live
    MLP init, :func:`ae_recipe_cfg`, an AE-only warmup of
    ``cfg.ae_warmup_epochs`` through the eager loop, then omega scaled to the
    warmed latents and ``lr_omega`` to 1% of its mean sin value. Returns
    ``(cfg, params, loss_fn)`` for the main fit."""
    params = ae_model.init_params_live(spec, seed=cfg.seed, device=device)
    cfg = ae_recipe_cfg(cfg)
    loss_fn = ae_model.build_loss(spec, cfg.beta, cfg.l1_lambda, cfg.ae_beta,
                                  method=resolve_loss_method(cfg, device))
    if cfg.ae_warmup_epochs > 0:
        warm = train.fit(ae_model.build_warmup_loss(spec), groups, cfg, params, batch,
                         num_epochs=cfg.ae_warmup_epochs, log=log)
        params = dict(warm.state.params)
        if warm.preempted:
            # the warmup took the request; raise it again so that the main
            # fit saves the warmed state and stops before its first chunk
            train.request_preemption()
    omega = ae_model.data_scaled_omega(params, batch["x"])
    params["omega"] = omega
    cfg = dataclasses.replace(cfg, lr_omega=0.01 * float(torch.mean(torch.abs(omega[0]))))
    return cfg, params, loss_fn


def fourier_period_multistart(cfg, params, batch, loss_fn, groups, chunk=None, log=None, device_mesh=None):
    """Probe the FFT-informed candidate periods
    (``models.fourier.period_candidates`` of X and its POD modes) for
    ``cfg.period_probe_epochs`` each, from ``params`` with every period set to
    the candidate, and return the probe state of the lowest final rec (ties
    go to the first candidate), or None when there is no candidate; the main
    fit resumes from it. It rescues runs whose ``period_init`` sits in the
    periods' no-gradient basin (``desmo_tpu/runner.py:188-238``).

    Each probe is a ``train.fit`` through ``chunk`` (the mega-kernel's on the
    card, None for the eager loop). Over ``device_mesh`` ``batch`` is whole
    and ``chunk`` the sharded chunk: each probe trains this rank's rows and
    the kept state is gathered whole; every rank keeps the same candidate,
    since the rec each sees is the all-reduced one. A preemption during a
    probe stops the loop and is requested again, so that the main fit
    checkpoints at once."""
    cands = fourier_model.period_candidates(
        batch["x"].cpu().numpy(), cfg.period_init, n_candidates=cfg.period_multistart,
        pod_modes=batch["pod_modes"].cpu().numpy(),
    )
    if not cands:
        if log is not None:
            log("period multi-start: no usable period candidates; skipping")
        return None
    fit_batch = batch if device_mesh is None else parallel.shard_batch(batch, device_mesh)
    best = None
    for pc in cands:
        probe = dict(params, period=torch.full_like(params["period"], pc),
                     trig_period=torch.full_like(params["trig_period"], pc))
        state = train.init_state(probe, cfg)
        if device_mesh is not None:
            state = parallel.local_state(state, device_mesh)
        res = train.fit(loss_fn, groups, cfg, probe, fit_batch, num_epochs=cfg.period_probe_epochs, log=None,
                        state=state, chunk=chunk, device_mesh=device_mesh)
        if res.history:
            rec = float(res.history["rec"][-1])
            if log is not None:
                log(f"period multi-start: candidate {pc:.4f} -> rec {rec:.6f}")
            if best is None or rec < best[0]:
                best = (rec, pc, res.state)
        if res.preempted:
            # fit took the request: raise it again, so that the probes stop
            # here and the main fit checkpoints at once
            if log is not None:
                log("period multi-start: preempted; skipping remaining candidates")
            train.request_preemption()
            break
    if best is None:
        return None
    if log is not None:
        log(f"period multi-start: keeping period {best[1]:.4f} (rec {best[0]:.6f})")
    return best[2] if device_mesh is None else parallel.gather_state(best[2], device_mesh, cfg.n)


def split_holdout(x: np.ndarray, m_train: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``m_train`` snapshots and the rest, both recentred on the
    training window's temporal mean, so that no held-out statistic leaks
    into training (``desmo_tpu/runner.py:320-322``, ``:1138-1140``)."""
    mu_train = x[:, :m_train].mean(axis=1, keepdims=True)
    return np.asarray(x[:, :m_train] - mu_train), np.asarray(x[:, m_train:] - mu_train)


def json_finite(obj):
    """``obj`` with every non-finite float replaced by None, recursively:
    ``json.dump`` would write ``Infinity``/``NaN``, which RFC 8259 does not
    allow. Records stay raw in memory; sanitize where they are written."""
    if isinstance(obj, dict):
        return {k: json_finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def _forecast_baselines(x_train: np.ndarray, x_hold: np.ndarray) -> dict:
    """The trivial predictors' errors on the held-out window:
    ``baseline_zero_error``, the zero predictor, which is the training-mean
    predictor once both windows are recentred on that mean (1.0 by
    construction, recorded as computed), and ``baseline_last_error``, the
    last training snapshot held over the window (persistence)."""
    nrm = float(np.linalg.norm(x_hold))
    last = x_train[:, -1:]
    return {
        "baseline_zero_error": float(np.linalg.norm(x_hold) / nrm),
        "baseline_last_error": float(np.linalg.norm(np.broadcast_to(last, x_hold.shape) - x_hold) / nrm),
    }


@torch.no_grad()
def _fourier_forecast_record(params: dict, pod_modes: torch.Tensor, spec, m_train: int, xd: torch.Tensor,
                             recon: torch.Tensor, err: float, x_hold: np.ndarray) -> dict:
    """A trained Fourier series scored at the held-out times, for
    :func:`run` with a holdout and :func:`evaluate` with ``forecast_after``.
    The training grid is ``t_points(m_train)`` (spacing m/(m-1)), so held-out
    snapshot j sits at ``t = j m_train/(m_train - 1)``, built in float32 as
    the JAX package builds it. Adds per-snapshot errors of both windows."""
    h = int(np.asarray(x_hold).shape[1])
    t_hold = (float(m_train) / (m_train - 1)) * np.arange(m_train, m_train + h, dtype=np.float32)
    hold = torch.as_tensor(np.ascontiguousarray(x_hold, dtype=np.float32), device=pod_modes.device)
    recon_h = fourier_model.apply(params, pod_modes, spec, t=torch.as_tensor(t_hold, device=pod_modes.device))[0]
    return {
        "m_train": int(m_train),
        "m_holdout": h,
        "train_error": err,
        "holdout_error": float(losses.relative_frobenius_error(hold, recon_h)),
        **_forecast_baselines(xd.cpu().numpy(), np.asarray(x_hold)),
        "per_snapshot_train_error": losses.per_snapshot_relative_error(xd, recon).cpu().numpy().tolist(),
        "per_snapshot_holdout_error": losses.per_snapshot_relative_error(hold, recon_h).cpu().numpy().tolist(),
    }


def run(
    cfg: configs.RunConfig,
    x: np.ndarray,
    out_dir: str = "./runs",
    num_epochs: Optional[int] = None,
    echo: bool = True,
    *,
    device: str | torch.device = "cuda",
    holdout: float = 0.0,
    device_mesh: parallel.SpaceMesh | None = None,
    resume_from: Optional[str] = None,
) -> RunArtifacts:
    """Train, report and export one preset on ``device``, or on the ranks of
    ``device_mesh`` (``parallel.make_mesh``; then on its device).

    Writes ``<out_dir>/<name>/``: the CSV/JSONL metrics, ``state_final.npz``,
    ``<name>_r<r>_final.pt`` and, every ``checkpoint_every`` epochs,
    ``state_epoch<N>.npz`` and ``<name>_r<r>_epoch<N>.pt``. The chunks run
    through the mega-kernel or the eager loop as
    ``kernels.train_chunk.select_chunk`` decides. With ``cfg.n_seeds > 1``
    the seeds train packed (:func:`run_ensemble`), the exports hold the best
    live seed, and ``ensemble.json`` and ``term_stability.json`` are
    written. ``ga_single_pass`` is a
    TPU shortcut of the mega-kernel's Gram and is ignored: the port's kernel
    computes the exact Gram. ``cfg.pod_method`` picks the POD
    (:func:`compute_pod`). A Fourier config with ``period_multistart > 1``
    and one seed first probes the candidate periods
    (:func:`fourier_period_multistart`) through the run's chunk, unless it
    resumes.

    ``holdout`` (the Fourier variant; a fraction in (0, 0.5)) holds out the
    last ``holdout`` of the snapshots, trains on the first
    ``round(m (1 - holdout))``, both windows recentred on the training mean,
    and scores the trained series at the held-out times
    (:func:`_fourier_forecast_record`): ``RunArtifacts.forecast`` and
    ``forecast.json``. A failed forecast leaves a record with its error and
    the final artifacts are still written; a preempted run skips the
    scoring. The desmo and AE variants chain the SR forecast, which is not
    ported yet and raises.

    ``resume_from`` (a ``state_*.npz`` of either package) continues that
    run's state for ``num_epochs`` more epochs; with ``n_seeds > 1`` it
    raises ``ValueError``, as the JAX package does. A preemption request
    (``train.request_preemption``, the CLI's SIGTERM) stops training at a
    chunk boundary: the run then writes ``state_final.npz`` and the final
    ``.pt``, skips the sweep and returns ``preempted=True``. With
    ``run_greedy_prune`` (the channel preset) ``sparsify.greedy_prune``
    runs after the sweep (``RunArtifacts.greedy``).

    Over a mesh (:func:`select_sharded_chunk`; with ``n_seeds > 1``
    ``ensemble.fit(device_mesh=...)``), every rank holds all of X and trains
    its rows of phi (``parallel.shard_batch``); rank 0 computes the POD and
    the initial parameters and broadcasts them. Phi and its moments are
    gathered only for the exports, the relative error, the sweep and the
    term stability, which every rank then holds; only rank 0 writes files
    and prints, and only its POD errors are numbers (NaN on the other
    ranks)."""
    x_hold = None
    if holdout:
        if cfg.variant not in ("fourier", "desmo", "ae"):
            raise ValueError(f"holdout forecasting needs the fourier, desmo or ae variant, got {cfg.variant!r}")
        if not 0.0 < holdout < 0.5:
            raise ValueError(f"holdout must be in (0, 0.5), got {holdout}")
        m_train = int(round(x.shape[1] * (1.0 - holdout)))
        if m_train < 8 or m_train >= x.shape[1]:
            raise ValueError(f"holdout {holdout} leaves m_train={m_train} of {x.shape[1]}")
        if cfg.variant != "fourier":
            raise NotImplementedError(
                f"desmo_tpu_torch does not run the {cfg.variant} variant's holdout forecast (the chained SR leg, "
                "ROADMAP queue 1, item 6) yet"
            )
        x, x_hold = split_holdout(x, m_train)
    dev = device_mod.resolve(device if device_mesh is None else device_mesh.device)
    lead = device_mesh is None or device_mesh.rank == 0
    cfg = single_seed_sweep(dataclasses.replace(cfg, n=x.shape[0], m=x.shape[1]))
    check_supported(cfg)
    if resume_from and cfg.n_seeds > 1:
        raise ValueError("n_seeds > 1 requires the desmo or fourier variant and no --resume (ensemble.py scope)")
    out_dir = os.path.join(out_dir, cfg.name)
    if lead:
        os.makedirs(out_dir, exist_ok=True)
    spec, params, loss_fn, groups = build_model(cfg, dev)
    ae = cfg.variant == "ae"
    if device_mesh is None:
        p, p2 = compute_pod(cfg, x, dev)  # the AE variant's error table still has POD's rows
        modes = None if ae else p.modes
        chunk = None
    else:
        chunk = select_sharded_chunk(spec, cfg, device_mesh) if cfg.n_seeds <= 1 else None
        if lead:
            p, p2 = compute_pod(cfg, x, dev)
            modes = p.modes.contiguous()
        else:
            p = p2 = None
            modes = torch.empty((cfg.n, cfg.r), dtype=torch.float32, device=dev)
        for t in [modes, *params.values()]:  # rank 0's, so that the ranks cannot drift apart
            device_mesh.broadcast(t)
    batch = prepare_batch(x, modes, dev)

    logger = MetricsLogger(out_dir, cfg.name, echo=False) if lead else None

    def export(state: train.TrainState, tag: str) -> None:
        if not lead:
            return
        checkpoint.save_state(os.path.join(out_dir, f"state_{tag}.npz"), state)
        checkpoint.save_pt(
            os.path.join(out_dir, f"{cfg.name}_r{cfg.r}_{tag}.pt"),
            checkpoint.state_dict_from_params(state.params, cfg.variant),
        )

    n_epochs = num_epochs if num_epochs is not None else cfg.num_epochs
    log = (lambda line: print(line, flush=True)) if echo and lead else None
    state = None
    if resume_from:
        state = checkpoint.load_state(resume_from, train.init_state(params, cfg))
        if ae and cfg.ae_recipe:
            # the state holds the recipe's parameters and LRs; the loss takes
            # its clamped config again
            cfg = ae_recipe_cfg(cfg)
            loss_fn = ae_model.build_loss(spec, cfg.beta, cfg.l1_lambda, cfg.ae_beta,
                                          method=resolve_loss_method(cfg, dev))
    elif ae and cfg.ae_recipe:
        cfg, params, loss_fn = ae_recipe(cfg, spec, params, groups, batch, dev, log)
    elif ae and cfg.ae_omega_data_scaled:
        params = dict(params, omega=ae_model.data_scaled_omega(params, batch["x"]))
    if device_mesh is None and cfg.n_seeds <= 1:
        # after the AE recipe, whose config the AE kernel's chunk reads
        chunk = train_chunk.select_chunk(spec, cfg, dev)
    if state is None and cfg.variant == "fourier" and cfg.period_multistart > 1 and cfg.n_seeds <= 1:
        # with n_seeds > 1 ensemble.fit trains the candidates as per-seed inits
        state = fourier_period_multistart(cfg, params, batch, loss_fn, groups, chunk=chunk, log=log,
                                          device_mesh=device_mesh)
    if cfg.n_seeds > 1:
        result = run_ensemble(cfg, spec, batch, n_epochs, dev, out_dir, export, log, device_mesh)
    elif device_mesh is not None:
        result = train.fit(
            loss_fn, groups, cfg, params, parallel.shard_batch(batch, device_mesh),
            num_epochs=n_epochs,
            log=log,
            checkpoint_fn=lambda state, epoch: export(state, f"epoch{epoch}"),
            state=parallel.local_state(state or train.init_state(params, cfg), device_mesh),
            chunk=chunk,
            device_mesh=device_mesh,
        )
        result.state = parallel.gather_state(result.state, device_mesh, cfg.n)
    else:
        result = train.fit(
            loss_fn, groups, cfg, params, batch,
            num_epochs=n_epochs,
            log=log,
            checkpoint_fn=lambda state, epoch: export(state, f"epoch{epoch}"),
            state=state,
            chunk=chunk,
        )
    if logger is not None:
        # a resumed or preempted run has history only for the epochs it ran
        n_ran = len(next(iter(result.history.values()))) if result.history else 0
        start_epoch = result.state.epoch - n_ran
        for i in range(0, n_ran, cfg.log_every):
            logger.log_epoch(start_epoch + i, start_epoch + n_epochs, {k: v[i] for k, v in result.history.items()})
        logger.close()

    with torch.no_grad():
        recon = reconstruct(result.state.params, batch, spec, cfg.variant)
        err = float(losses.relative_frobenius_error(batch["x"], recon))
        err_pod = pod.pod_relative_error(batch["x"], p) if lead else float("nan")
        err_pod2 = pod.pod_relative_error(batch["x"], p2) if lead else float("nan")
    echo = echo and lead
    if echo:
        print(f"DESMO error with {cfg.r} modes: {err}")
        print(f"POD error with {cfg.r} modes: {err_pod}")
        print(f"POD error with {2 * cfg.r} modes: {err_pod2}")
    artifacts = RunArtifacts(
        config=cfg,
        state=result.state,
        history=result.history,
        relative_error=err,
        pod_error_r=err_pod,
        pod_error_2r=err_pod2,
        steps_per_sec=result.steps_per_sec,
        sweep=[],
        out_dir=out_dir,
        preempted=result.preempted,
    )
    if result.preempted:
        # a preemption's grace window is short: write what resumes the run
        # and skip the rest, the holdout scoring included
        export(result.state, "final")
        return artifacts

    if x_hold is not None and lead:
        try:
            artifacts.forecast = _fourier_forecast_record(
                result.state.params, batch["pod_modes"], spec, cfg.m, batch["x"], recon, err, x_hold,
            )
        except Exception as exc:  # a failed forecast must not cost the run its final artifacts
            artifacts.forecast = {
                "m_train": int(cfg.m), "m_holdout": int(x_hold.shape[1]), "train_error": err,
                "error": f"{type(exc).__name__}: {exc}",
            }
        with open(os.path.join(out_dir, "forecast.json"), "w") as fh:
            json.dump(json_finite(artifacts.forecast), fh, indent=1)
        if echo:
            if "error" in artifacts.forecast:
                print(f"forecast FAILED (final artifacts still saved): {artifacts.forecast['error']}")
            else:
                print(f"forecast (trained series at held-out times): trained on {cfg.m} snapshots, held out "
                      f"{artifacts.forecast['m_holdout']}; train err {err:.6f}, HELD-OUT err "
                      f"{artifacts.forecast['holdout_error']:.6f} (POD alone cannot forecast unseen times at all)")

    artifacts.sweep = sparsify.threshold_sweep(
        result.state.params, batch, spec, log=print if echo else None
    )
    if cfg.run_greedy_prune:
        # the turbulent-channel reference's one-at-a-time term removal
        artifacts.greedy = sparsify.greedy_prune(result.state.params, batch, spec, log=print if echo else None)
    export(result.state, "final")
    return artifacts


@torch.no_grad()
def evaluate(
    cfg: configs.RunConfig,
    x: np.ndarray,
    checkpoint_path: str,
    echo: bool = True,
    *,
    device: str | torch.device = "cuda",
    device_mesh=None,
    figures_dir: Optional[str] = None,
    forecast_after: Optional[int] = None,
) -> dict:
    """Inference from a ``.pt`` checkpoint (the port's, the JAX package's or
    the reference's) on ``device``, no training: the relative error, the
    POD baselines and the threshold sweep, as ``desmo_tpu/runner.py:1095``.

    The model is sized from the checkpoint (``checkpoint.infer_spec_dims``,
    or ``models.autoencoder.infer_spec_dims`` for the AE variant; a Fourier
    checkpoint's series length gives nF), and the POD is rebuilt with
    ``cfg.pod_method``, which must be the method the checkpoint was trained
    under (:func:`compute_pod`). ``forecast_after`` (a Fourier checkpoint
    trained on the first ``forecast_after`` snapshots of ``x``) scores the
    series at the held-out times beyond them, both windows recentred on the
    training mean, and adds a ``forecast`` record. Returns
    ``{"relative_error", "pod_error_r", "pod_error_2r", "sweep"}``, the sweep
    as (threshold, error, nonzero terms) tuples.

    Not ported yet, each raising ``NotImplementedError``: ``device_mesh``
    (ROADMAP queue 1, item 5), ``figures_dir`` and ``forecast_after`` on a
    desmo or AE checkpoint (item 6)."""
    if device_mesh is not None:
        raise NotImplementedError(
            "desmo_tpu_torch does not run evaluate over a device mesh (ROADMAP queue 1, item 5) yet")
    if figures_dir is not None:
        raise NotImplementedError("desmo_tpu_torch does not draw figures (ROADMAP queue 1, item 6) yet")
    x_hold = None
    if forecast_after:
        m_tr = int(forecast_after)
        if not 1 < m_tr < x.shape[1]:
            raise ValueError(
                f"forecast_after={m_tr} must split the series: data has {x.shape[1]} snapshots and the "
                "held-out window needs >= 1"
            )
        if cfg.variant != "fourier":
            raise NotImplementedError(
                f"desmo_tpu_torch does not run the {cfg.variant} variant's forecast_after (the chained SR leg, "
                "ROADMAP queue 1, item 6) yet"
            )
        x, x_hold = split_holdout(x, m_tr)
    dev = device_mod.resolve(device)
    cfg = dataclasses.replace(cfg, n=x.shape[0], m=x.shape[1])
    sd = checkpoint.load_pt(checkpoint_path)
    ae = cfg.variant == "ae"
    r, poly_order = ae_model.infer_spec_dims(sd) if ae else checkpoint.infer_spec_dims(sd)
    if (r, poly_order) != (cfg.r, cfg.poly_order):
        if echo:
            print(f"checkpoint is r={r}, P={poly_order} (preset {cfg.r}, {cfg.poly_order}) — using checkpoint dims")
        cfg = dataclasses.replace(cfg, r=r, poly_order=poly_order)
    if cfg.variant == "fourier" and "z_list.0" in sd:
        # a channel's series has 2 nF + 1 coefficients
        nf = (int(sd["z_list.0"].reshape(-1).shape[0]) - 1) // 2
        if nf != cfg.n_fourier:
            cfg = dataclasses.replace(cfg, n_fourier=nf)
    spec = build_model(cfg, dev)[0]
    params = checkpoint.params_from_state_dict(sd, dev, cfg.variant)
    # frozen masks pair with the signs of the modes they were trained
    # against: compute_pod rebuilds the checkpoint's convention
    p, p2 = compute_pod(cfg, x, dev)
    batch = prepare_batch(x, None if ae else p.modes, dev)
    recon = reconstruct(params, batch, spec, cfg.variant)
    err = float(losses.relative_frobenius_error(batch["x"], recon))
    err_pod, err_pod2 = pod.pod_relative_error(batch["x"], p), pod.pod_relative_error(batch["x"], p2)
    if echo:
        print(f"DESMO error with {cfg.r} modes: {err}")
        print(f"POD error with {cfg.r} modes: {err_pod}")
        print(f"POD error with {2 * cfg.r} modes: {err_pod2}")
    forecast = None
    if x_hold is not None:
        forecast = _fourier_forecast_record(params, batch["pod_modes"], spec, cfg.m, batch["x"], recon, err, x_hold)
        if echo:
            print(f"forecast: checkpoint trained on {cfg.m} snapshots, held out {forecast['m_holdout']}; train err "
                  f"{err:.6f}, HELD-OUT err {forecast['holdout_error']:.6f}")
    sweep = sparsify.threshold_sweep(params, batch, spec, log=print if echo else None)
    out = {
        "relative_error": err,
        "pod_error_r": err_pod,
        "pod_error_2r": err_pod2,
        "sweep": [(e.threshold, e.error, e.nonzero_terms) for e in sweep],
    }
    if forecast is not None:
        out["forecast"] = forecast
    return out
