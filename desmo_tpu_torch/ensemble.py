"""Seed-packed multi-seed (ensemble, multi-start) DESMO training. Port of
``desmo_tpu/ensemble.py``.

S independently initialized models train side by side: their dictionaries
pack into one A (n, S K) and their temporal matrices into one B (S K, m), so
one read of X serves every seed. Only each seed's own diagonal block of the
packed Grams enters its objective, so every seed follows the trajectory it
would follow alone; each has its own plateau scheduler row, and may have its
own beta, lambda and LR scale (the hyperparameter multi-start,
:func:`resolve_hypers`). :func:`fit` trains the seeds in packed groups of at
most :func:`max_seeds_packed`, contains diverged seeds by rolling back and
freezing them, and keeps the best.

On a GPU a group runs through the packed mega-kernel
(``kernels.train_chunk.fused_ensemble_chunk``), else through the packed
eager loop (:func:`make_ensemble_chunk`), whose fused loss reads X through
the dual-contraction kernel at the packed width. Over a device mesh
(``fit(device_mesh=...)``) the seeds stay packed while their rows of phi
shard over the ranks: a group runs through the sharded step's packed form
(``kernels.shard_step.make_sharded_fused_ensemble_chunk``). The TPU got the extra seeds
almost free (its matrix unit pads K to 128 lanes); on the GPU the work grows
with S K, and what packing shares is the read of X and the per-epoch fixed
costs.
"""

from __future__ import annotations

import itertools
import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from desmo_tpu_torch import library, optim, parallel, profiling, sparsify, train
from desmo_tpu_torch.configs import GROUP_ORDER, RunConfig
from desmo_tpu_torch.kernels import dual_gemm
from desmo_tpu_torch.kernels import train_chunk as tc
from desmo_tpu_torch.models import desmo as desmo_model
from desmo_tpu_torch.models import fourier as fourier_model

LANES = 128


def max_seeds_packed(spec) -> int:
    """How many seeds one pack holds: 128 // K, as the JAX package packs them
    into its 128 lanes. The group structure is a contract: group g draws its
    jitter from ``seed + g``."""
    K = spec.num_poly_terms + 3 * spec.r
    return max(1, LANES // K)


def resolve_hypers(cfg: RunConfig, n_seeds: int, warn: bool = True):
    """Per-seed hyperparameters from the config's sweep lists, or None.

    ``cfg.sweep_beta``, ``cfg.sweep_lam`` and ``cfg.sweep_lr_scale`` are value
    lists whose cartesian product forms the combo grid; seed s takes
    ``combos[s % len(combos)]``. An empty list contributes the config's own
    value. Returns None when no sweep is configured (every list empty or at
    the config's value), else a dict of float32 arrays ``betas``, ``lams``,
    ``lr_scales`` (length ``n_seeds``) and the grid ``combos``."""
    bl = tuple(float(v) for v in (getattr(cfg, "sweep_beta", ()) or (cfg.beta,)))
    ll = tuple(float(v) for v in (getattr(cfg, "sweep_lam", ()) or (cfg.l1_lambda,)))
    sl = tuple(float(v) for v in (getattr(cfg, "sweep_lr_scale", ()) or (1.0,)))
    if bl == (float(cfg.beta),) and ll == (float(cfg.l1_lambda),) and sl == (1.0,):
        return None
    combos = list(itertools.product(bl, ll, sl))
    take = [combos[s % len(combos)] for s in range(n_seeds)]
    if warn and len(combos) > n_seeds:
        warnings.warn(
            f"{len(combos)} hyperparameter combos but only {n_seeds} seeds — combos beyond the first "
            f"{n_seeds} will not be trained; raise --seeds to cover the full grid",
            stacklevel=2,
        )
    return {
        "betas": np.asarray([c[0] for c in take], np.float32),
        "lams": np.asarray([c[1] for c in take], np.float32),
        "lr_scales": np.asarray([c[2] for c in take], np.float32),
        "combos": combos,
    }


def packed_factor_table(spec, n_seeds: int) -> np.ndarray:
    """Seed-blocked factor table (S T, P) into ``[1, lat(0,0)..lat(0,r-1),
    lat(1,0)..]``: index 0 stays the shared constant one, seed s's mode i is
    column ``1 + s r + i``."""
    F = spec.factor_table()
    return np.concatenate([np.where(F > 0, F + s * spec.r, 0) for s in range(n_seeds)], axis=0)


def _generators(seed: int) -> tuple[torch.Generator, torch.Generator]:
    """Two independent CPU generators (phi, omega) from one integer seed."""
    a, b = np.random.SeedSequence(seed).generate_state(2, np.uint64)
    return torch.Generator().manual_seed(int(a)), torch.Generator().manual_seed(int(b))


def init_params(
    spec, n_seeds: int, seed: int = 0, phi_sigma: float = 0.02, omega_spread: float = 0.0, periods=None,
    device: torch.device | str = "cpu",
) -> dict:
    """Per-seed DESMO or DESMOFourier params with a leading seed axis.

    Seed 0 is exactly the reference init (all ones, omega = omega_init);
    seeds 1.. jitter phi multiplicatively (1 + sigma N(0, 1)) and omega
    log-uniformly within ``10**[-omega_spread, omega_spread]``. The draws
    come from ``torch.Generator``s seeded from ``seed`` (on the CPU, then
    moved), so seeds >= 1 differ from the JAX package's ``jax.random``
    draws; to start both packages alike, carry the JAX params over
    (``checkpoint.params_from_jax``). ``periods`` (Fourier only) gives seed
    s the period init ``periods[s % len(periods)]``."""
    is_fourier = hasattr(spec, "n_fourier")
    base = (fourier_model.Fourier(spec) if is_fourier else desmo_model.Desmo(spec)).params()
    S = n_seeds
    stacked = {k: v.detach()[None].expand(S, *v.shape).clone() for k, v in base.items()}
    g_phi, g_omega = _generators(seed)
    if S > 1 and phi_sigma > 0.0:
        noise = phi_sigma * torch.randn((S - 1, spec.r, spec.n), generator=g_phi)
        stacked["phi"][1:] *= 1.0 + noise
    if S > 1 and omega_spread > 0.0:
        u = torch.rand((S - 1, 3, spec.r), generator=g_omega)
        stacked["omega"][1:] *= 10.0 ** ((2.0 * u - 1.0) * omega_spread)
    if periods is not None and len(periods) > 0:
        if not is_fourier:
            raise ValueError("periods only applies to the fourier variant")
        pv = torch.tensor([float(periods[s % len(periods)]) for s in range(S)], dtype=torch.float32)
        stacked["period"] = pv[:, None].expand_as(stacked["period"]).clone()
        stacked["trig_period"] = pv[:, None, None].expand_as(stacked["trig_period"]).clone()
    return {k: v.to(device) for k, v in stacked.items()}


def extract_seed(params: dict, s: int) -> dict:
    """Member ``s``'s single-seed params, usable by checkpoint, sparsify and
    the single-seed trainers."""
    return {k: v[s] for k, v in params.items()}


def packed_dictionary(params: dict, pod_modes: torch.Tensor, spec, factors_packed: torch.Tensor):
    """The packed dictionary ``A (n, S K)`` (per seed block [T polynomial
    terms, 3r trig terms], the single-seed column order) and the latents
    (S, n, r). ``factors_packed`` is :func:`packed_factor_table` as an int64
    tensor on the modes' device."""
    S = params["phi"].shape[0]
    n = pod_modes.shape[0]
    latents = pod_modes[None] * params["phi"].transpose(1, 2)  # (S, n, r)
    lat_packed = latents.transpose(0, 1).reshape(n, S * spec.r)
    theta = library.eval_library(lat_packed, factors_packed).view(n, S, spec.num_poly_terms)
    theta = theta * params["c"][None]
    args = params["omega"][:, :, :, None] * latents.transpose(1, 2)[:, None]  # (S, 3, r, n)
    basis = torch.stack([torch.sin(args[:, 0]), torch.cos(args[:, 1]), torch.tanh(args[:, 2])], dim=1)
    g = (params["c_trig"][..., None] * basis).reshape(S, 3 * spec.r, n).permute(2, 0, 1)  # (n, S, 3r)
    return torch.cat([theta, g], dim=2).reshape(n, -1), latents


def packed_temporal(params: dict) -> torch.Tensor:
    """``B (S K, m)``, block rows matching :func:`packed_dictionary`'s columns."""
    S, _, m = params["z"].shape
    return torch.cat([params["z"], params["z_trig"].reshape(S, -1, m)], dim=1).reshape(-1, m)


def packed_temporal_fourier(params: dict, t: torch.Tensor) -> torch.Tensor:
    """Fourier ``B (S K, m)``: every seed's series, with its own coefficients
    and periods, in one batched evaluation."""
    S = params["z"].shape[0]
    z = fourier_model.fourier_series_batch(params["z"], params["period"], t)
    zt = fourier_model.fourier_series_batch(params["z_trig"], params["trig_period"], t)
    return torch.cat([z, zt.reshape(S, -1, z.shape[-1])], dim=1).reshape(-1, z.shape[-1])


def factored_mse_blocks(a, b, x, x_sq, n_seeds: int) -> torch.Tensor:
    """Per-seed ``mean((A_s B_s - X)^2)`` (S,) from one set of packed
    products, each seed's Grams over its own block."""
    if x_sq is None:
        x_sq = torch.sum(x * x)
    return dual_gemm.mse_blocks_value(a, b, a.T @ x, x_sq, x.shape[0] * b.shape[1], n_seeds)[0]


def build_loss(spec, cfg: RunConfig, n_seeds: int, method: str = "factored", betas=None, lams=None) -> Callable:
    """Packed multi-seed loss ``(params, batch) -> (sum_s total_s, metrics)``
    with (S,) metrics ``rec``, ``ortho``, ``l1`` and ``total_s``. The seeds'
    params are disjoint, so the gradient of the sum is the stacked per-seed
    gradient. ``method``: 'fused' serves every seed with one launch per step
    of the dual-contraction kernel (``FactoredMSEFusedBlocks``),
    'factored' uses plain products. ``betas``/``lams`` (length S) weight each
    seed's ortho and L1 terms."""
    if method not in ("factored", "fused"):
        raise ValueError(f"unknown packed loss method {method!r}")
    device_consts: dict[torch.device, tuple] = {}
    is_fourier = getattr(cfg, "variant", "desmo") == "fourier"
    table = packed_factor_table(spec, n_seeds)

    def consts(device):
        if device not in device_consts:
            t = torch.as_tensor(fourier_model.t_points(spec.m), device=device) if is_fourier else None
            beta = float(cfg.beta) if betas is None else torch.as_tensor(np.asarray(betas, np.float32), device=device)
            lam = float(cfg.l1_lambda) if lams is None else torch.as_tensor(np.asarray(lams, np.float32), device=device)
            iu = torch.triu(torch.ones((spec.r, spec.r), dtype=torch.bool, device=device), diagonal=1)
            device_consts[device] = (torch.as_tensor(table, dtype=torch.int64, device=device), t, beta, lam, iu)
        return device_consts[device]

    def loss_fn(params: dict, batch: dict):
        factors, t, beta, lam, iu = consts(batch["pod_modes"].device)
        A, latents = packed_dictionary(params, batch["pod_modes"], spec, factors)
        B = packed_temporal_fourier(params, t) if is_fourier else packed_temporal(params)
        if method == "fused":
            x_sq = batch.get("x_sq")
            if x_sq is None:
                x_sq = torch.sum(batch["x"] * batch["x"])
            rec = dual_gemm.factored_mse_fused_blocks(A, B, batch["x"], x_sq, n_seeds)
        else:
            rec = factored_mse_blocks(A, B, batch["x"], batch.get("x_sq"), n_seeds)
        gram = latents.transpose(1, 2) @ latents  # (S, r, r)
        ortho = torch.where(iu[None], gram.abs(), torch.zeros_like(gram)).sum((1, 2))
        l1 = params["c"].abs().sum(1) + params["c_trig"].abs().sum((1, 2))
        total_s = rec + beta * ortho + lam * l1
        return total_s.sum(), {"rec": rec, "ortho": ortho, "l1": l1, "total_s": total_s}

    return loss_fn


class _SeedFlatLayout(train.FlatLayout):
    """``train.FlatLayout`` with seed-major group LRs: element i's LR index is
    ``seed * len(GROUP_ORDER) + group`` into the raveled (S, G) scheduler LR
    matrix, so each seed's scheduler steers only its own slice."""

    def __init__(self, params: dict, group_of: dict[str, str], n_seeds: int):
        super().__init__(params, group_of)
        G = len(GROUP_ORDER)
        gidx = []
        for k, size in zip(self.keys, self.sizes):
            if self.shapes[k][0] != n_seeds:
                raise ValueError(f"{k}: missing the seed axis")
            g = GROUP_ORDER.index(group_of[k])
            gidx.append(np.repeat(np.arange(n_seeds) * G + g, size // n_seeds))
        self.group_index = torch.as_tensor(np.concatenate(gidx), device=self.group_index.device)


def init_state(params: dict, cfg: RunConfig, n_seeds: int, lr_scales=None) -> train.TrainState:
    """A stacked TrainState whose scheduler carries per-seed LR rows (S, G),
    best and num_bad (S,). ``lr_scales`` (length S) multiplies seed s's LR
    row."""
    params = {k: v.detach().clone() for k, v in params.items()}
    device = params["phi"].device
    lrs = torch.as_tensor(np.asarray(cfg.group_lrs, np.float32), device=device).expand(n_seeds, -1).clone()
    if lr_scales is not None:
        scales = np.asarray(lr_scales, np.float32)
        if scales.shape != (n_seeds,):
            raise ValueError(f"lr_scales must have shape ({n_seeds},), got {scales.shape}")
        lrs = lrs * torch.as_tensor(scales, device=device)[:, None]
    sched = optim.PlateauState(
        lrs=lrs,
        best=torch.full((n_seeds,), float("inf"), dtype=torch.float32, device=device),
        num_bad=torch.zeros((n_seeds,), dtype=torch.int32, device=device),
    )
    return train.TrainState(
        params=params,
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=0, sched=sched, epoch=0,
    )


def make_ensemble_chunk(loss_fn, group_of: dict[str, str], cfg: RunConfig, n_seeds: int, param_shardings=None):
    """The packed eager chunk ``chunk(state, batch, num_steps) -> (state,
    metrics)``: ``train.make_train_chunk`` with seed-major per-element LRs,
    the shared Adamax count, and one plateau scheduler row per seed, stepped
    by that seed's own total. Metrics: ``rec``, ``ortho``, ``l1``,
    ``total_s`` (num_steps, S) and ``total`` (num_steps,)."""
    if param_shardings is not None:
        raise NotImplementedError(
            "desmo_tpu_torch does not run the packed eager loop over a device mesh yet "
            "(ROADMAP queue 1, item 5.2: the eager path over a mesh)"
        )

    def chunk(state: train.TrainState, batch: dict, num_steps: int):
        layout = _SeedFlatLayout(state.params, group_of, n_seeds)
        vec = layout.flatten(state.params)
        opt = optim.AdamaxState(state.count, layout.flatten(state.mu), layout.flatten(state.nu))
        sched, epoch = state.sched, state.epoch
        rows, totals = [], []
        for _ in range(num_steps):
            leaf = vec.detach().requires_grad_(True)
            total, metrics = loss_fn(layout.unflatten(leaf), batch)
            (grad,) = torch.autograd.grad(total, leaf)
            with torch.no_grad():
                updates, opt = optim.adamax_update(grad, opt, sched.lrs.reshape(-1)[layout.group_index])
                vec = leaf.detach() + updates
                if epoch % cfg.sched_every == 0:
                    sched = optim.plateau_step(
                        sched, metrics["total_s"], patience=cfg.patience,
                        factor=cfg.sched_factor, min_lr=cfg.sched_min_lr,
                    )
                rows.append(torch.stack([metrics[k].detach() for k in tc.SEED_METRICS], dim=1))
                totals.append(total.detach())
            epoch += 1
        out = train.TrainState(
            layout.unflatten(vec), layout.unflatten(opt.mu), layout.unflatten(opt.nu),
            opt.count, sched, epoch,
        )
        stacked = torch.stack(rows)
        mets = {k: stacked[:, :, i] for i, k in enumerate(tc.SEED_METRICS)}
        mets["total"] = torch.stack(totals)
        return out, mets

    return chunk


def term_stability(seed_params: Sequence[dict], spec, threshold: float = 1.0) -> dict:
    """Which candidate terms survive sparsification in every member: the
    (S, T + 3r) energy matrix of the live members' params (the reference's
    convention, ``sparsify.term_energies``), the per-term selection
    ``frequency`` at ``threshold``, and the energies' mean and std across
    seeds; names in the reference's order (poly, then interleaved trig)."""
    rows = []
    for p in seed_params:
        e = sparsify.term_energies(p, spec)
        rows.append(np.concatenate([np.asarray(e.poly), e.interleaved_trig()]))
    E = np.stack(rows)
    names = library.poly_term_names(spec.r, spec.poly_order) + library.ref_interleaved_trig_names(spec.r)
    sel = E >= threshold
    return {
        "names": names,
        "energies": E,
        "threshold": float(threshold),
        "frequency": sel.mean(axis=0),
        "mean": E.mean(axis=0),
        "std": E.std(axis=0),
    }


def seed_state(state: train.TrainState, cfg: RunConfig, s: int) -> train.TrainState:
    """Member ``s`` of a stacked state as a single-seed TrainState, resumable
    by the single-seed chunks."""
    return tc.seed_view(state, s)


def _snapshot(state: train.TrainState) -> train.TrainState:
    """A copy of ``state`` that no later chunk writes to."""
    def copy(tree):
        return {k: v.detach().clone() for k, v in tree.items()}

    sched = state.sched
    return train.TrainState(
        copy(state.params), copy(state.mu), copy(state.nu), state.count,
        optim.PlateauState(sched.lrs.clone(), sched.best.clone(), sched.num_bad.clone()), state.epoch,
    )


def _restore_with_frozen(snap: train.TrainState, frozen: np.ndarray) -> train.TrainState:
    """A fresh state from the chunk-boundary snapshot with the seeds marked
    in ``frozen`` neutralized, so they cannot contaminate the pack again:
    params zeroed (periods 1, since a zero period puts 2 pi / period = inf
    back into the series), moments reset (nu to 1, never 0: Adamax divides
    by it), the LR row to 0 and the plateau counter to a large negative
    value, so that no plateau drop clamps the row back up to min_lr. Zero
    params are always finite-loss: the seed's rec pins at mean(X^2)."""
    fz = torch.as_tensor(frozen, device=snap.params["phi"].device)

    def mask(v, fill):
        return torch.where(fz.reshape((-1,) + (1,) * (v.ndim - 1)), torch.tensor(fill, dtype=v.dtype, device=v.device), v)

    return train.TrainState(
        params={k: mask(v, 1.0 if "period" in k else 0.0) for k, v in snap.params.items()},
        mu={k: mask(v, 0.0) for k, v in snap.mu.items()},
        nu={k: mask(v, 1.0) for k, v in snap.nu.items()},
        count=snap.count,
        sched=optim.PlateauState(
            lrs=mask(snap.sched.lrs, 0.0), best=snap.sched.best.clone(), num_bad=mask(snap.sched.num_bad, -(2**30))
        ),
        epoch=snap.epoch,
    )


def _fetch(mets: dict) -> dict:
    """The chunk's metrics on the host, in one copy."""
    keys = list(mets)
    flat = torch.cat([mets[k].reshape(-1).to(torch.float32) for k in keys]).cpu().numpy()
    out, o = {}, 0
    for k in keys:
        size = mets[k].numel()
        out[k] = flat[o:o + size].reshape(tuple(mets[k].shape))
        o += size
    return out


@profiling.traced("fit")
def fit(
    cfg: RunConfig,
    spec,
    batch: dict,
    n_seeds: int,
    num_epochs: Optional[int] = None,
    seed: int = 0,
    phi_sigma: float = 0.02,
    omega_spread: float = 0.0,
    method: Optional[str] = None,
    log: Optional[Callable[[str], None]] = print,
    checkpoint_fn: Optional[Callable] = None,
    max_recoveries: int = 8,
    device_mesh=None,
    hypers: Optional[dict] = None,
    report: Optional[dict] = None,
) -> tuple[train.TrainResult, int, np.ndarray]:
    """Train an S-seed packed ensemble; returns ``(result, best,
    final_totals)`` where ``result.state`` is the best member's single-seed
    TrainState and ``result.steps_per_sec`` counts seed-steps per second over
    every chunk after each chunk function's first call (which pays the
    kernel build and warm-up).

    Groups of at most :func:`max_seeds_packed` seeds run in turn, group g
    initialized from ``seed + g`` (only global seed 0 keeps the exact
    reference init); chunk functions are cached per (width, betas, lams).
    On a CUDA device a group runs the packed mega-kernel when
    ``kernels.train_chunk.select_ensemble_chunk`` picks it, else the packed
    eager loop with ``method`` ('fused' on a GPU, 'factored' on the CPU by
    default). A kernel that fails raises; nothing falls back.

    ``hypers`` (default :func:`resolve_hypers`) gives each seed its own
    beta, lambda and LR scale; the winner is then picked by its final rec,
    else by its final total. A non-finite per-seed total rolls the chunk
    back to the last healthy boundary, freezes the seeds that were
    non-finite at the first bad step (LR 0, final total inf, out of the
    selection), and re-runs it; when every seed has diverged, or after
    ``max_recoveries`` rollbacks, fit raises ``FloatingPointError``.
    ``checkpoint_fn(state, epoch)`` receives at every chunk boundary the
    group's best live seed: this thread takes its state (over
    ``device_mesh`` gathered whole, a collective) and its host copy, queued
    ahead of the next launch, and the checkpoint worker
    (``train.CheckpointWriter``) calls ``checkpoint_fn`` on its own thread
    while the next chunk runs, one write at a time and in order. A failed
    write raises at the next chunk boundary or at the group's end. A group's
    writes have all ended before its final state is used, so none runs after
    fit returns or raises. ``report`` (a dict) receives ``hypers``,
    ``final_recs``, ``live_seeds`` and ``seed_params`` (the live members'
    single-seed params, for :func:`term_stability`).

    A preemption request (``train.request_preemption``, the CLI's SIGTERM)
    stops the group in training at its next chunk boundary, after that
    boundary's checkpoint, and skips the groups not yet started (the first
    group always runs, so that there is a best seed); the result then has
    ``preempted=True`` and the request is cleared. Over ``device_mesh`` the
    ranks agree on the request by one MAX all-reduce.

    The call is span ``fit``, with ``train.fit``'s spans at each boundary
    and ``fit.drain`` at each group's end, ``fit.init`` (a group's init),
    ``fit.snapshot`` (the boundary's copy for a rollback) and
    ``fit.rollback``; the worker's ``ckpt.write`` in the ``fit.checkpoint``
    that handed it over; counters ``ensemble.rollbacks``,
    ``ensemble.frozen_seeds``, ``ckpt.writes`` and ``ckpt.waits``
    (``profiling``).

    ``device_mesh`` (``parallel.make_mesh``) shards the rows over its ranks:
    ``batch`` is whole on every rank and each group's init is drawn whole and
    broadcast from rank 0; each rank trains its rows of phi and its moments
    (``parallel.local_rows``) through the sharded packed chunk, and the
    metrics, so every rollback, freeze and pick of the best seed, are the
    same on every rank. What ``checkpoint_fn``, ``report`` and the result
    receive holds phi whole (``SpaceMesh.gather_rows``). Where
    ``select_ensemble_chunk`` takes no kernel under a mesh (``chunk_method``
    'scan', or seeds that do not pack) fit raises ``NotImplementedError``."""
    device = batch["x"].device
    local_batch = batch if device_mesh is None else parallel.shard_batch(batch, device_mesh)

    def whole(state: train.TrainState) -> train.TrainState:
        return state if device_mesh is None else parallel.gather_state(state, device_mesh, spec.n)

    if method is None:
        method = "fused" if device.type == "cuda" else "factored"
    if hypers is None:
        hypers = resolve_hypers(cfg, n_seeds)
    if report is not None:
        report["hypers"] = hypers
    if hypers is not None and log is not None:
        log(
            f"[ensemble] hyperparameter multi-start: {len(hypers['combos'])} (beta, l1_lambda, lr_scale) combos, "
            f"seed s takes combo s mod {len(hypers['combos'])}: {hypers['combos']}"
        )
    num_epochs = cfg.num_epochs if num_epochs is None else num_epochs
    if num_epochs <= 0:
        raise ValueError(f"ensemble.fit needs num_epochs > 0, got {num_epochs}")
    cap = max_seeds_packed(spec)
    is_fourier = getattr(cfg, "variant", "desmo") == "fourier"
    groups = desmo_model.param_groups(init_params(spec, 1))
    periods = None
    if is_fourier and getattr(cfg, "period_multistart", 1) > 1:
        # the FFT-informed period candidates become per-seed period inits
        periods = fourier_model.period_candidates(
            batch["x"].cpu().numpy(), cfg.period_init, n_candidates=max(n_seeds, cfg.period_multistart),
            pod_modes=batch["pod_modes"].cpu().numpy(),
        )
        if log is not None:
            log(f"[ensemble] fourier period candidates (seed s gets s mod {len(periods)}): "
                f"{np.round(periods, 4).tolist()}")
        if len(periods) > n_seeds:
            if log is not None:
                log(f"WARNING: {len(periods)} period candidates but only {n_seeds} seeds — candidates beyond "
                    f"the first {n_seeds} will not be trained; raise --seeds to cover all of them")
            periods = periods[:n_seeds]
        if not periods:
            periods = None

    results = []  # (final_total, selection metric, global seed, state, local seed, history)
    rec_by_seed: dict[int, float] = {}
    live_states: list[tuple[int, dict]] = []
    chunk_cache: dict = {}
    warmed: set = set()
    wall, steps_timed = 0.0, 0
    start = gi = 0
    preempted = False
    while start < n_seeds:
        if preempted or (results and train.preemption_agreed(device_mesh)):
            # between seed groups: keep what is trained
            preempted = True
            if log is not None:
                log(f"graceful preemption: skipping seed groups from seed {start} onward "
                    f"({len(results)} seeds trained)")
            break
        S = min(cap, n_seeds - start)
        sl = slice(start, start + S)
        betas, lams, scales = (None, None, None) if hypers is None else (
            hypers["betas"][sl], hypers["lams"][sl], hypers["lr_scales"][sl])
        with profiling.span("fit.init"):
            group_periods = [periods[(start + s) % len(periods)] for s in range(S)] if periods is not None else None
            params = init_params(spec, S, seed=seed + gi, phi_sigma=phi_sigma, omega_spread=omega_spread,
                                 periods=group_periods)
            if start > 0:
                # only global seed 0 keeps the reference init: later groups jitter
                # their member 0 too
                g_phi, g_omega = _generators(seed + 1000 + gi)
                params["phi"][0] *= 1.0 + phi_sigma * torch.randn((spec.r, spec.n), generator=g_phi)
                if omega_spread > 0.0:
                    u = torch.rand((3, spec.r), generator=g_omega)
                    params["omega"][0] *= 10.0 ** ((2.0 * u - 1.0) * omega_spread)
            params = {k: v.to(device) for k, v in params.items()}
            if device_mesh is not None:
                for t in params.values():  # rank 0's draws, so that the ranks cannot drift apart
                    device_mesh.broadcast(t)
            key = (S, None if betas is None else tuple(map(float, betas)), None if lams is None else tuple(map(float, lams)))
            if key not in chunk_cache:
                chunk = tc.select_ensemble_chunk(spec, cfg, S, device, betas=betas, lams=lams, device_mesh=device_mesh)
                if chunk is None and device_mesh is not None:
                    raise NotImplementedError(
                        f"desmo_tpu_torch does not run the packed eager loop over a device mesh (chunk_method="
                        f"{cfg.chunk_method!r}, loss_method={cfg.loss_method!r}, {S} seeds of preset {cfg.name!r}) yet "
                        "(ROADMAP queue 1, item 5.2: the eager path over a mesh)"
                    )
                chunk_cache[key] = chunk or make_ensemble_chunk(
                    build_loss(spec, cfg, S, method=method, betas=betas, lams=lams), groups, cfg, S)
            chunk = chunk_cache[key]
            state = init_state(params, cfg, S, lr_scales=scales)
            if device_mesh is not None:
                state = parallel.local_state(state, device_mesh)
        chunk_size = min(cfg.checkpoint_every, num_epochs)
        done = recoveries = 0
        histories = []
        frozen = np.zeros(S, bool)
        with profiling.span("fit.snapshot"):
            snap = _snapshot(state)
        with train.CheckpointWriter(checkpoint_fn) as writer:
            while done < num_epochs:
                nsteps = min(chunk_size, num_epochs - done)
                t_chunk = time.perf_counter()
                with profiling.span("fit.launch"):
                    state, mets = chunk(state, local_batch, nsteps)
                writer.launched()
                with profiling.span("fit.fetch"):
                    mets = _fetch(mets)
                    dt = time.perf_counter() - t_chunk
                    if id(chunk) in warmed:
                        wall += dt
                        steps_timed += nsteps * S  # seed-steps
                    else:
                        warmed.add(id(chunk))
                    mets.pop("max_arg", None)
                    tot_s = mets["total_s"]
                    finite = np.isfinite(tot_s).all()
                    if finite:
                        histories.append(mets)
                writer.poll()  # a failed write raises here, at the next boundary
                if not finite:
                    # a diverged seed is blamed at the first bad step; roll back,
                    # freeze the originators and re-run with the survivors
                    with profiling.span("fit.rollback"):
                        first_bad = int(np.argmin(np.isfinite(tot_s).all(axis=1)))
                        originators = ~np.isfinite(tot_s[first_bad])
                        recoveries += 1
                        if not (originators & ~frozen).any():
                            originators = np.ones(S, bool)  # unattributable
                        if (frozen | originators).all() or recoveries > max_recoveries:
                            why = " (recovery limit reached)" if recoveries > max_recoveries else " (every seed diverged)"
                            raise FloatingPointError(f"non-finite ensemble loss at epoch {done + first_bad}{why}")
                        profiling.count("ensemble.rollbacks")
                        profiling.count("ensemble.frozen_seeds", int((originators & ~frozen).sum()))
                        frozen |= originators
                        if log is not None:
                            log(f"WARNING: seed(s) {(start + np.nonzero(originators)[0]).tolist()} diverged at epoch "
                                f"{done + first_bad}; rolling back to epoch {done} and freezing them "
                                f"({int((~frozen).sum())} live seeds continue)")
                        state = _restore_with_frozen(snap, frozen)
                    continue
                done += nsteps
                with profiling.span("fit.snapshot"):
                    snap = _snapshot(state)
                if checkpoint_fn is not None:
                    with profiling.span("fit.checkpoint"):
                        # under a sweep the best live seed is the one of lowest rec
                        live = np.where(frozen, np.inf, (mets["rec"] if hypers is not None else tot_s)[-1])
                        # the gather is a collective over a mesh: on this thread;
                        # the host copy goes ahead of the next launch
                        writer.hand_off(whole(seed_state(state, cfg, int(np.argmin(live)))), int(state.epoch))
                if log is not None and (done % max(cfg.log_every, nsteps) == 0 or done == num_epochs):
                    with profiling.span("fit.log"):
                        log(f"[ensemble group {gi}] epoch {done}/{num_epochs} per-seed total: "
                            f"{np.array2string(mets['total_s'][-1], precision=6)}")
                if train.preemption_agreed(device_mesh):
                    # the checkpoint above saved the group's best live seed
                    preempted = True
                    if log is not None:
                        with profiling.span("fit.log"):
                            log(f"graceful preemption: group {gi} stopped at epoch {done} (of {num_epochs})")
                    break
            writer.drain()  # the group's last write, before its final state is used
        finals = np.where(frozen, np.inf, histories[-1]["total_s"][-1])
        recs = np.where(frozen, np.inf, histories[-1]["rec"][-1])
        sels = recs if hypers is not None else finals
        hist = {k: np.concatenate([h[k] for h in histories]) for k in histories[0]}
        state = whole(state)
        for s in range(S):
            results.append((float(finals[s]), float(sels[s]), start + s, state, s, hist))
            rec_by_seed[start + s] = float(recs[s])
            if report is not None and not frozen[s]:
                live_states.append((start + s, extract_seed(state.params, s)))
        start += S
        gi += 1

    if preempted:
        train.clear_preemption()  # one request stops one fit
    if report is not None:
        report["final_recs"] = [rec_by_seed[i] for i in sorted(rec_by_seed)]
        report["live_seeds"] = [i for i, _ in live_states]
        report["seed_params"] = [p for _, p in live_states]
    final_totals = np.asarray([r[0] for r in sorted(results, key=lambda r: r[2])])
    best_total, best_sel, best_global, best_state, best_local, best_hist = min(results, key=lambda r: (r[1], r[0]))
    if log is not None:
        with profiling.span("fit.log"):
            by = f"rec {best_sel:.8f}, " if hypers is not None else ""
            log(f"[ensemble] best seed = {best_global} ({by}total {best_total:.8f}; all: "
                f"{np.array2string(final_totals, precision=6)})")
            if hypers is not None:
                log(f"[ensemble] winning hypers: beta={hypers['betas'][best_global]:g} "
                    f"l1_lambda={hypers['lams'][best_global]:g} lr_scale={hypers['lr_scales'][best_global]:g}")
    history = {
        "rec": best_hist["rec"][:, best_local],
        "ortho": best_hist["ortho"][:, best_local],
        "l1": best_hist["l1"][:, best_local],
        "total": best_hist["total_s"][:, best_local],
    }
    sps = steps_timed / wall if wall > 0 and steps_timed else float("nan")
    result = train.TrainResult(
        state=seed_state(best_state, cfg, best_local), history=history, steps_per_sec=sps, preempted=preempted,
    )
    return result, best_global, final_totals
