"""The comparison that decides ``correct``: what the program produced,
against the plain reference (``perfbench/reference/<name>.py``, named by the
configuration's file). A reference module provides ``LEAVES`` (the state's
leaves), ``LATENT_LEAVES`` (those the latents depend on: the desmo masks, or
the AE variant's encoder), ``PERIOD_LEAVES`` (the Fourier variant's periods,
or none), ``B1`` (Adamax's first decay), ``full_fp32()``, ``pod_modes(x, r,
low)``, ``seed_params(config, n_seeds, seed, device)``,
``initial_state(params, group_lrs)``, ``epoch(state, x, modes, config, beta,
lam, low)`` and ``loss(params, x, modes, config, beta, lam, low)``, where
``config`` is the configuration's whole ``run_config``
(``reference/desmo.py`` states what each returns, and the rest of the
interface, which the harness and the control read).

The program's outputs come in as plain data (``Observed``): X, its POD
modes, and for each packed seed the states before and after each of the
set-up's first epochs (dicts in the reference's state format, on the host)
with the metrics the program reported for them; then what the window left:
the first epochs of its first launch, checkpoints read back from disk, the
state the fit returned, the metrics it recorded. Each number below is a gap
between the program and the reference, held to the cell's limit
(``perfbench/limits/<cell>.json``):

- ``pod``: the largest gap of the program's POD modes from the reference's,
  over the largest mode entry (each mode's sign is a convention: the
  reference's mode takes the program's sign);
- ``init``: the largest gap of the initial parameters (exact);
- ``loss``: the largest relative gap of rec, l1 and total (and of the AE
  variant's decoder term ae, whose ``ae_beta`` of 1e-3 leaves a decoder
  fault all but unseen in total), for each of the set-up's first three
  epochs, each computed by the reference from the
  program's own state before it (at omega_init=1e4 two float32 orders part
  after about five epochs, so a reference left to run on its own for long
  measures that chaos, not the program);
- ``ortho``: the largest absolute gap of ortho (a sum of |Gram entries| of
  unit-scale latents that starts at rounding noise); relative where the
  reference says ``ORTHO_RELATIVE`` (the AE variant's, a product of the two
  latents' squared norms, which spans 8e-8 to 2e-2 from seed to seed at the
  init and grows by orders within three epochs);
- ``grad``: the worst leaf's gap between the norms of the first gradient as
  the optimizer took it (the program's: its first moment after one step over
  ``1 - b1``) and the reference's, over the larger of that leaf's reference
  norm and the median leaf's, over the leaves but the Fourier variant's
  periods and the reference's ``GRAD_GROUPS``; each group of
  ``GRAD_GROUPS`` (the AE variant's ``grad_encoder`` and ``grad_decoder``,
  whose gradients lie 1e1-1e4 and 1e-9-1e-5 in norm against the library's
  1e-3-2) gives a number of its own, the same measure over its own leaves,
  against its own median leaf; ``grad_period`` the same over the periods (computed only where
  the reference has them): their gradient sums over t terms that grow with
  the series' angle, up to 1,050 rad, so it amplifies the float32 rounding
  of that angle, which each side forms in its own order (each equals the
  float64 gradient at its own float32 angles to 1e-5, and the two differ by
  2e-3 of each entry), and its limit is set against the faults;
- ``update``: the median, over the leaves the latents do not depend on,
  of each leaf's gap, by the same measure, between the norms of the
  parameters' change over the three epochs, the reference's summed from its
  steps out of the program's states (the worst leaf's gap is noise: omega's
  entries, stepped by 1e3 from 1e4, have gradients that are sums of
  cancelling terms, and where one lies near zero two sound float32 orders
  part on its change by up to 5e-4 of the leaf); ``update_phi`` the worst
  leaf's gap of phi, which they do:
  phi's first gradient carries ``beta`` times the sign of latent Gram
  entries that start at rounding noise, so its later Adamax steps differ
  between two sound float32 orders by as much as TF32 moves the other
  leaves, and its limit is set against the faults; ``update_period`` the
  same gap of the Fourier variant's periods (``period``, ``trig_period``;
  computed only where the reference has them): a period near 60 steps by
  about 0.01, so the float32 spacing of the period itself, 3.8e-6, is 4e-4
  of a step, and one rounding of the new period in another order moves the
  norm of a six-entry leaf's change by up to 5e-5; its limit too is set
  against the faults. Leaves whose reference gradient is under a thousandth
  of the median leaf's are left out (they move by round-off alone);
- ``launch``: the largest relative gap of rec, l1 and total over the first
  three epochs of the window's first launch (a launch of the checkpoint
  cadence's epochs, as every launch of the window), of the seed the fit
  reports, against the set-up's three one-epoch launches from the same
  initial state, which ``loss`` holds to the reference step by step; and
  ``launch_ortho`` the absolute gap of its ortho. The one-epoch launches
  cannot see a fault in the later epochs of a launch; this can. (The
  reference run on its own from the initial state cannot judge them: the
  program parts from it by up to 5e-5 at the third epoch and 3e-3 at the
  fifth, where this reads 0);
- ``window_loss``: the relative gap of rec, l1 and total of a state the
  window checkpointed, against the metrics the window's fit recorded for it
  (one-seed cells), and ``window_ortho`` the absolute gap of its ortho;
- ``checkpoint``: the last checkpoint the window wrote, read back, against
  the state the fit returned, exact.
"""

from __future__ import annotations

import dataclasses
import importlib
import statistics
from typing import Optional

import numpy as np
import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone under Adamax and is left out of ``update``
STILL_LEAF = 1e-3


@dataclasses.dataclass
class Observed:
    x: torch.Tensor  # (n, m) float32, the input both sides share
    modes: torch.Tensor  # (n, r) the program's POD modes
    states: list  # per seed, [s0, s1, s2, s3] reference-format states
    metrics: list  # per seed, [m1, m2, m3] dicts of rec, ortho, l1, total
    # (seed, [metrics of epoch 1, 2, 3]) of the window's first launch
    launch: list = dataclasses.field(default_factory=list)
    window: list = dataclasses.field(default_factory=list)  # (state params, metrics dict) pairs
    checkpoint: Optional[tuple] = None  # (read-back leaves, returned leaves): dicts of arrays


def reference_module(name: str):
    return importlib.import_module(f"perfbench.reference.{name}")


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def _loss_gaps(got: dict, want: dict, ortho_relative: bool = False) -> tuple[float, float]:
    """The largest relative gap of the terms of ``want`` but ortho (rec, l1,
    total, and the AE variant's ae), and the gap of ortho: absolute, or
    with ``ortho_relative`` relative."""
    rel = max(_rel(float(got[k]), want[k]) for k in want if k != "ortho")
    gap = abs(float(got["ortho"]) - want["ortho"])
    return rel, gap / max(abs(want["ortho"]), 1e-30) if ortho_relative else gap


def _norm_gaps(prog: dict, ref: dict, leaves) -> dict:
    """Each leaf's gap between the norms, over the larger of the leaf's
    reference norm and the median leaf's."""
    p = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in leaves}
    r = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in leaves}
    med = statistics.median(r.values())
    return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in leaves}


def _max_gap(a: dict, b: dict) -> float:
    gap = 0.0
    for k in b:
        va, vb = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        if va.shape != vb.shape:
            return float("inf")
        if va.size:
            with np.errstate(invalid="ignore"):
                same = (va == vb) | (np.isnan(va) & np.isnan(vb))
                d = np.where(same, 0.0, np.abs(va - vb))
            gap = max(gap, float(np.nan_to_num(d, nan=np.inf).max()))
    return gap


def signed_like(modes: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``modes`` with each column's sign that of ``like``'s."""
    sign = torch.sign(torch.sum(modes * like, dim=0))
    sign[sign == 0] = 1.0
    return modes * sign[None, :]


def pod_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap between two sets of modes of one sign, over the
    largest entry of ``want``."""
    return float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want)))


def compare(obs: Observed, config: dict, hypers: list, reference: str, seed: int, leaves: dict = None) -> dict:
    """The numbers compared, by name. ``config`` is the configuration's
    ``run_config``; ``hypers`` each seed's (beta, lambda); ``seed`` the run's
    seed, from which the reference draws the packed seeds' initial
    parameters again."""
    ref = reference_module(reference)
    ref.full_fp32()
    x = obs.x
    r = obs.modes.shape[1]
    inits = ref.seed_params(config, len(obs.states), seed, "cpu")
    want = signed_like(ref.pod_modes(x, r), obs.modes)
    out: dict = {"pod": pod_gap(obs.modes, want)}
    init_gap = loss_gap = ortho_gap = grad_gap = grad_period_gap = update_gap = phi_gap = period_gap = 0.0
    apart = ref.LATENT_LEAVES + ref.PERIOD_LEAVES
    grouped = tuple(k for group in ref.GRAD_GROUPS.values() for k in group)
    group_gaps = dict.fromkeys(ref.GRAD_GROUPS, 0.0)
    for s, (states, mets) in enumerate(zip(obs.states, obs.metrics)):
        beta, lam = hypers[s]
        init_gap = max(init_gap, _max_gap({k: v.cpu() for k, v in states[0]["params"].items()},
                                          inits[s]))
        steps = []
        for k in range(3):
            dev_state = _to(states[k], x.device)
            m_ref, g_ref, nxt = ref.epoch(dev_state, x, want, config, beta, lam)
            lg, og = _loss_gaps(mets[k], m_ref, ref.ORTHO_RELATIVE)
            loss_gap, ortho_gap = max(loss_gap, lg), max(ortho_gap, og)
            steps.append((dev_state, g_ref, nxt))
        g0 = steps[0][1]
        g_prog = {k: states[1]["mu"][k].to(x.device) / (1.0 - ref.B1) for k in ref.LEAVES}
        grads = _norm_gaps(g_prog, g0, ref.LEAVES)
        grad_gap = max([grad_gap] + [v for k, v in grads.items() if k not in ref.PERIOD_LEAVES + grouped])
        grad_period_gap = max([grad_period_gap] + [v for k, v in grads.items() if k in ref.PERIOD_LEAVES])
        for name, group in ref.GRAD_GROUPS.items():
            gaps = _norm_gaps(g_prog, g0, group)
            group_gaps[name] = max([group_gaps[name]] + list(gaps.values()))
            grads.update(gaps)
        norms = {k: float(torch.linalg.vector_norm(g0[k].double())) for k in ref.LEAVES}
        med = statistics.median(norms.values())
        moving = [k for k in ref.LEAVES if norms[k] >= STILL_LEAF * med]
        d_prog = {k: states[3]["params"][k].to(x.device) - states[0]["params"][k].to(x.device) for k in moving}
        d_ref = {k: sum(nxt["params"][k] - st["params"][k] for st, _, nxt in steps) for k in moving}
        updates = _norm_gaps(d_prog, d_ref, moving)
        rest = [v for k, v in updates.items() if k not in apart]
        update_gap = max([update_gap] + ([statistics.median(rest)] if rest else []))
        phi_gap = max([phi_gap] + [v for k, v in updates.items() if k in ref.LATENT_LEAVES])
        period_gap = max([period_gap] + [v for k, v in updates.items() if k in ref.PERIOD_LEAVES])
        if leaves is not None:
            for name, gaps in (("grad", grads), ("update", updates), ("grad_norm", norms)):
                for k, v in gaps.items():
                    leaves.setdefault(name, {})[k] = max(leaves.get(name, {}).get(k, 0.0), v)
    out.update(init=init_gap, loss=loss_gap, ortho=ortho_gap, grad=grad_gap, update=update_gap, update_phi=phi_gap)
    out.update(group_gaps)
    if ref.PERIOD_LEAVES:
        out.update(grad_period=grad_period_gap, update_period=period_gap)
    if obs.launch:
        lg = og = 0.0
        for s, got in obs.launch:
            for mets, setup in zip(got, obs.metrics[s]):
                a, b = _loss_gaps(mets, {k: float(v) for k, v in setup.items()}, ref.ORTHO_RELATIVE)
                lg, og = max(lg, a), max(og, b)
        out.update(launch=lg, launch_ortho=og)
    if obs.window:
        wl = wo = 0.0
        for params, mets in obs.window:
            beta, lam = hypers[0]
            with torch.no_grad():
                _, m_ref = ref.loss({k: v.to(x.device) for k, v in params.items()}, x, want, config, beta, lam)
            lg, og = _loss_gaps(mets, {k: float(v) for k, v in m_ref.items()}, ref.ORTHO_RELATIVE)
            wl, wo = max(wl, lg), max(wo, og)
        out.update(window_loss=wl, window_ortho=wo)
    if obs.checkpoint is not None:
        out["checkpoint"] = _max_gap(*obs.checkpoint)
    return out


def _to(state: dict, device) -> dict:
    out = dict(state)
    for tree in ("params", "mu", "nu"):
        out[tree] = {k: v.to(device) for k, v in state[tree].items()}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit. A number the cell has
    no limit for raises ``KeyError``; a limit for a number not computed
    fails the run; NaN fails."""
    compared = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        compared[name] = {"value": value, "limit": limit}
        ok = ok and bool(value <= limit)
    for name in numbers:
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
    return ok, compared
