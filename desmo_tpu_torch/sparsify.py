"""Term energies, threshold sweeps and greedy pruning for the desmo, Fourier
and AE variants. Port of ``desmo_tpu/sparsify.py:46-291``.

Every candidate term contributes a rank-1 space-time field
``c_t * theta_t(x) z_t(s)ᵀ``, whose Frobenius norm factorizes into
``|c_t| * ||theta_t|| * ||z_t||``, so all T + 3r energies are column norms.
A sweep zeroes the sparsity coefficients whose energy falls below each
threshold, re-infers, and reports the relative error and the number of
surviving terms; greedy pruning (the turbulent-channel reference,
``DESMO/turbulent_channel/DESMO-TurbulentChannel.py:1166-1245``) removes the
terms one at a time in ascending order of energy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from desmo_tpu_torch import library, losses
from desmo_tpu_torch.models import autoencoder as ae_model
from desmo_tpu_torch.models import desmo as desmo_model
from desmo_tpu_torch.models import fourier as fourier_model


@dataclasses.dataclass(frozen=True)
class TermEnergies:
    poly: np.ndarray  # (T,)
    trig: np.ndarray  # (3, r) kind-major (sin, cos, tanh)

    def interleaved_trig(self) -> np.ndarray:
        """The trig energies in the reference's order: sin(phi1), cos(phi1),
        tanh(phi1), sin(phi2), ..."""
        return np.asarray(self.trig).T.reshape(-1)


@dataclasses.dataclass
class SweepEntry:
    threshold: float
    error: float
    nonzero_terms: int


def _is_fourier(params: dict) -> bool:
    return "period" in params


def _is_ae(params: dict) -> bool:
    return "ae_enc_w0" in params


@torch.no_grad()
def term_energies(params: dict, spec, latent_override=None) -> TermEnergies:
    """Energy of every candidate term of a trained model.

    Kept from the reference: the library and trig bases are evaluated on the
    RAW phi masks, not on the POD-scaled modes of the forward pass; the
    reference's sweep tables are defined by this convention. For the Fourier
    variant the series are materialized on ``t_points``, and the reference's
    column-slice bug is kept too (``desmo_tpu/sparsify.py:71-78``): term i's
    temporal factor is the time slice ``z[:, i]``, not series i. The AE
    variant has no phi masks: pass its encoder latent as
    ``latent_override``."""
    latent = params["phi"].T if latent_override is None else latent_override  # (n, r)
    factors = torch.as_tensor(
        library.factor_table(latent.shape[1], spec.poly_order), dtype=torch.int64, device=latent.device
    )
    theta = library.eval_library(latent, factors)  # (n, T)
    if _is_fourier(params):
        t = torch.as_tensor(fourier_model.t_points(spec.m), device=latent.device)
        z, z_trig = fourier_model.temporal_values(params, t)
        z_norm = torch.linalg.norm(z[:, : params["c"].shape[0]], dim=0)
    else:
        z, z_trig = params["z"], params["z_trig"]
        z_norm = torch.linalg.norm(z, dim=1)
    poly = params["c"].abs() * torch.linalg.norm(theta, dim=0) * z_norm
    basis = desmo_model.trig_basis(latent, params["omega"])  # (3, r, n)
    trig = params["c_trig"].abs() * torch.linalg.norm(basis, dim=2) * torch.linalg.norm(z_trig, dim=2)
    return TermEnergies(poly=poly.cpu().numpy(), trig=trig.cpu().numpy())


def zero_below_threshold(params: dict, energies: TermEnergies, threshold: float) -> dict:
    """Zero the sparsity coefficients whose term energy is below ``threshold``."""
    out = dict(params)
    for key, e in (("c", energies.poly), ("c_trig", energies.trig)):
        below = torch.as_tensor(e < threshold, device=params[key].device)
        out[key] = torch.where(below, torch.zeros_like(params[key]), params[key])
    return out


def nonzero_terms(params: dict) -> int:
    """Count of surviving terms."""
    return int((params["c"] != 0).sum()) + int((params["c_trig"] != 0).sum())


def default_thresholds(lo: float = 4.0, hi: float = -3.0, step: float = -0.5) -> np.ndarray:
    """``10^-i for i in arange(lo, hi, step)`` — the cylinder sweep grid."""
    return np.asarray([10.0 ** (-i) for i in np.arange(lo, hi, step)])


def _recon_error_fn(params: dict, batch: dict, spec) -> Callable[[dict], float]:
    """``err(pruned)``: the relative Frobenius error of the reconstruction
    of X by ``pruned`` (``params`` with some coefficients zeroed): from the
    POD modes, or for the AE variant from X through its encoder."""
    ae = _is_ae(params)
    source = batch["x"] if ae else batch["pod_modes"]
    factors = desmo_model.factor_tensor(spec, source.device)
    apply = ae_model.apply if ae else fourier_model.apply if _is_fourier(params) else desmo_model.apply

    def err(pruned: dict) -> float:
        return float(losses.relative_frobenius_error(batch["x"], apply(pruned, source, spec, factors)[0]))

    return err


def _energies(params: dict, batch: dict, spec) -> TermEnergies:
    latent = ae_model.encode_decode(params, batch["x"])[0] if _is_ae(params) else None
    return term_energies(params, spec, latent_override=latent)


@torch.no_grad()
def threshold_sweep(
    params: dict,
    batch: dict,
    spec,
    thresholds: Optional[Sequence[float]] = None,
    energies: Optional[TermEnergies] = None,
    log: Optional[Callable[[str], None]] = None,
) -> list[SweepEntry]:
    """The reference's threshold table: error and surviving terms per threshold."""
    if thresholds is None:
        thresholds = default_thresholds()
    if energies is None:
        energies = _energies(params, batch, spec)
    err = _recon_error_fn(params, batch, spec)
    results = []
    for threshold in thresholds:
        pruned = zero_below_threshold(params, energies, float(threshold))
        error = err(pruned)
        count = nonzero_terms(pruned)
        results.append(SweepEntry(float(threshold), error, count))
        if log is not None:
            log(f"Threshold: {threshold}, Error: {error:.6f}, Nonzero Terms: {count}")
    if log is not None:
        log("\nSummary of Results:")
        log(f"{'Threshold':<10} {'Error':<15} {'Nonzero Terms':<15}")
        for e in results:
            log(f"{e.threshold:<10.1e} {e.error:<15.6f} {e.nonzero_terms:<15}")
    return results


def greedy_order(energies: TermEnergies) -> list[tuple[float, str, object]]:
    """The terms in ascending order of energy, ``(energy, kind, index)``
    with kind 'poly' (index t) or 'trig' (index (k, i)), tied as the
    reference ties them: the polynomial terms first in index order, then per
    latent i its sin, cos and tanh, and a stable sort keeps that order among
    equal energies (``...TurbulentChannel.py:1173-1190``)."""
    order: list[tuple[float, str, object]] = [(float(e), "poly", t) for t, e in enumerate(energies.poly)]
    r = energies.trig.shape[1]
    for i in range(r):
        for k in range(3):
            order.append((float(energies.trig[k, i]), "trig", (k, i)))
    order.sort(key=lambda entry: entry[0])
    return order


@torch.no_grad()
def greedy_prune(
    params: dict,
    batch: dict,
    spec,
    energies: Optional[TermEnergies] = None,
    log: Optional[Callable[[str], None]] = None,
) -> list[SweepEntry]:
    """Remove the terms one at a time in :func:`greedy_order`, re-inferring
    at each step; entry k of the result (``threshold`` = k) has the k terms
    of lowest energy removed, so there are T + 3r + 1 entries."""
    if energies is None:
        energies = _energies(params, batch, spec)
    order = greedy_order(energies)
    err = _recon_error_fn(params, batch, spec)
    c0, ct0 = params["c"], params["c_trig"]
    results = []
    for step in range(len(order) + 1):
        c, ct = c0.clone(), ct0.clone()
        for _, kind, idx in order[:step]:
            if kind == "poly":
                c[idx] = 0.0
            else:
                ct[idx] = 0.0
        pruned = dict(params, c=c, c_trig=ct)
        error = err(pruned)
        count = nonzero_terms(pruned)
        results.append(SweepEntry(float(step), error, count))
        if log is not None:
            log(f"Step: {step}, Error: {error:.6f}, Nonzero Terms: {count}")
    return results
