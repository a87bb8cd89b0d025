"""Term energies and threshold sweeps for the desmo, Fourier and AE variants.
Port of ``desmo_tpu/sparsify.py:46-239``.

Every candidate term contributes a rank-1 space-time field
``c_t * theta_t(x) z_t(s)ᵀ``, whose Frobenius norm factorizes into
``|c_t| * ||theta_t|| * ||z_t||``, so all T + 3r energies are column norms.
A sweep zeroes the sparsity coefficients whose energy falls below each
threshold, re-infers, and reports the relative error and the number of
surviving terms.
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
    ae = _is_ae(params)
    # the AE variant reconstructs from X through its encoder, the others
    # from the POD modes
    source = batch["x"] if ae else batch["pod_modes"]
    if energies is None:
        latent = ae_model.encode_decode(params, batch["x"])[0] if ae else None
        energies = term_energies(params, spec, latent_override=latent)
    factors = desmo_model.factor_tensor(spec, source.device)
    apply = ae_model.apply if ae else fourier_model.apply if _is_fourier(params) else desmo_model.apply
    results = []
    for threshold in thresholds:
        pruned = zero_below_threshold(params, energies, float(threshold))
        recon = apply(pruned, source, spec, factors)[0]
        error = float(losses.relative_frobenius_error(batch["x"], recon))
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
