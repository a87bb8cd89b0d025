"""DESMOFourier: temporal coefficients as learnable truncated Fourier series.
Port of ``desmo_tpu/models/fourier.py``.

Each temporal channel (every polynomial term and every trig channel) owns
``2*nF + 1`` series coefficients and a learnable period:

    z(t) = a0 + sum_{k=1..nF} a_k cos(2 pi k t / T) + b_k sin(2 pi k t / T)

evaluated on ``t_points = linspace(0, m, m)`` (endpoint included, step
m/(m-1): the reference's quirk, kept). Every channel's series is one batched
product over a shared (nF, m) angle grid.

The parameters are those of ``models/desmo.py`` with the temporal ones
replaced:

============  ============  ===============================================
key           shape         meaning
============  ============  ===============================================
z             (T, 2nF+1)    series coefficients [a0, a1, b1, a2, b2, ...]
period        (T,)          learnable periods of the polynomial channels
z_trig        (3, r, 2nF+1) series coefficients of the trig channels
trig_period   (3, r)        learnable periods of the trig channels
============  ============  ===============================================
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from desmo_tpu_torch import losses
from desmo_tpu_torch.kernels import dual_gemm
from desmo_tpu_torch.models import desmo as desmo_model

Params = dict[str, torch.Tensor]
TWO_PI = np.float32(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class FourierSpec(desmo_model.DesmoSpec):
    n_fourier: int = 10
    period_init: float = 60.0


def t_points(m: int) -> np.ndarray:
    """``torch.linspace(0, m, m)``: m points, endpoint included, float32."""
    return np.linspace(0.0, float(m), m, dtype=np.float32)


class Fourier(nn.Module):
    """DESMOFourier parameters with the reference's all-ones init: series
    coefficients 1, periods ``spec.period_init``, omega ``spec.omega_init``.
    The keys come in the JAX package's order."""

    def __init__(self, spec: FourierSpec, device: torch.device | str = "cpu"):
        super().__init__()
        T, r, n = spec.num_poly_terms, spec.r, spec.n
        ncoef = 2 * spec.n_fourier + 1
        f32 = dict(dtype=torch.float32, device=device)
        self.phi = nn.Parameter(torch.ones((r, n), **f32))
        self.c = nn.Parameter(torch.ones((T,), **f32))
        self.z = nn.Parameter(torch.ones((T, ncoef), **f32))
        self.period = nn.Parameter(torch.full((T,), spec.period_init, **f32))
        self.z_trig = nn.Parameter(torch.ones((3, r, ncoef), **f32))
        self.trig_period = nn.Parameter(torch.full((3, r), spec.period_init, **f32))
        self.c_trig = nn.Parameter(torch.ones((3, r), **f32))
        self.omega = nn.Parameter(torch.full((3, r), spec.omega_init, **f32))

    def params(self) -> Params:
        return dict(self.named_parameters())


def fourier_series_batch(coeffs: torch.Tensor, period: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Every channel's series at once: coefficients (..., 2nF+1) in the order
    [a0, a1, b1, a2, b2, ...] and periods (...,) give (..., m)."""
    n_terms = (coeffs.shape[-1] - 1) // 2
    harmonics = torch.arange(1, n_terms + 1, dtype=t.dtype, device=t.device)
    angle = (harmonics * torch.as_tensor(TWO_PI, device=t.device))[:, None] * t[None, :]  # (nF, m)
    angle = angle[None, ...] / period.reshape(-1)[:, None, None]  # (C, nF, m)
    flat = coeffs.reshape(-1, coeffs.shape[-1])
    out = (
        flat[:, 0:1]
        + torch.einsum("ck,ckm->cm", flat[:, 1::2], torch.cos(angle))
        + torch.einsum("ck,ckm->cm", flat[:, 2::2], torch.sin(angle))
    )
    return out.reshape(*coeffs.shape[:-1], t.shape[0])


def period_candidates(
    x: np.ndarray,
    period_init: float,
    n_candidates: int = 4,
    pod_modes: np.ndarray | None = None,
    max_rows: int = 512,
) -> list[float]:
    """Fundamental-period candidates for a period multi-start, read off the
    data's power spectrum: ``period_init`` first, then ``mult / f_peak`` for
    mult = 1, 2, 3 (the peak may be any harmonic of the fundamental), in
    snapshot-index units, at most ``n_candidates``."""
    if not np.isfinite(period_init):
        raise ValueError(f"period_init must be finite, got {period_init}")
    xa = np.asarray(x, np.float32)
    if pod_modes is not None:
        sig = np.asarray(pod_modes).T @ xa  # (r, m) temporal coefficients
    else:
        step = max(1, xa.shape[0] // max_rows)
        sig = xa[::step]
    sig = sig - sig.mean(axis=1, keepdims=True)
    power = np.abs(np.fft.rfft(sig, axis=1)) ** 2
    spectrum = power.sum(axis=0)
    spectrum[0] = 0.0  # DC
    k_peak = int(np.argmax(spectrum))
    # a non-positive period_init is no usable candidate (t -> 2 pi t / period)
    out = [float(period_init)] if period_init > 0.0 else []
    if k_peak > 0:
        base = float(xa.shape[1]) / k_peak  # cycles of k_peak over the m-index window
        for mult in (1, 2, 3):
            c = base * mult
            if not any(abs(c - o) / o < 0.05 for o in out):
                out.append(c)
    return out[:n_candidates]


def temporal_values(params: Params, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The series materialized: z (T, m) and z_trig (3, r, m)."""
    z = fourier_series_batch(params["z"], params["period"], t)
    z_trig = fourier_series_batch(params["z_trig"], params["trig_period"], t)
    return z, z_trig


def temporal_matrix(params: Params, t: torch.Tensor) -> torch.Tensor:
    """``B (T + 3r, m)`` from the series, rows matching A's columns."""
    z, z_trig = temporal_values(params, t)
    return torch.cat([z, z_trig.reshape(-1, z.shape[-1])], dim=0)


def apply(
    params: Params,
    pod_modes: torch.Tensor,
    spec: FourierSpec,
    factors: torch.Tensor | None = None,
    t: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full reconstruction ``(recon (n, m), latent (n, r), z (T, m))``: the
    desmo contraction once the series are materialized."""
    if factors is None:
        factors = desmo_model.factor_tensor(spec, pod_modes.device)
    if t is None:
        t = torch.as_tensor(t_points(spec.m), device=pod_modes.device)
    A, latent = desmo_model.spatial_dictionary(params, pod_modes, factors)
    B = temporal_matrix(params, t)
    return A @ B, latent, B[: params["z"].shape[0]]


def build_loss(spec: FourierSpec, beta: float, l1_lambda: float, method: str = "factored"):
    """The desmo objective with B from the series; ``method`` as in
    ``models.desmo.build_loss`` (``fused`` through the dual-contraction
    kernel)."""
    if method not in ("factored", "fused", "direct"):
        raise ValueError(f"unknown loss method {method!r}")
    by_device: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def loss_fn(params: Params, batch: dict):
        pod_modes = batch["pod_modes"]
        consts = by_device.get(pod_modes.device)
        if consts is None:
            consts = by_device[pod_modes.device] = (
                desmo_model.factor_tensor(spec, pod_modes.device),
                torch.as_tensor(t_points(spec.m), device=pod_modes.device),
            )
        factors, t = consts
        A, latent = desmo_model.spatial_dictionary(params, pod_modes, factors)
        B = temporal_matrix(params, t)
        x_sq = batch.get("x_sq")
        if method == "fused":
            if x_sq is None:
                x_sq = torch.sum(batch["x"] * batch["x"])
            rec = dual_gemm.factored_mse_fused(A, B, batch["x"], x_sq)
        elif method == "factored":
            rec = losses.factored_mse(A, B, batch["x"], x_sq)
        else:
            rec = losses.mse(A @ B, batch["x"])
        ortho = losses.orthogonality(latent)
        l1 = losses.sparsity_l1(params)
        total = rec + beta * ortho + l1_lambda * l1
        return total, {"rec": rec, "ortho": ortho, "l1": l1}

    return loss_fn


param_groups = desmo_model.param_groups
