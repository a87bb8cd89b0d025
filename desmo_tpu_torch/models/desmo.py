"""The core DESMO model. Port of ``desmo_tpu/models/desmo.py``.

Parameters keep the JAX package's keys and shapes, so weights move between the
two packages by name (``checkpoint.params_from_jax``):

==========  ===========  =============================================
key         shape        meaning
==========  ===========  =============================================
phi         (r, n)       multiplicative masks on the POD modes
c           (T,)         polynomial sparsity coefficients
z           (T, m)       temporal coefficients of the polynomial terms
z_trig      (3, r, m)    temporal coefficients of sin/cos/tanh terms
c_trig      (3, r)       trig sparsity coefficients
omega       (3, r)       trig frequencies
==========  ===========  =============================================

The trig kind axis is (sin, cos, tanh), ``library.TRIG_KINDS``. The model
functions take a ``params`` dict of tensors (``dict(model.named_parameters())``)
and the frozen POD modes; the whole reconstruction is one product
``A (n, T+3r) @ B (T+3r, m)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from desmo_tpu_torch import library, losses
from desmo_tpu_torch.kernels import dual_gemm

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DesmoSpec:
    """Static architecture description (shapes and hyper-structure only)."""

    n: int  # spatial points
    m: int  # snapshots
    r: int  # number of modes
    poly_order: int
    omega_init: float = 10000.0

    @property
    def num_poly_terms(self) -> int:
        return library.num_poly_terms(self.r, self.poly_order)

    @property
    def num_trig_terms(self) -> int:
        return 3 * self.r

    def factor_table(self) -> np.ndarray:
        return library.factor_table(self.r, self.poly_order)


class Desmo(nn.Module):
    """DESMO parameters with the reference's all-ones init (omega at
    ``spec.omega_init``)."""

    def __init__(self, spec: DesmoSpec, device: torch.device | str = "cpu"):
        super().__init__()
        T, r, n, m = spec.num_poly_terms, spec.r, spec.n, spec.m
        f32 = dict(dtype=torch.float32, device=device)
        self.phi = nn.Parameter(torch.ones((r, n), **f32))
        self.c = nn.Parameter(torch.ones((T,), **f32))
        self.z = nn.Parameter(torch.ones((T, m), **f32))
        self.z_trig = nn.Parameter(torch.ones((3, r, m), **f32))
        self.c_trig = nn.Parameter(torch.ones((3, r), **f32))
        self.omega = nn.Parameter(torch.full((3, r), spec.omega_init, **f32))

    def params(self) -> Params:
        """The parameters by key, the form every model function takes."""
        return dict(self.named_parameters())


def effective_modes(params: Params, pod_modes: torch.Tensor) -> torch.Tensor:
    """Learnable masks on frozen POD modes: ``latent (n, r) = pod * phiᵀ``."""
    return pod_modes * params["phi"].T


def trig_basis(latent: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Nonlinear spatial basis ``(3, r, n)``: row k, mode i is
    ``f_k(omega[k, i] * latent[:, i])`` for f = (sin, cos, tanh)."""
    args = omega[:, :, None] * latent.T[None, :, :]  # (3, r, n)
    return torch.stack([torch.sin(args[0]), torch.cos(args[1]), torch.tanh(args[2])])


def spatial_dictionary(
    params: Params, pod_modes: torch.Tensor, factors: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(A (n, T + 3r), latent (n, r))``: columns 0..T-1 are the c-scaled
    polynomial library, columns T.. the coefficient-scaled trig terms in
    kind-major order (matching z rows). ``factors`` is the int64 factor table
    on ``pod_modes``' device."""
    latent = effective_modes(params, pod_modes)
    theta_c = library.eval_library(latent, factors) * params["c"][None, :]
    basis = trig_basis(latent, params["omega"])  # (3, r, n)
    g = (params["c_trig"][:, :, None] * basis).reshape(-1, latent.shape[0]).T
    return torch.cat([theta_c, g], dim=1), latent


def temporal_matrix(params: Params) -> torch.Tensor:
    """Stacked temporal coefficients ``B (T + 3r, m)``, rows matching A's columns."""
    z_trig = params["z_trig"].reshape(-1, params["z_trig"].shape[-1])
    return torch.cat([params["z"], z_trig], dim=0)


def factor_tensor(spec: DesmoSpec, device: torch.device | str) -> torch.Tensor:
    return torch.as_tensor(spec.factor_table(), dtype=torch.int64, device=device)


def apply(
    params: Params, pod_modes: torch.Tensor, spec: DesmoSpec, factors: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full reconstruction: ``(recon (n, m), latent (n, r), z (T, m))``."""
    if factors is None:
        factors = factor_tensor(spec, pod_modes.device)
    A, latent = spatial_dictionary(params, pod_modes, factors)
    return A @ temporal_matrix(params), latent, params["z"]


def build_loss(spec: DesmoSpec, beta: float, l1_lambda: float, method: str = "factored"):
    """Composite training loss ``loss_fn(params, batch) -> (total, metrics)``.

    ``batch = {'x': X (n, m), 'pod_modes': (n, r)[, 'x_sq': sum(X*X)]}``;
    metrics are ``{'rec', 'ortho', 'l1'}``. ``method``:

    * ``factored`` — the MSE through Gram products, without the (n, m)
      reconstruction (``losses.factored_mse``);
    * ``fused`` — the same value through the dual-contraction kernel
      (``kernels.dual_gemm.FactoredMSEFused``): one read of X per step and an
      X-free backward;
    * ``direct`` — materializes the reconstruction like the reference.
    """
    if method not in ("factored", "fused", "direct"):
        raise ValueError(f"unknown loss method {method!r}")
    factors_by_device: dict[torch.device, torch.Tensor] = {}

    def loss_fn(params: Params, batch: dict):
        pod_modes = batch["pod_modes"]
        factors = factors_by_device.get(pod_modes.device)
        if factors is None:
            factors = factors_by_device[pod_modes.device] = factor_tensor(spec, pod_modes.device)
        if method == "direct":
            recon, latent, _ = apply(params, pod_modes, spec, factors)
            rec = losses.mse(recon, batch["x"])
        else:
            A, latent = spatial_dictionary(params, pod_modes, factors)
            B = temporal_matrix(params)
            x_sq = batch.get("x_sq")
            if method == "fused":
                if x_sq is None:
                    x_sq = torch.sum(batch["x"] * batch["x"])
                rec = dual_gemm.factored_mse_fused(A, B, batch["x"], x_sq)
            else:
                rec = losses.factored_mse(A, B, batch["x"], x_sq)
        ortho = losses.orthogonality(latent)
        l1 = losses.sparsity_l1(params)
        total = rec + beta * ortho + l1_lambda * l1
        return total, {"rec": rec, "ortho": ortho, "l1": l1}

    return loss_fn


_GROUP_OF = {
    "phi": "phi",
    "c": "coef",
    "c_trig": "coef",
    "z": "z",
    "z_trig": "z",
    "omega": "omega",
    # the Fourier variant's learnable periods
    "period": "period",
    "trig_period": "period",
}


def param_groups(params: Params) -> dict[str, str]:
    """Optimizer group per parameter key, mirroring the reference's LR
    groups: coef (c, c_trig), phi, z (z, z_trig), omega and, for the Fourier
    variant, period (period, trig_period)."""
    return {k: _GROUP_OF[k] for k in params}
