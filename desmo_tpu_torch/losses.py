"""Loss terms for DESMO training. Port of ``desmo_tpu/losses.py``.

    total = MSE(recon, X) + beta * ortho(latent) + l1_lambda * L1(coefs)

``ortho`` is the sum of |phi_i . phi_j| over mode pairs i < j; L1 covers the
sparsity coefficients (c and c_trig) only. Matrix products run in full fp32
(``device.fp32_matmul``).
"""

from __future__ import annotations

import torch


def mse(recon_nm: torch.Tensor, x_nm: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the full (n, m) snapshot matrix."""
    d = recon_nm - x_nm
    return torch.mean(d * d)


def factored_mse(
    a_nk: torch.Tensor,
    b_km: torch.Tensor,
    x_nm: torch.Tensor,
    x_sq: torch.Tensor | None = None,
) -> torch.Tensor:
    """``mean((A @ B - X)^2)`` without forming the (n, m) product:
    ``||AB||^2 = <AᵀA, BBᵀ>`` and ``<AB, X> = <AᵀX, B>``. ``x_sq`` is the
    precomputed ``sum(X*X)``."""
    ga = a_nk.T @ a_nk  # (K, K)
    gb = b_km @ b_km.T  # (K, K)
    ax = a_nk.T @ x_nm  # (K, m)
    if x_sq is None:
        x_sq = torch.sum(x_nm * x_nm)
    sq = torch.sum(ga * gb) - 2.0 * torch.sum(ax * b_km) + x_sq
    return sq / (x_nm.shape[0] * x_nm.shape[1])


def orthogonality(latent_nr: torch.Tensor) -> torch.Tensor:
    """Sum of |pairwise dot products| between effective modes (i < j)."""
    gram = latent_nr.T @ latent_nr  # (r, r)
    return torch.triu(gram.abs(), diagonal=1).sum()


def sparsity_l1(params: dict) -> torch.Tensor:
    """L1 norm of the sparsity coefficients (c plus all trig coefficients)."""
    total = params["c"].abs().sum()
    if "c_trig" in params:
        total = total + params["c_trig"].abs().sum()
    return total


def relative_frobenius_error(x_nm: torch.Tensor, recon_nm: torch.Tensor) -> torch.Tensor:
    """``||X - Xhat||_F / ||X||_F`` — the reference's headline metric."""
    return torch.linalg.norm(x_nm - recon_nm) / torch.linalg.norm(x_nm)


def per_snapshot_relative_error(x_nm: torch.Tensor, recon_nm: torch.Tensor) -> torch.Tensor:
    """Column-wise ``||x_j - xhat_j|| / ||x_j||``, the error at each snapshot
    (length m); the denominator is floored at 1e-30. The forecast records
    show with it how the error grows with the horizon."""
    num = torch.linalg.norm(x_nm - recon_nm, dim=0)
    den = torch.linalg.norm(x_nm, dim=0)
    return num / torch.clamp(den, min=1e-30)
