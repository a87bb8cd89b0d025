"""POD initialization on the host. Port of ``pod_host``, ``truncate`` and
``pod_relative_error`` from ``desmo_tpu/pod.py``.

``np.linalg.svd`` on the host gives the reference's exact mode signs, which
frozen masks of an imported checkpoint pair with. Results come back as
tensors on the given device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PODResult:
    """Rank-r POD of the snapshot matrix X (n, m)."""

    modes: torch.Tensor  # U[:, :r]  (n, r)
    temporal: torch.Tensor  # Vt[:r]  (r, m), unscaled
    singular_values: torch.Tensor  # S[:r]
    energy: torch.Tensor  # full normalized spectrum S^2 / sum(S^2)
    reconstruction: torch.Tensor  # U_r S_r Vt_r  (n, m)


def pod_host(x: np.ndarray, r: int, device: torch.device | str) -> PODResult:
    """Rank-r POD by ``np.linalg.svd`` on the host (the reference's signs)."""
    x = np.asarray(x, np.float32)
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    energy = (s * s) / np.sum(s * s)
    u_r, s_r, vt_r = u[:, :r], s[:r], vt[:r, :]
    recon = (u_r * s_r[None, :]) @ vt_r

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return PODResult(dev(u_r), dev(vt_r), dev(s_r), dev(energy), dev(recon))


def truncate(result: PODResult, r: int) -> PODResult:
    """Rank-r view of a rank-R factorization (r <= R): modes and singular
    values are prefixes; only the rank-r reconstruction is recomputed."""
    if r > result.modes.shape[1]:
        raise ValueError(f"cannot truncate rank-{result.modes.shape[1]} POD to r={r}")
    u_r = result.modes[:, :r].contiguous()
    s_r = result.singular_values[:r].contiguous()
    vt_r = result.temporal[:r, :].contiguous()
    return PODResult(u_r, vt_r, s_r, result.energy, (u_r * s_r[None, :]) @ vt_r)


def pod_relative_error(x: torch.Tensor, result: PODResult) -> float:
    """Relative Frobenius error of the rank-r POD reconstruction."""
    return float(torch.linalg.norm(x - result.reconstruction) / torch.linalg.norm(x))
