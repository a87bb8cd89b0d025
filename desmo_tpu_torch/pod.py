"""POD initialization, on the host or on the device. Port of
``desmo_tpu/pod.py``: ``pod_host``, ``pod`` (the method of snapshots, the
full SVD and the randomized range finder), ``truncate``,
``pod_relative_error``, ``rank_sweep``, ``sign_align`` and
``canonical_signs``.

``np.linalg.svd`` on the host (:func:`pod_host`) gives the reference's exact
mode signs, which frozen masks of an imported checkpoint pair with. The
device paths (:func:`pod`) compute the Gram and every product in full fp32
(``device.fp32_matmul``: TF32 off) and the small factorizations through
``torch.linalg``; the runner wraps them in :func:`canonical_signs`, so that a
run and the ``evaluate`` of its checkpoint rebuild the same signs. Results
are tensors on the given device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from desmo_tpu_torch import device as device_mod


@dataclasses.dataclass(frozen=True)
class PODResult:
    """Rank-r POD of the snapshot matrix X (n, m)."""

    modes: torch.Tensor  # U[:, :r]  (n, r)
    temporal: torch.Tensor  # Vt[:r]  (r, m), unscaled
    singular_values: torch.Tensor  # S[:r]
    energy: torch.Tensor  # normalized spectrum S^2 / sum(S^2) (randomized: k entries over ||X||_F^2)
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


def _as_device(x, device) -> torch.Tensor:
    """X as a float32 tensor on ``device``; when None, a tensor's own device
    and the card for an array (``device.resolve``: it raises without one)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device, dtype=torch.float32)
    if device is None:
        device = device_mod.resolve("cuda")
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)


def _svd(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The thin SVD ``(U, S, Vt)``; on the card through cuSOLVER's QR-based
    ``gesvd``: the default driver left the singular values of aneurysm's
    27000x1000 X 9.4e-5 from the host's on an H100 (``chip_smoke.py``
    phase 12p), where 1e-5 is asked."""
    if x.device.type == "cuda":
        return torch.linalg.svd(x, full_matrices=False, driver="gesvd")
    return torch.linalg.svd(x, full_matrices=False)


def _method_of_snapshots(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(U, S, Vt)`` from the (m, m) Gram ``XᵀX = V S² Vᵀ`` and ``U = X V / S``,
    the singular values descending; a zero singular value divides by 1."""
    evals, v = torch.linalg.eigh(x.T @ x)  # ascending
    evals, v = torch.flip(evals, (0,)), torch.flip(v, (1,))
    s = torch.sqrt(torch.clamp(evals, min=0.0))
    safe = torch.where(s > 0, s, torch.ones_like(s))
    return x @ (v / safe[None, :]), s, v.T


def pod(
    x,
    r: int,
    method: str = "auto",
    oversample: int = 8,
    n_iter: int = 2,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> PODResult:
    """Rank-r POD of X (n, m) on ``device`` (by default X's own for a
    tensor, the card for an array).

    ``method``: 'auto' (the method of snapshots when n > m, else 'svd'),
    'snapshots', 'svd' (``torch.linalg.svd``, ``gesvd`` on the card) or 'randomized'
    (:func:`randomized_pod`; ``oversample``, ``n_iter`` and ``seed`` apply to
    it alone). ``temporal`` is ``Vt[:r]``, unscaled; ``reconstruction`` is
    ``U_r S_r Vt_r``. The signs are those of the factorization: wrap the
    result in :func:`canonical_signs` for a convention that the data alone
    fixes."""
    device_mod.fp32_matmul()
    x = _as_device(x, device)
    n, m = x.shape
    if method == "auto":
        method = "snapshots" if n > m else "svd"
    if method == "randomized":
        return randomized_pod(x, r, oversample=oversample, n_iter=n_iter, seed=seed)
    if method == "snapshots":
        u, s, vt = _method_of_snapshots(x)
    elif method == "svd":
        u, s, vt = _svd(x)
    else:
        raise ValueError(f"unknown POD method {method!r}")
    energy = (s * s) / torch.sum(s * s)
    u_r, s_r, vt_r = u[:, :r].contiguous(), s[:r].contiguous(), vt[:r, :].contiguous()
    return PODResult(u_r, vt_r, s_r, energy, (u_r * s_r[None, :]) @ vt_r)


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
    x = _as_device(x, result.reconstruction.device)
    return float(torch.linalg.norm(x - result.reconstruction) / torch.linalg.norm(x))


def rank_sweep(x, max_r: int, method: str = "auto",
               device: torch.device | str | None = None) -> list[tuple[int, float]]:
    """The relative reconstruction error at every rank 1..max_r from one
    factorization (the AE script's mode-count sweep)."""
    full = pod(x, max_r, method=method, device=device)
    xd = _as_device(x, full.modes.device)
    return [(r, pod_relative_error(xd, truncate(full, r))) for r in range(1, max_r + 1)]


def _cholesky_qr2(y: torch.Tensor) -> torch.Tensor:
    """Orthonormalize the tall sketch Y (n, k) by two rounds of shifted
    CholeskyQR: each round a Gram ``YᵀY``, a k x k Cholesky and a product
    with the factor's inverse. The diagonal shift is the smallest of 1e-6,
    1e-3 and 1e-1 times the mean diagonal whose Cholesky factors finitely (a
    sketch wider than X's numerical rank makes the unshifted one fail); the
    second round restores the orthogonality the shift costs."""
    k = y.shape[1]
    eye = torch.eye(k, dtype=y.dtype, device=y.device)
    for _ in range(2):
        g = y.T @ y
        tr = torch.trace(g) / k
        factors = []
        for shift in (1e-6, 1e-3, 1e-1):
            l, info = torch.linalg.cholesky_ex(g + (shift * tr) * eye)
            factors.append((l, info))
        l = factors[-1][0]
        for li, info in factors[-2::-1]:
            if int(info) == 0 and bool(torch.isfinite(li).all()):
                l = li
        y = y @ torch.linalg.inv(l).T
    return y


def randomized_pod(x, r: int, oversample: int = 8, n_iter: int = 2, seed: int = 0,
                   device: torch.device | str | None = None) -> PODResult:
    """Rank-r POD by a randomized range finder (Halko, Martinsson and Tropp),
    for X whose (m, m) Gram costs too much: the sketch ``Y = X Ω`` with
    k = r + oversample columns, ``n_iter`` power iterations ``Y <- X (Xᵀ Q)``
    each orthonormalized by :func:`_cholesky_qr2`, then the SVD of the small
    ``B = Qᵀ X`` lifted back through Q. Ω is drawn from a CPU
    ``torch.Generator`` seeded with ``seed`` and moved to the device, so the
    CPU and the card sketch with the same numbers (not those of
    ``jax.random``). ``energy`` has k entries, normalized by ``||X||_F²``."""
    device_mod.fp32_matmul()
    x = _as_device(x, device)
    n, m = x.shape
    k = min(m, n, r + oversample)
    if r > k:
        raise ValueError(f"rank r={r} exceeds sketch width k={k}")
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    omega = torch.randn((m, k), generator=gen, dtype=torch.float32).to(x.device)
    q = _cholesky_qr2(x @ omega)
    for _ in range(n_iter):
        q = _cholesky_qr2(x @ (x.T @ q))
    ub, s, vt = _svd(q.T @ x)
    u = q @ ub
    energy = (s * s) / torch.sum(x * x)
    u_r, s_r, vt_r = u[:, :r].contiguous(), s[:r].contiguous(), vt[:r, :].contiguous()
    return PODResult(u_r, vt_r, s_r, energy, (u_r * s_r[None, :]) @ vt_r)


def _flipped(result: PODResult, flip: torch.Tensor) -> PODResult:
    """``result`` with mode j and its temporal row times ``flip[j]`` (±1);
    the reconstruction does not change."""
    return PODResult(
        modes=result.modes * flip[None, :],
        temporal=result.temporal * flip[:, None],
        singular_values=result.singular_values,
        energy=result.energy,
        reconstruction=result.reconstruction,
    )


def sign_align(result: PODResult, reference_modes) -> PODResult:
    """Flip the modes (and their temporal rows) whose inner product with the
    matching column of ``reference_modes`` (n, r') is negative."""
    ref = _as_device(reference_modes, result.modes.device)
    dots = torch.sum(result.modes * ref[:, : result.modes.shape[1]], dim=0)
    return _flipped(result, torch.where(dots < 0, -1.0, 1.0).to(result.modes.dtype))


def canonical_signs(result: PODResult) -> PODResult:
    """The sign convention that the data alone fixes: each mode flipped so
    that its entry of largest magnitude is positive (a tie goes to the lowest
    index). The runner applies it to every device POD, so that a run and the
    ``evaluate`` of its checkpoint pair frozen masks with the same signs."""
    idx = torch.argmax(torch.abs(result.modes), dim=0)
    picked = torch.gather(result.modes, 0, idx[None, :])[0]
    return _flipped(result, torch.where(picked < 0, -1.0, 1.0).to(result.modes.dtype))
