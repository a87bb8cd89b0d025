"""Plain PyTorch reference of DESMOFourier training: the POD start, the
initial parameters and one epoch, as ``reference/desmo.py`` has them, with
the temporal side of the Fourier variant.

It follows the equations of the reference script
``DESMO_Fourier/cylinder_flow/DESMO-Cylinder.py`` (the ``DESMOFourier``
model, ``fourier_series``, its optimizer groups and scheduler), written out
again without the program. Each temporal channel (every polynomial term and
every sin/cos/tanh channel) owns the truncated series

    z(t) = a0 + sum_{k=1..nF} a_k cos(2 pi k t / T) + b_k sin(2 pi k t / T)

with its own learnable period T, on ``t = linspace(0, m, m)`` in float32
(endpoint included). Each harmonic's angle is formed directly, in the
script's order, left to right: ``(2 pi k) * t`` (the Python float ``2 pi
k`` times the float32 ``t``), then over T, each step rounded to float32;
cosine and sine of that angle. The angle reaches about 1,050 rad at t = m,
k = 10, T = 60, where the float32 spacing is 1.2e-4 rad: the program, which
forms ``(2 pi t) * (1 / T)`` once and the harmonics by a recurrence, rounds
differently, and the periods' gradient, a sum over t of terms that grow
with the angle, amplifies that rounding (measured: each side's gradient
equals the float64 gradient taken at its own float32 angles). The spatial side, the loss (the direct
(n, m) residual, ortho, l1), autograd, Adamax with the L1 sign term and the
plateau rule are ``reference/desmo.py``'s; the periods take Adamax steps in
their own group, ``lr_period``. Everything runs in float32 with TF32 off;
``low=True`` rounds every matrix product's operands to TF32, the control.
It imports nothing of the measured package.

Departures from the script, each kept out of what the comparison judges:
t is the points j m / (m - 1) rounded once to float32 (formed in float64),
where the script's ``torch.linspace(0, m, m)`` forms them in float32 and
lands one float32 step off at 393 of 1,001 points, which moves the
periods' float64 gradient by about 7e-4 of itself (n = 400, m = 1001):
that would measure torch's linspace, not the program; the series is summed
as ``a0``, then ``+ (a_k cos + b_k sin)`` for k = 1,
2, ... (the script's loop order; the grouping of its additions is assumed);
B is one (K, m) matrix, the polynomial channels' rows then the trig
channels' kind-major, where the script adds the trig part as separate
outer products (the same sums, regrouped); the latent Gram's upper triangle
is ortho, as ``reference/desmo.py`` has it; no period multi-start (off in
the published run).

Leaves: ``phi`` (r, n), ``c`` (T,), ``z`` (T, 2nF+1) the series
coefficients ``[a0, a1, b1, a2, b2, ...]``, ``period`` (T,), ``z_trig``
(3, r, 2nF+1), ``trig_period`` (3, r), ``c_trig`` (3, r), ``omega`` (3, r).
The number of harmonics evaluated is ``config["n_fourier"]``; coefficients
beyond it take no part in B.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import desmo
from perfbench.reference.desmo import (  # noqa: F401
    B1, GRAD_GROUPS, LATENT_FROM_POD, LATENT_LEAVES, METRICS, ORTHO_RELATIVE, ROW_LEAVES, full_fp32, initial_state,
    pod_modes,
)

LEAVES = ("phi", "c", "z", "period", "z_trig", "trig_period", "c_trig", "omega")
# each leaf's optimizer group, as index into the config's (lr_coef, lr_phi,
# lr_z, lr_omega, lr_period)
GROUP = dict(desmo.GROUP, period=4, trig_period=4)
PERIOD_LEAVES = ("period", "trig_period")


def t_points(m: int, device) -> torch.Tensor:
    """``linspace(0, m, m)`` in float32: the points j m / (m - 1), each
    rounded to float32 (formed in float64 on the host)."""
    return torch.linspace(0.0, float(m), m, dtype=torch.float64).to(torch.float32).to(device)


def series(coeffs: torch.Tensor, period: torch.Tensor, t: torch.Tensor, nf: int) -> torch.Tensor:
    """Each channel's series at ``t``: coefficients (C, 2nF'+1), periods (C,)
    give (C, m), over the first ``nf`` harmonics."""
    acc = coeffs[:, 0:1].expand(-1, t.shape[0])
    for k in range(1, nf + 1):
        angle = ((2.0 * math.pi * k) * t)[None, :] / period[:, None]
        acc = acc + (coeffs[:, 2 * k - 1:2 * k] * torch.cos(angle) + coeffs[:, 2 * k:2 * k + 1] * torch.sin(angle))
    return acc


def initial_params(config: dict, device) -> dict:
    """The script's init: every mask, coefficient and series coefficient
    one, every period at ``period_init``, omega at ``omega_init``."""
    n, r, nc = config["n"], config["r"], 2 * config["n_fourier"] + 1
    T = len(desmo.monomials(r, config["poly_order"]))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "phi": torch.ones((r, n), **f32),
        "c": torch.ones((T,), **f32),
        "z": torch.ones((T, nc), **f32),
        "period": torch.full((T,), float(config["period_init"]), **f32),
        "z_trig": torch.ones((3, r, nc), **f32),
        "trig_period": torch.full((3, r), float(config["period_init"]), **f32),
        "c_trig": torch.ones((3, r), **f32),
        "omega": torch.full((3, r), float(config["omega_init"]), **f32),
    }


def seed_params(config: dict, n_seeds: int, seed: int, device) -> list[dict]:
    """The initial parameters of ``n_seeds`` packed seeds drawn from ``seed``
    (``desmo.jittered``: seeds >= 1 jitter the masks alone)."""
    return desmo.jittered(initial_params(config, "cpu"), config, n_seeds, seed, device)


def loss(params: dict, x: torch.Tensor, modes: torch.Tensor, config: dict, beta: float, lam: float,
         low: bool = False) -> tuple[torch.Tensor, dict]:
    """``desmo.objective`` with B the series of every channel at
    :func:`t_points` (X's m)."""
    t = t_points(x.shape[1], x.device)
    nf = config["n_fourier"]

    def b_of(p):
        r = p["phi"].shape[0]
        z = series(p["z"], p["period"], t, nf)
        z_trig = series(p["z_trig"].reshape(3 * r, -1), p["trig_period"].reshape(3 * r), t, nf)
        return torch.cat([z, z_trig], dim=0)

    return desmo.objective(params, b_of, x, modes, config["poly_order"], beta, lam, low)


def epoch(state: dict, x: torch.Tensor, modes: torch.Tensor, config: dict, beta: float, lam: float,
          low: bool = False) -> tuple[dict, dict, dict]:
    """One epoch of :func:`loss` from ``state`` (``desmo.step`` over
    :data:`LEAVES`, the periods in the ``lr_period`` group)."""
    return desmo.step(state, lambda p: loss(p, x, modes, config, beta, lam, low), config, LEAVES, GROUP)


def pt_params(sd: dict) -> dict:
    """``desmo.pt_params`` with the periods' keys ``period_list.t`` and
    ``trig_period_list.{3i+k}``."""
    out = desmo.pt_params(sd)
    return dict(out, period=desmo.stacked(sd, "period_list").reshape(-1),
                trig_period=desmo.per_channel(sd, "trig_period_list", out["phi"].shape[0]))
