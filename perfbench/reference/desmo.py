"""Plain PyTorch reference of DESMO training: the POD start, the initial
parameters and one epoch (forward, loss, gradients by autograd, Adamax with
the L1 sign term, the plateau scheduler).

It follows the reference scripts' equations (``DESMO-Cylinder.py``,
``DESMO_ICA_norm.py``), written out again without the program: the
reconstruction is the direct product ``A @ B`` and the loss the mean of the
whole (n, m) residual, not the Gram form the kernels use; the gradients come
from autograd. It imports nothing of the measured package. Everything runs
in float32 with TF32 off; ``low=True`` rounds every matrix product's
operands to TF32 (10-bit mantissa, round to nearest, ties away, as
``cvt.rna.tf32.f32``), forward and backward: the control, the precision
one step below the configuration's.

A state is a dict: ``params``, ``mu``, ``nu`` (dicts of leaves ``phi``
(r, n), ``c`` (T,), ``z`` (T, m), ``z_trig`` (3, r, m), ``c_trig`` (3, r),
``omega`` (3, r)), ``count``, ``lrs`` (5,), ``best``, ``num_bad`` and
``epoch``; one model, no seed axis.

The interface every reference module gives the harness (``harness.py``,
``check.py``, ``control.py``), with ``config`` a configuration's whole
``run_config``: ``LEAVES`` (the state's leaves, as the program's
``TrainState`` names them), ``LATENT_LEAVES``, ``PERIOD_LEAVES``,
``ROW_LEAVES`` (those with an entry per row of X, last axis),
``GRAD_GROUPS``, ``ORTHO_RELATIVE`` (``check.py`` says what they do), ``METRICS``
(the terms ``loss`` returns, ``total`` among them, as the program's chunk
names them), ``LATENT_FROM_POD`` (whether the program's batch carries the
POD modes), ``B1``, ``full_fp32()``, ``pod_modes(x, r, low)``,
``seed_params(config, n_seeds, seed, device)``, ``initial_state(params,
group_lrs)``, ``epoch(state, x, modes, config, beta, lam, low)``, ``loss(params,
x, modes, config, beta, lam, low)`` and ``pt_params(state_dict)`` (the
leaves of an exported ``.pt``). ``epoch`` and ``loss`` take n and m from X
(a fault may hand them part of its rows), ``seed_params`` from ``config``.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

LEAVES = ("phi", "c", "z", "z_trig", "c_trig", "omega")
# each leaf's optimizer group, as index into the config's (lr_coef, lr_phi,
# lr_z, lr_omega, lr_period)
GROUP = {"c": 0, "c_trig": 0, "phi": 1, "z": 2, "z_trig": 2, "omega": 3}
# the leaves the latents, and so ortho's Gram, depend on
LATENT_LEAVES = ("phi",)
# the Fourier variant's learnable periods, none here
PERIOD_LEAVES = ()
ROW_LEAVES = ("phi",)
# the latents are the POD modes times the masks
LATENT_FROM_POD = True
# groups of leaves whose first gradients ``check.compare`` measures apart,
# each against its own median leaf: none here
GRAD_GROUPS: dict = {}
# ortho, a sum of |Gram entries| that starts at rounding noise, by its
# absolute gap
ORTHO_RELATIVE = False
METRICS = ("rec", "ortho", "l1", "total")
KINDS = ("sin", "cos", "tanh")
B1, B2, EPS = 0.9, 0.999, 1e-8
PLATEAU_THRESHOLD = 1e-4


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32: the low 13 mantissa bits cleared, to nearest,
    ties away from zero."""
    bits = t.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _MatmulTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return tf32(g) @ tf32(b).T, tf32(a).T @ tf32(g)


def matmul(a: torch.Tensor, b: torch.Tensor, low: bool) -> torch.Tensor:
    return _MatmulTF32.apply(a, b) if low else a @ b


def full_fp32() -> None:
    """Matrix products in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def monomials(r: int, poly_order: int) -> list[tuple[int, ...]]:
    """The library's polynomial terms, as tuples of mode indices: degree
    ascending, and within a degree in ``itertools.combinations_with_replacement``
    order (the reference scripts' order, which the coefficients follow)."""
    return [t for d in range(poly_order + 1) for t in itertools.combinations_with_replacement(range(r), d)]


def num_terms(r: int, poly_order: int) -> int:
    return len(monomials(r, poly_order)) + 3 * r


def pod_modes(x: torch.Tensor, r: int, low: bool = False) -> torch.Tensor:
    """The leading ``r`` left singular vectors of X (n, m), float32 (n, r).
    In float32 by the SVD on the host (``numpy.linalg.svd``, as the
    reference scripts take it); with ``low``, by the method of snapshots
    with the Gram XᵀX in TF32, the control's POD."""
    if not low:
        u, _, _ = np.linalg.svd(x.detach().cpu().numpy().astype(np.float32), full_matrices=False)
        return torch.as_tensor(np.ascontiguousarray(u[:, :r]), device=x.device)
    gram = matmul(x.T, x, True)
    evals, evecs = torch.linalg.eigh(gram.double())
    order = torch.argsort(evals, descending=True)[:r]
    v = evecs[:, order].to(torch.float32)
    s = torch.sqrt(torch.clamp(evals[order], min=0.0)).to(torch.float32)
    return matmul(x, v, True) / s[None, :]


def initial_params(config: dict, device) -> dict:
    """The reference scripts' init: every mask, coefficient and temporal row
    one, omega at ``omega_init``."""
    n, m, r = config["n"], config["m"], config["r"]
    T = len(monomials(r, config["poly_order"]))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "phi": torch.ones((r, n), **f32),
        "c": torch.ones((T,), **f32),
        "z": torch.ones((T, m), **f32),
        "z_trig": torch.ones((3, r, m), **f32),
        "c_trig": torch.ones((3, r), **f32),
        "omega": torch.full((3, r), float(config["omega_init"]), **f32),
    }


def jittered(base: dict, config: dict, n_seeds: int, seed: int, device) -> list[dict]:
    """``n_seeds`` packed seeds of a multi-start drawn from ``seed``, from
    the reference init ``base`` (on the CPU): seed 0 ``base``, seed s >= 1
    its masks times (1 + sigma N(0, 1)), sigma ``seed_phi_sigma``, the
    normal draws from a CPU ``torch.Generator`` seeded with the first of two
    words of ``numpy.random.SeedSequence(seed)`` (the documented recipe of
    ``run --seeds``)."""
    r, n = base["phi"].shape
    phi_sigma = config["seed_phi_sigma"]
    out = [{k: v.clone() for k, v in base.items()} for _ in range(n_seeds)]
    if n_seeds > 1 and phi_sigma > 0.0:
        word = np.random.SeedSequence(seed).generate_state(2, np.uint64)[0]
        noise = phi_sigma * torch.randn((n_seeds - 1, r, n), generator=torch.Generator().manual_seed(int(word)))
        for s in range(1, n_seeds):
            out[s]["phi"] = out[s]["phi"] * (1.0 + noise[s - 1])
    return [{k: v.to(device) for k, v in p.items()} for p in out]


def seed_params(config: dict, n_seeds: int, seed: int, device) -> list[dict]:
    """The initial parameters of ``n_seeds`` packed seeds drawn from
    ``seed`` (:func:`jittered` of :func:`initial_params`)."""
    return jittered(initial_params(config, "cpu"), config, n_seeds, seed, device)


def initial_state(params: dict, group_lrs) -> dict:
    return {
        "params": {k: v.clone() for k, v in params.items()},
        "mu": {k: torch.zeros_like(v) for k, v in params.items()},
        "nu": {k: torch.zeros_like(v) for k, v in params.items()},
        "count": 0,
        "lrs": torch.as_tensor(np.asarray(group_lrs, np.float32)),
        "best": float("inf"),
        "num_bad": 0,
        "epoch": 0,
    }


def dictionary(params: dict, modes: torch.Tensor, poly_order: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(A (n, K), latent (n, r))``: the polynomial library of the latent
    ``modes * phiᵀ`` times c, then sin, cos and tanh of ``omega * latent``
    times c_trig, kind-major."""
    lat = modes * params["phi"].T
    n, r = lat.shape
    cols = []
    for term in monomials(r, poly_order):
        col = torch.ones_like(lat[:, 0])
        for v in term:
            col = col * lat[:, v]
        cols.append(col)
    theta = torch.stack(cols, dim=1) * params["c"][None, :]
    args = params["omega"][:, :, None] * lat.T[None, :, :]
    trig = torch.stack([torch.sin(args[0]), torch.cos(args[1]), torch.tanh(args[2])]) * params["c_trig"][:, :, None]
    return torch.cat([theta, trig.reshape(3 * r, n).T], dim=1), lat


def temporal(params: dict) -> torch.Tensor:
    """The temporal matrix B (K, m): the free rows ``z ‖ z_trig``."""
    r = params["phi"].shape[0]
    return torch.cat([params["z"], params["z_trig"].reshape(3 * r, -1)], dim=0)


def objective(params: dict, b_of, x: torch.Tensor, modes: torch.Tensor, poly_order: int, beta: float, lam: float,
              low: bool = False) -> tuple[torch.Tensor, dict]:
    """``total = mean((A B - X)^2) + beta ortho + lam l1`` and its terms, with
    B ``b_of(params)`` (K, m): ortho the sum of |latentᵢ · latentⱼ| over
    i < j, l1 the sum of |c| and |c_trig|."""
    a, lat = dictionary(params, modes, poly_order)
    resid = matmul(a, b_of(params), low) - x
    rec = torch.mean(resid * resid)
    gram = matmul(lat.T, lat, low)
    ortho = torch.triu(torch.abs(gram), diagonal=1).sum()
    l1 = torch.abs(params["c"]).sum() + torch.abs(params["c_trig"]).sum()
    total = rec + beta * ortho + lam * l1
    return total, {"rec": rec, "ortho": ortho, "l1": l1, "total": total}


def loss(params: dict, x: torch.Tensor, modes: torch.Tensor, config: dict, beta: float, lam: float,
         low: bool = False) -> tuple[torch.Tensor, dict]:
    """:func:`objective` with B the free temporal rows (:func:`temporal`)."""
    return objective(params, temporal, x, modes, config["poly_order"], beta, lam, low)


def step(state: dict, loss_fn, config: dict, leaves=LEAVES, group=GROUP) -> tuple[dict, dict, dict]:
    """One epoch from ``state`` with ``loss_fn(params) -> (total, metrics)``
    over ``leaves``, each stepped with its ``group``'s LR: returns
    ``(metrics, grads, new_state)`` with the metrics of the parameters
    before the update (floats), the gradient of the total as the optimizer
    takes it, and the state after Adamax (torch's ``Adamax``: bias
    ``1 - b1^t``, ``nu = max(b2 nu, |g| + eps)``) with the group LRs in
    force before this epoch's scheduler step, and the plateau scheduler
    (torch's ``ReduceLROnPlateau``, mode min, relative threshold 1e-4)
    stepped with the total when ``epoch % sched_every == 0`` (``config``'s
    ``patience``, ``sched_factor``, ``sched_min_lr`` and ``sched_every``)."""
    params = {k: state["params"][k].detach().clone().requires_grad_(True) for k in leaves}
    total, mets = loss_fn(params)
    grads = dict(zip(leaves, torch.autograd.grad(total, [params[k] for k in leaves])))
    count = state["count"] + 1
    bias = 1.0 - B1 ** count
    new = {"params": {}, "mu": {}, "nu": {}}
    with torch.no_grad():
        for k in leaves:
            g = grads[k]
            mu = B1 * state["mu"][k] + (1.0 - B1) * g
            nu = torch.maximum(B2 * state["nu"][k], torch.abs(g) + EPS)
            lr = float(state["lrs"][group[k]])
            new["params"][k] = params[k].detach() - (lr / bias) * mu / nu
            new["mu"][k], new["nu"][k] = mu, nu
    value = float(total.detach())
    lrs, best, num_bad = state["lrs"].clone(), state["best"], state["num_bad"]
    if state["epoch"] % config["sched_every"] == 0:
        if value < best * (1.0 - PLATEAU_THRESHOLD):
            best, num_bad = value, 0
        else:
            num_bad += 1
        if num_bad > config["patience"]:
            lrs = torch.clamp(lrs * config["sched_factor"], min=config["sched_min_lr"])
            num_bad = 0
    new.update(count=count, lrs=lrs, best=best, num_bad=num_bad, epoch=state["epoch"] + 1)
    return {k: float(v.detach()) for k, v in mets.items()}, {k: g.detach() for k, g in grads.items()}, new


def epoch(state: dict, x: torch.Tensor, modes: torch.Tensor, config: dict, beta: float, lam: float,
          low: bool = False) -> tuple[dict, dict, dict]:
    """One epoch of :func:`loss` from ``state`` (:func:`step`)."""
    return step(state, lambda p: loss(p, x, modes, config, beta, lam, low), config)


def stacked(sd: dict, prefix: str) -> np.ndarray:
    """The tensors ``{prefix}.0``, ``{prefix}.1``, ... of a state dict, stacked."""
    items = []
    while f"{prefix}.{len(items)}" in sd:
        items.append(sd[f"{prefix}.{len(items)}"].numpy())
    return np.stack(items)


def per_channel(sd: dict, prefix: str, r: int) -> np.ndarray:
    """The scalars ``{prefix}.{3i+k}`` as (3, r): kind k of mode i."""
    return np.array([[float(sd[f"{prefix}.{3 * i + k}"]) for i in range(r)] for k in range(3)], np.float32)


def pt_params(sd: dict) -> dict:
    """The leaves of an exported ``.pt`` in the reference scripts' key scheme
    (``phi_list.i``, ``c_coef``, ``z_list.t``, ``z{kind}_list.i``,
    ``{kind}_coef_list.i``, ``omega_list.{3i+k}``), as arrays."""
    phi = stacked(sd, "phi_list")
    r = phi.shape[0]
    return {
        "phi": phi, "c": sd["c_coef"].numpy(), "z": stacked(sd, "z_list"),
        "z_trig": np.stack([stacked(sd, f"z{k}_list") for k in KINDS]),
        "c_trig": np.array([[float(sd[f"{k}_coef_list.{i}"]) for i in range(r)] for k in KINDS], np.float32),
        "omega": per_channel(sd, "omega_list", r),
    }
