"""Adamax and ReduceLROnPlateau with torch's semantics, as functions on
tensor state. Port of ``desmo_tpu/optim.py``.

The reference trains with ``torch.optim.Adamax`` over parameter groups whose
learning rates span 1e-3 to 1e3, plus ``ReduceLROnPlateau``. Here both are
plain functions so the trainer can run them on one packed parameter vector
with per-element learning rates gathered from the group-LR tensor; the
scheduler's state lives on the device and is stepped without a host sync
(no ``.item()``). ``tests/test_torch_optim_train.py`` holds both against
``torch.optim`` and ``desmo_tpu.optim``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class AdamaxState:
    count: int  # steps taken
    mu: torch.Tensor  # first-moment EMA, like the parameters
    nu: torch.Tensor  # infinity-norm buffer, like the parameters


def adamax_init(params: torch.Tensor) -> AdamaxState:
    return AdamaxState(0, torch.zeros_like(params), torch.zeros_like(params))


def adamax_update(
    grads: torch.Tensor,
    state: AdamaxState,
    lr: torch.Tensor | float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, AdamaxState]:
    """One Adamax step; returns ``(updates, new_state)``, applied as ``p + u``.

    torch's ``_single_tensor_adamax``:
        mu <- b1*mu + (1-b1)*g
        nu <- max(b2*nu, |g| + eps)
        p  <- p - lr/(1 - b1^t) * mu / nu
    ``lr`` broadcasts against the parameters (a scalar, or one LR per element).
    The bias correction is computed on the host in float32, as the JAX
    package computes it on the device."""
    count = state.count + 1
    bias = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    mu = b1 * state.mu + (1.0 - b1) * grads
    nu = torch.maximum(b2 * state.nu, grads.abs() + eps)
    updates = -(lr / bias) * mu / nu
    return updates, AdamaxState(count, mu, nu)


@dataclasses.dataclass
class PlateauState:
    """ReduceLROnPlateau state over the per-group learning rates."""

    lrs: torch.Tensor  # (num_groups,) in configs.GROUP_ORDER; (S, num_groups) per seed
    best: torch.Tensor  # best metric seen (0-d; (S,) per seed)
    num_bad: torch.Tensor  # int32 epochs since the last improvement (0-d; (S,) per seed)


def plateau_init(group_lrs, device: torch.device | str) -> PlateauState:
    return PlateauState(
        torch.as_tensor(np.asarray(group_lrs, np.float32), device=device),
        torch.tensor(float("inf"), dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def plateau_step(
    state: PlateauState,
    metric: torch.Tensor,
    patience: int,
    factor: float = 0.1,
    min_lr: float = 1e-6,
    threshold: float = 1e-4,
) -> PlateauState:
    """One scheduler step: mode='min', threshold_mode='rel', cooldown=0.

    Improvement means ``metric < best * (1 - threshold)``; after more than
    ``patience`` epochs without one, every group LR is multiplied by
    ``factor`` (clamped at ``min_lr``) and the counter resets. Over a seed
    axis (``lrs`` (S, G), ``best`` and ``num_bad`` (S,), ``metric`` (S,))
    each seed's row steps by its own metric, as the JAX package's
    ``jax.vmap`` of this step does (``desmo_tpu/ensemble.py:425-430``)."""
    metric = metric.detach().to(torch.float32)
    improved = metric < state.best * (1.0 - threshold)
    best = torch.where(improved, metric, state.best)
    num_bad = torch.where(improved, torch.zeros_like(state.num_bad), state.num_bad + 1)
    reduce = num_bad > patience
    lrs = torch.where(reduce.unsqueeze(-1), torch.clamp(state.lrs * factor, min=min_lr), state.lrs)
    num_bad = torch.where(reduce, torch.zeros_like(num_bad), num_bad)
    return PlateauState(lrs, best, num_bad)
