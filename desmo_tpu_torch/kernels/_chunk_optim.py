"""What the chunk kernels' wrappers share: the Adamax constants and step of
the kernels (``kernels.train_chunk``, ``kernels.ae_chunk``), and the slots of
their scheduler vector."""

from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
SCHED_THRESHOLD = 1e-4
# scheduler-vector slots (floats, one row per seed)
_LR0, _BEST, _POW, _COUNT, _NUMBAD, _EPOCH, _BETA, _LAM = 0, 5, 6, 7, 8, 9, 10, 11
SVEC = 16


def _adamax_(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, g, lr, bias) -> None:
    """One Adamax step of the kernel, in place: ``mu = b1 mu + (1-b1) g``,
    ``nu = max(b2 nu, |g| + eps)``, ``p = p - (lr/bias) mu / nu``."""
    mu.copy_(B1 * mu + (1.0 - B1) * g)
    nu.copy_(torch.maximum(B2 * nu, g.abs() + EPS))
    p.copy_(p - (lr / bias) * mu / nu)
