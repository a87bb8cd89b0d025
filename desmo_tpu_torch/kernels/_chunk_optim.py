"""What the chunk kernels' wrappers share: the Adamax constants and step of
the kernels (``kernels.train_chunk``, ``kernels.ae_chunk``,
``kernels.shard_step``), the slots of their scheduler vector and its step
at the end of an epoch."""

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


def sched_step_(sv: torch.Tensor, total: torch.Tensor, cfg) -> None:
    """The end of an epoch on the scheduler vectors ``sv`` (S, SVEC), in
    place, given each seed's total (S,): the plateau step of each seed's LRs
    when ``epoch % sched_every == 0``, then ``b1^count``, the count and the
    epoch advanced (shared by the seeds)."""
    lrs = sv[:, _LR0:_LR0 + 5].clone()
    powb = sv[0, _POW] * B1
    best, num_bad, epoch = sv[:, _BEST].clone(), sv[:, _NUMBAD].clone(), sv[0, _EPOCH].clone()
    improved = total < best * (1.0 - SCHED_THRESHOLD)
    best_n = torch.where(improved, total, best)
    nb = torch.where(improved, torch.zeros_like(num_bad), num_bad + 1.0)
    red = nb > float(cfg.patience)
    stepped = torch.where(red[:, None], torch.clamp(lrs * float(cfg.sched_factor), min=float(cfg.sched_min_lr)), lrs)
    nb = torch.where(red, torch.zeros_like(nb), nb)
    do = torch.remainder(epoch, float(cfg.sched_every)) == 0.0
    sv[:, _LR0:_LR0 + 5] = torch.where(do, stepped, lrs)
    sv[:, _BEST] = torch.where(do, best_n, best)
    sv[:, _NUMBAD] = torch.where(do, nb, num_bad)
    sv[:, _POW] = powb
    sv[:, _COUNT] = sv[:, _COUNT] + 1.0
    sv[:, _EPOCH] = epoch + 1.0
