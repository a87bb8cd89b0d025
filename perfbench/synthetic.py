"""The benchmark's input X, made from the seed on the device.

A frozen copy of ``desmo_tpu_torch.io.synthetic.cylinder_wake`` (the default
~100-snapshot period, no noise) in torch: a travelling-wave wake of three
harmonics, each a standing-wave pair ``a_k [sin(k s) g(s) sin(k t), cos(k s)
g(s) cos(k t)]`` with a Gaussian envelope g and 1/k^2 energy, temporal-mean
free, built in float64 and served in float32. The seed draws each
harmonic's spatial phase (``numpy.random.default_rng(seed)``), so every
seed has the same sizes and spectrum and a different field.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def wake(n: int, m: int, seed: int, device, n_harmonics: int = 3) -> torch.Tensor:
    """X (n, m), float32 on ``device``."""
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=device)
    s = torch.linspace(0.0, 8.0 * math.pi, n, **f64)
    envelope = torch.exp(-(((s - s.mean()) / (0.35 * (s.max() - s.min()))) ** 2))
    t = torch.linspace(0.0, 20.0 * math.pi, m, **f64)
    x = torch.zeros((n, m), **f64)
    for k in range(1, n_harmonics + 1):
        amp = 1.0 / k**2
        phase = float(rng.uniform(0, 2 * math.pi))
        x += amp * torch.outer(torch.sin(k * s + phase) * envelope, torch.sin(k * t))
        x += amp * torch.outer(torch.cos(k * s + phase) * envelope, torch.cos(k * t))
    x -= x.mean(dim=1, keepdim=True)
    return x.to(torch.float32).contiguous()
