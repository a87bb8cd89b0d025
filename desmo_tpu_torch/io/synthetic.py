"""Synthetic unsteady-flow snapshot generators.

The reference's datasets (cylinder wake, ICA aneurysm, JHTDB channel) live on
an external scratch filesystem and are not shipped (``CYL:157``). For tests
and benchmarks we generate fields with the same structure the method targets:
a low-rank space-time-separable oscillatory part (vortex shedding and its
harmonics) plus optional broadband residual. Shapes default to the cylinder
case (n=3961, m=1001) so benchmark numbers are comparable to BASELINE.md.

The port's own copy of ``desmo_tpu.io.synthetic.cylinder_wake``;
``tests/test_torch_io.py`` holds the two equal bit for bit.
"""

from __future__ import annotations

import numpy as np


def cylinder_wake(
    n: int = 3961,
    m: int = 1001,
    n_harmonics: int = 3,
    noise: float = 0.0,
    seed: int = 0,
    dtype=np.float32,
    period_steps: float | None = None,
) -> np.ndarray:
    """Traveling-wave wake surrogate: X (n, m), temporal-mean-free.

    Each harmonic k contributes a standing-wave pair
    ``a_k [ sin(k s) g(s) sin(k w t), cos(k s) g(s) cos(k w t) ]`` — the
    classic POD structure of vortex shedding (paired modes per frequency),
    with a Gaussian spatial envelope g and 1/k^2 energy decay.

    ``period_steps``: fundamental shedding period in snapshot indices (e.g. 60
    to match the Fourier presets' ``period_init``); default keeps the historic
    ~100-step period.
    """
    rng = np.random.default_rng(seed)
    s = np.linspace(0.0, 8.0 * np.pi, n)
    envelope = np.exp(-(((s - s.mean()) / (0.35 * np.ptp(s))) ** 2))
    if period_steps is None:
        t = np.linspace(0.0, 20.0 * np.pi, m)
    else:
        t = 2.0 * np.pi * np.arange(m) / float(period_steps)
    x = np.zeros((n, m))
    w = 1.0
    for k in range(1, n_harmonics + 1):
        amp = 1.0 / k**2
        phase = rng.uniform(0, 2 * np.pi)
        sp1 = np.sin(k * s + phase) * envelope
        sp2 = np.cos(k * s + phase) * envelope
        x += amp * np.outer(sp1, np.sin(k * w * t))
        x += amp * np.outer(sp2, np.cos(k * w * t))
    if noise:
        x += noise * rng.standard_normal((n, m))
    x -= x.mean(axis=1, keepdims=True)
    return x.astype(dtype)
