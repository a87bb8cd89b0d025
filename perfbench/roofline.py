"""The work of one DESMO epoch and the least time an H100 could take for it.

Frozen here so that the yardstick does not move with the program: the
operation count is a copy of ``chip_smoke.contraction_flops`` and
``chip_smoke.chunk_flops`` as of this benchmark, the peaks NVIDIA's data
sheet for the H100 SXM (dense, no sparsity, at the 700 W limit).

Every term of an epoch of the desmo form is a matrix product: AᵀX and X·Bᵀ
(2nmK' each, K' = S K the packed width), A·gb and ga·B over each seed's own
block (2nK'K and 2K'Km) and each seed's symmetric Grams AᵀA and BBᵀ (upper
triangles: nK(K+1) and mK(K+1)). They are counted at the TF32 tensor-core
peak, the fastest rate at which the card multiplies float32 inputs; no
implementation that keeps float32 grade can go faster (three TF32 passes, or
fp32 outside the tensor cores, are bounds of one implementation, not of the
chip). The Fourier form's series (20 operations per row, column and
harmonic) is elementwise and counted at the fp32 peak. The counts are those
these shapes need, at the model's K, not at a kernel's padded width.

Bytes: each input and output of a launch once (X, the POD modes, the state
read and written, the metrics written), spread over the launch's epochs: a
launch of thousands of epochs may keep X in the 50 MB L2 between epochs.
"""

from __future__ import annotations

PEAK_TF32 = 495e12  # FLOP/s, dense, tensor cores
PEAK_FP32 = 67e12  # FLOP/s, outside the tensor cores
PEAK_BYTES = 3.35e12  # B/s, HBM3


def num_terms(r: int, poly_order: int) -> int:
    """K: the polynomial terms in r variables up to degree P, and 3r trig."""
    from math import comb

    return sum(comb(r + d - 1, d) for d in range(poly_order + 1)) + 3 * r


def matrix_flops(n: int, m: int, k: int, seeds: int = 1) -> float:
    """Operations of one epoch's matrix products (``chip_smoke.chunk_flops``
    without the series term)."""
    kp = seeds * k
    return 2 * (2 * n * m * kp) + 2 * n * kp * k + 2 * kp * k * m + seeds * (n * k * (k + 1) + m * k * (k + 1))


def series_flops(m: int, k: int, nf: int, seeds: int = 1) -> float:
    """The Fourier form's series forward and backward, elementwise."""
    return 20 * seeds * k * m * nf


def launch_bytes(n: int, m: int, k: int, r: int, epochs: int, seeds: int = 1, nf: int = 0) -> float:
    """Bytes a launch of ``epochs`` epochs has to move at least: X and the
    POD modes read; phi, the temporal rows (or the series and periods), the
    coefficients and omega, each with both Adamax moments, read and
    written; five metrics per seed and epoch written."""
    kp = seeds * k
    temporal = kp * (2 * nf + 2) if nf else kp * m
    state = 3 * (seeds * r * n + temporal + kp + 3 * seeds * r)
    return 4.0 * (n * m + n * r + 2 * state + 5 * seeds * epochs)


def least_epoch_s(n: int, m: int, k: int, r: int, seeds: int = 1, nf: int = 0, epochs: int = 2000) -> float:
    """The least time of one epoch of ``seeds`` packed models in a launch of
    ``epochs`` epochs: the larger of the operations bound and the bytes
    bound."""
    ops = matrix_flops(n, m, k, seeds) / PEAK_TF32 + series_flops(m, k, nf, seeds) / PEAK_FP32
    return max(ops, launch_bytes(n, m, k, r, epochs, seeds, nf) / epochs / PEAK_BYTES)


def bound(n: int, m: int, k: int, r: int, seeds: int = 1, nf: int = 0, epochs: int = 2000) -> str:
    """Which bound sets :func:`least_epoch_s`: "operations" or "bytes"."""
    ops = matrix_flops(n, m, k, seeds) / PEAK_TF32 + series_flops(m, k, nf, seeds) / PEAK_FP32
    return "operations" if ops >= launch_bytes(n, m, k, r, epochs, seeds, nf) / epochs / PEAK_BYTES else "bytes"
