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

The AE form (``ae_flops``, a copy of ``chip_smoke.ae_flops``; its bytes
those ``chip_smoke`` counts for an AE launch) is all matrix products, the
MLP's among them, counted at the TF32 peak as the others are.
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


# the AE form: the hidden widths of the encoder (the decoder mirrors them),
# and the kernel's scheduler vector (``kernels._chunk_optim.SVEC``)
AE_WIDTHS = (256, 128, 64, 16, 8, 4)
AE_SVEC = 16


def ae_flops(n: int, m: int, k: int) -> float:
    """Operations of one epoch of the AE kernel (r=2, K = k dictionary
    columns; ``chip_smoke.ae_flops``): the four products with X (X·W0,
    X·V6ᵀ, D6ᵀX, Xᵀ·dpre1), 2nm·256 each; the narrow layers (256->...->2 and
    2->...->256, 84,304 weights a row) forward, backward and for their
    weight gradients, 3 · 2n · 84,304; the symmetric D6ᵀD6 (n·256·257) and
    D6·VV (2n·256²); the symmetric V6V6ᵀ (m·256·257) and S_dd·V6 (2·256²·m);
    the dictionary's X·Bᵀ and AᵀX (2nmK each), A·gb (2nK²) and the symmetric
    Grams AᵀA and BBᵀ (nK(K+1) and mK(K+1))."""
    narrow = 84_304
    return (4 * 2 * n * m * 256 + 3 * 2 * n * narrow + n * 256 * 257 + 2 * n * 256 * 256 + m * 256 * 257
            + 2 * 256 * 256 * m + 4 * n * m * k + 2 * n * k * k + n * k * (k + 1) + m * k * (k + 1))


def ae_mlp_size(m: int, r: int = 2) -> int:
    """Entries of every MLP weight and bias, encoder and decoder."""
    enc = (m, *AE_WIDTHS, r)
    return 2 * sum(a * b for a, b in zip(enc, enc[1:])) + sum(enc[1:]) + sum(enc[:-1])


def ae_launch_bytes(n: int, m: int, k: int, epochs: int) -> float:
    """Bytes an AE launch of ``epochs`` epochs has to move at least
    (``chip_smoke``'s count): X and its column sums read; every MLP tensor,
    B, the coefficients, omega, each with both Adamax moments, and the
    scheduler vector, read and written; six metrics an epoch written."""
    state = 4 * 2 * (3 * ae_mlp_size(m) + 3 * k * m + 3 * k + 18 + AE_SVEC)
    return 4.0 * (n * m + m + 6 * epochs) + state


def ae_least_epoch_s(n: int, m: int, k: int, epochs: int = 2000) -> float:
    """The least time of one AE epoch in a launch of ``epochs`` epochs."""
    return max(ae_flops(n, m, k) / PEAK_TF32, ae_launch_bytes(n, m, k, epochs) / epochs / PEAK_BYTES)


def config_least_epoch_s(config: dict, seeds: int, epochs: int) -> float:
    """:func:`least_epoch_s`, or for the AE variant :func:`ae_least_epoch_s`,
    of one epoch of ``seeds`` packed models of a configuration's
    ``run_config`` in launches of ``epochs`` epochs."""
    k = num_terms(config["r"], config["poly_order"])
    if config["variant"] == "ae":
        return ae_least_epoch_s(config["n"], config["m"], k, epochs)
    return least_epoch_s(config["n"], config["m"], k, config["r"], seeds=seeds, nf=config["n_fourier"], epochs=epochs)

