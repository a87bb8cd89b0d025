"""Snapshot-matrix preprocessing transforms.

Pure NumPy host-side functions mirroring the reference's L2 layer
(``DESMO/cylinder_flow/DESMO-Cylinder.py:88-191``; SURVEY §2.2). The snapshot
matrix convention throughout the framework is the reference's: ``X (n, m)``
with rows = spatial degrees of freedom ((u, v[, w]) interleaved per point for
vector fields) and columns = timesteps (``CYL:69-80``).

The port's own copy of ``desmo_tpu/data.py`` up to ``preprocess`` (the
streaming block variant is not ported); ``tests/test_torch_io.py`` holds the
two equal.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "drop_third_component",
    "to_magnitude",
    "subtract_temporal_mean",
    "rearrange_for_transpose",
    "subsample_time",
    "scale_inv_sqrt_m",
    "preprocess",
]


def drop_third_component(x: np.ndarray) -> np.ndarray:
    """Remove the w-velocity rows (every 3rd row) for planar 2D cases.

    Reference ``convert3Dto2D_data`` (``CYL:88-106``)."""
    keep = np.ones(x.shape[0], dtype=bool)
    keep[2::3] = False
    return x[keep]


def to_magnitude(x: np.ndarray, n_components: int) -> np.ndarray:
    """Per-point velocity magnitude: (n_components*p, m) -> (p, m).

    Reference ``convertToMagnitude`` (``CYL:109-133``): each snapshot column is
    reshaped to (p, d) point-major and reduced to sqrt(sum of squares).
    """
    n, m = x.shape
    if n % n_components:
        raise ValueError(f"rows {n} not divisible by n_components {n_components}")
    pts = x.reshape(n // n_components, n_components, m)
    return np.sqrt(np.sum(pts * pts, axis=1))


def subtract_temporal_mean(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Remove the row-wise temporal mean; returns (fluctuations, mean).

    Reference ``subtract_mean`` (``CYL:136-149``)."""
    mean = x.mean(axis=1)
    return x - mean[:, None], mean


def rearrange_for_transpose(x: np.ndarray, n_components: int = 2) -> np.ndarray:
    """Vector-valued (non-magnitude) training layout: (d*p, m) -> (p, d*m).

    Reference ``RearrangeDataForTranspose`` (``DESMO_AE/...py:129-159``): input
    rows are component-interleaved per point (u1, v1, u2, v2, ...); the output
    has one row per spatial point with columns interleaved per timestep
    (u(t1), v(t1), u(t2), v(t2), ...), so rows are comparable data points for
    the transpose-based temporal autoencoder.
    """
    n, m = x.shape
    if n % n_components:
        raise ValueError(f"rows {n} not divisible by n_components {n_components}")
    p = n // n_components
    return np.ascontiguousarray(
        x.reshape(p, n_components, m).transpose(0, 2, 1).reshape(p, m * n_components)
    )


def subsample_time(x: np.ndarray, stride: int) -> np.ndarray:
    """Keep every ``stride``-th snapshot (turbulent channel uses stride 2,
    ``DESMO/turbulent_channel/DESMO-TurbulentChannel.py:189``)."""
    return x[:, ::stride]


def scale_inv_sqrt_m(x: np.ndarray) -> np.ndarray:
    """Scale by 1/sqrt(m) — aneurysm normalization (``DESMO/aneurysm/
    DESMO_ICA_norm.py:143``)."""
    return x / np.sqrt(x.shape[1])


def preprocess(
    x: np.ndarray,
    dim: int = 2,
    magnitude: bool = True,
    mean_subtract: bool = True,
    time_stride: int = 1,
    inv_sqrt_m: bool = False,
    components_in: int = 3,
) -> tuple[np.ndarray, np.ndarray | None]:
    """The reference's standard preprocessing pipeline, flag-for-flag and in
    the reference's order (``CYL:169-191``): [3D->2D strip if dim==2 on
    3-component data] -> magnitude -> temporal-mean subtraction (aneurysm's
    1/sqrt(m) scaling happens inside it, ``DESMO_ICA_norm.py:143-147``, with
    the mean returned *unscaled*) -> temporal subsampling LAST (the channel
    strides after mean subtraction, ``...TurbulentChannel.py:182-189``).

    ``components_in`` declares how many components per point the input rows
    interleave (3 for the VTK readers' output) — dropping the w rows is only
    valid on declared 3-component data, never inferred from divisibility.
    Returns (X, temporal mean or None)."""
    if dim == 2 and components_in == 3:
        x = drop_third_component(x)
        components_in = 2
    if magnitude:
        x = to_magnitude(x, components_in)
    elif components_in > 1:
        x = rearrange_for_transpose(x, components_in)
    mean = None
    if mean_subtract:
        x, mean = subtract_temporal_mean(x)
    if inv_sqrt_m:
        x = scale_inv_sqrt_m(x)
    if time_stride > 1:
        x = subsample_time(x, time_stride)
    return np.ascontiguousarray(x, dtype=np.float32), mean
