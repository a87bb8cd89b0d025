"""Fused dual contraction ``(ax, xb) = (Aᵀ X, X Bᵀ)`` and the factored MSE
built on it. Port of ``desmo_tpu/pallas/dual_gemm.py``.

The factored loss' gradients are

    dL/dA = (2/nm) (A (B Bᵀ) - X Bᵀ)      dL/dB = (2/nm) ((AᵀA) B - Aᵀ X)

so both X-dependent products are known at forward time: the CUDA kernel
(``csrc/dual_gemm.cu``) forms both in one launch, and ``FactoredMSEFused``
keeps X out of the backward pass, so X is read in the forward pass only. X
stays fp32: the bf16 hi/lo split of the TPU kernel does not carry over (see
the note in the CUDA source).

``FactoredMSEFusedBlocks`` is the seed-packed form (``ensemble.py``): A (n,
S K) and B (S K, m) hold S models side by side, one read of X serves them
all, and the per-seed values (S,) come from each seed's own diagonal block of
the Grams.

``dual_contractions`` takes its plain twin (``dual_contractions_plain``) for
CPU tensors only. On a CUDA tensor it launches the kernel or raises; every
launch adds one to ``dual_contractions.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from desmo_tpu_torch import device as device_mod
from desmo_tpu_torch.kernels import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("dual_gemm")
    lib.desmo_dual_max_k.argtypes = []
    lib.desmo_dual_max_k.restype = ctypes.c_int
    lib.desmo_dual_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.desmo_dual_plan.restype = ctypes.c_int
    lib.desmo_dual_contractions.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.desmo_dual_contractions.restype = ctypes.c_int
    return lib


@functools.cache
def _plan(device_index: int, n: int, m: int, k: int) -> tuple[int, int, int, int]:
    """``(g_r, g_x, floats, xb_at)`` for this shape on this device: how many
    (K, m) partials of AᵀX and (n, K) partials of X·Bᵀ the kernel writes
    (none where 1; it sums each in a fixed order), the floats of the scratch
    that holds them (AᵀX's partials, then X·Bᵀ's; 0 where there are none),
    and where X·Bᵀ's partials start in it. Raises for K above the kernel's."""
    lib = _lib()
    if k > lib.desmo_dual_max_k():
        raise ValueError(f"dual_contractions: K={k} exceeds the kernel's {lib.desmo_dual_max_k()}")
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        rc = lib.desmo_dual_plan(n, m, k, out)
    if rc != 0:
        raise RuntimeError(f"dual_contractions: device query failed with CUDA error {rc}")
    gr, gx = out[0], out[1]
    xb_at = gr * k * m if gr > 1 else 0
    return gr, gx, xb_at + (gx * n * k if gx > 1 else 0), xb_at


def dual_contractions_plain(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor):
    """``(a.T @ x, x @ b.T)`` with ``torch.matmul`` in full fp32."""
    device_mod.fp32_matmul()
    return a.T @ x, x @ b.T


def _check(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b), ("x", x)):
        rows_apart = t.dim() == 2 and t.stride(1) == 1 and t.stride(0) >= t.shape[1]
        if t.dtype != torch.float32 or t.dim() != 2 or not (t.is_contiguous() or name == "x" and rows_apart):
            raise ValueError(
                f"dual_contractions: {name} must be a contiguous 2-D float32 tensor (x: or rows of "
                f"contiguous entries), got {t.dtype} {tuple(t.shape)} strides {t.stride()}"
            )
    n, k = a.shape
    if b.shape[0] != k or x.shape != (n, b.shape[1]):
        raise ValueError(
            f"dual_contractions: shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"x {tuple(x.shape)} do not form a (n, K), b (K, m), x (n, m)"
        )
    if not a.device == b.device == x.device:
        raise ValueError(
            f"dual_contractions: tensors on {a.device}, {b.device}, {x.device}"
        )


def dual_contractions(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor):
    """``(ax, xb) = (a.T @ x, x @ b.T)`` in one launch.

    a: (n, K), b: (K, m) contiguous, x: (n, m) contiguous or with its rows
    apart (``x.stride(0) >= m``; a stride that is a multiple of 4 lets the
    kernel copy X's rows 16 bytes at a time), float32 on one device; returns
    (K, m) and (n, K)."""
    _check(a, b, x)
    if x.device.type == "cpu":
        return dual_contractions_plain(a, b, x)
    if x.device.type != "cuda":
        raise ValueError(f"dual_contractions: unsupported device {x.device}")
    n, k = a.shape
    m = b.shape[1]
    gr, gx, floats, xb_at = _plan(x.device.index, n, m, k)
    # the outputs in one allocation (the launch is short, so the host's share
    # of a call counts); the partials in a scratch of their own, freed on
    # return, so that a caller who keeps ax or xb does not keep them
    out = torch.empty(k * m + n * k, dtype=torch.float32, device=x.device)
    ax, xb = out[:k * m].view(k, m), out[k * m:].view(n, k)
    part = torch.empty(floats, dtype=torch.float32, device=x.device) if floats else None
    args = (a.data_ptr(), b.data_ptr(), x.data_ptr(), x.stride(0), part.data_ptr() if gr > 1 else None,
            part.data_ptr() + 4 * xb_at if gx > 1 else None, ax.data_ptr(), xb.data_ptr(), n, m, k, gr, gx,
            torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        rc = _lib().desmo_dual_contractions(*args)
    else:
        with torch.cuda.device(x.device):
            rc = _lib().desmo_dual_contractions(*args)
    if rc != 0:
        raise RuntimeError(f"dual_contractions: kernel launch failed with CUDA error {rc}")
    dual_contractions.launches += 1
    return ax, xb


dual_contractions.launches = 0


class FactoredMSEFused(torch.autograd.Function):
    """``mean((a @ b - x)^2)`` with one fused read of x and an x-free backward.

    Port of ``factored_mse_fused``'s custom VJP. Saves only the (n, K),
    (K, m) and (K, K) residuals; x gets no gradient."""

    @staticmethod
    def forward(ctx, a, b, x, x_sq):
        device_mod.fp32_matmul()
        ax, xb = dual_contractions(a, b, x)
        ga = a.T @ a
        gb = b @ b.T
        nm = a.shape[0] * b.shape[1]
        val = (torch.sum(ga * gb) - 2.0 * torch.sum(ax * b) + x_sq) / nm
        ctx.save_for_backward(a, b, ax, xb, ga, gb)
        ctx.nm = nm
        return val

    @staticmethod
    def backward(ctx, g):
        a, b, ax, xb, ga, gb = ctx.saved_tensors
        scale = 2.0 * g / ctx.nm
        da = scale * (a @ gb - xb) if ctx.needs_input_grad[0] else None
        db = scale * (ga @ b - ax) if ctx.needs_input_grad[1] else None
        dx_sq = g / ctx.nm if ctx.needs_input_grad[3] else None
        return da, db, None, dx_sq


def factored_mse_fused(a, b, x, x_sq):
    """Functional form of :class:`FactoredMSEFused`."""
    return FactoredMSEFused.apply(a, b, x, x_sq)


def mse_blocks_value(a, b, ax, x_sq, nm, n_blocks):
    """Per-seed ``mean((A_s B_s - X)^2)`` (S,) from the packed A (n, S K), B
    (S K, m) and ``ax = AᵀX``, with each seed's Grams (S, K, K): a batched
    product over the seeds' own blocks, so no entry couples two seeds.
    Returns ``(values, ga, gb)``. Port of
    ``desmo_tpu.pallas.dual_gemm._mse_blocks_value``."""
    S = n_blocks
    n, k = a.shape
    K, m = k // S, b.shape[1]
    a3 = a.view(n, S, K).transpose(0, 1)  # (S, n, K)
    b3 = b.view(S, K, m)
    ga = a3.transpose(1, 2) @ a3
    gb = b3 @ b3.transpose(1, 2)
    cross = (ax * b).view(S, K, m).sum((1, 2))
    return (torch.sum(ga * gb, (1, 2)) - 2.0 * cross + x_sq) / nm, ga, gb


class FactoredMSEFusedBlocks(torch.autograd.Function):
    """Per-seed ``mean((A_s @ B_s - x)^2) -> (S,)`` with one fused read of x
    shared by the S packed seeds and an x-free backward, in which each
    seed's block is scaled by its own cotangent. Port of
    ``desmo_tpu.pallas.dual_gemm.factored_mse_fused_blocks``."""

    @staticmethod
    def forward(ctx, a, b, x, x_sq, n_blocks):
        device_mod.fp32_matmul()
        ax, xb = dual_contractions(a, b, x)
        nm = a.shape[0] * b.shape[1]
        vals, ga, gb = mse_blocks_value(a, b, ax, x_sq, nm, n_blocks)
        ctx.save_for_backward(a, b, ax, xb, ga, gb)
        ctx.nm, ctx.n_blocks = nm, n_blocks
        return vals

    @staticmethod
    def backward(ctx, g):
        a, b, ax, xb, ga, gb = ctx.saved_tensors
        S = ctx.n_blocks
        n, k = a.shape
        K, m = k // S, b.shape[1]
        scale = 2.0 / ctx.nm
        g_lane = torch.repeat_interleave(g, K)  # (S K,)
        da = db = None
        if ctx.needs_input_grad[0]:
            a3 = a.view(n, S, K).transpose(0, 1)
            da = scale * ((a3 @ (gb * g[:, None, None])).transpose(0, 1).reshape(n, k) - xb * g_lane)
        if ctx.needs_input_grad[1]:
            db = scale * (((ga * g[:, None, None]) @ b.view(S, K, m)).reshape(k, m) - ax * g_lane[:, None])
        dx_sq = g.sum() / ctx.nm if ctx.needs_input_grad[3] else None
        return da, db, None, dx_sq, None


def factored_mse_fused_blocks(a, b, x, x_sq, n_blocks: int):
    """Functional form of :class:`FactoredMSEFusedBlocks`."""
    return FactoredMSEFusedBlocks.apply(a, b, x, x_sq, n_blocks)
