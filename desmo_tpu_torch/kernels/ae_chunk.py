"""A whole training chunk of the AE variant in one kernel launch. Port of
``desmo_tpu/pallas/ae_chunk.py`` (``_make_ae_kernel``, ``make_ae_fused_chunk``,
``ae_supports``) and of the AE branch of ``train_chunk.select_chunk``.

A chunk runs ``num_steps`` epochs of the factored AE loss
(``models/autoencoder.py``), each in the order of the eager
``train.make_train_chunk``:

1. the encoder funnel over every row of X (m->256->128->64->16->8->4->2,
   ReLU but on the latent) and the decoder funnel back to D6, the last
   hidden activation (n, 256);
2. the dictionary block on the latent: ``A = D * c`` with the tanh columns
   masked out of the sum (and of the L1), the contractions ``ax = AᵀX``,
   ``xb = XBᵀ``, ``ga = AᵀA``, ``gb = BBᵀ``, and ``dA = 2/nm (A gb - xb)``;
3. the factored AE-MSE through the last decoder layer V6, c6: with
   ``S_dd = D6ᵀD6``, ``S_dX = D6ᵀX``, ``VV = V6V6ᵀ``, ``s_d = 1ᵀD6`` and
   ``k = 2 ae_beta / nm``, ``dV6 = k (S_dd V6 + s_dᵀ c6 - S_dX)``,
   ``dc6 = k (s_d V6 + n c6 - 1ᵀX)`` and ``dD6 = k (D6 VV + 1 c6V6ᵀ - X V6ᵀ)``,
   so the (n, m) decode is never formed;
4. the analytic backward: the ReLU gradients are zero at 0; the decoder
   chain from dD6 to the latent; the latent gradient is the dictionary's
   (the trig part through ``darg * omega``, the polynomial part by the
   product rule), the ortho term ``2 beta/n² (s2 lat1, s1 lat2)`` and the
   decoder's; then the encoder chain down to the first layer, whose weight
   gradient is ``Xᵀ dpre1``;
5. the metrics of the pre-update parameters: rec, ortho (``s1 s2 / n²``),
   l1 (c and the sin/cos coefficients), total, max |omega * lat| (every
   trig column, tanh included) and ae;
6. Adamax with the bias ``1 - b1^(count+1)`` (a running product, as the TPU
   kernel keeps it): ``lr_z`` for every MLP tensor and for B, ``lr_coef``
   for the coefficients (plus ``lam sign(c)``; the tanh lanes get a zero
   gradient), ``lr_omega`` for omega; then the plateau scheduler.

The state travels in the kernel's layout (:class:`AEChunkState`): every MLP
tensor of one generation (params, mu, nu) flat in the JAX package's key
order, B (3, K, m), the coefficients ``c ‖ c_trig`` (3, K), omega (3, 3r)
and the scheduler vector of ``kernels.train_chunk``.

:func:`fused_ae_chunk` takes the plain version (:func:`ae_chunk_plain`, the
same arithmetic written out in PyTorch) for CPU tensors only. On a CUDA
tensor it launches ``csrc/ae_chunk.cu`` or raises; every launch adds one to
``fused_ae_chunk.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from desmo_tpu_torch import device as device_mod
from desmo_tpu_torch import library, optim
from desmo_tpu_torch.kernels import _build
from desmo_tpu_torch.kernels._chunk_optim import (
    _BEST, _COUNT, _EPOCH, _LR0, _NUMBAD, _POW, B1, SVEC, _adamax_, sched_step_,
)
from desmo_tpu_torch.models import autoencoder as ae_model
from desmo_tpu_torch.train import ChunkFn, TrainState

METRICS = ("rec", "ortho", "l1", "total", "max_arg", "ae")
# the TPU kernel's limits, kept so that both packages take the same
# configurations: the K = T + 3r dictionary columns within its 16-lane
# stash, and P <= 8
MAX_K, MAX_P = 16, 8
_G_COEF, _G_Z, _G_OMEGA = 0, 2, 3  # GROUP_ORDER indices of the LR groups the AE trains


def ae_supports(spec, cfg) -> bool:
    """Whether the AE kernel runs this configuration, the answer of
    ``desmo_tpu.pallas.ae_chunk.ae_supports`` without its TPU layout checks
    (the VMEM budget, the init/out stream tiling): the AE variant at r == 2,
    K = T + 3r <= 16 and P <= 8."""
    if getattr(cfg, "variant", "desmo") != "ae" or spec.r != 2:
        return False
    return library.num_poly_terms(spec.r, spec.poly_order) + 3 * spec.r <= MAX_K and spec.poly_order <= MAX_P


def select_ae_chunk(spec, cfg) -> ChunkFn | None:
    """The AE branch of ``train_chunk.select_chunk``, the policy of
    ``desmo_tpu/pallas/train_chunk.py:1333-1358``: 'megakernel' returns the
    kernel's chunk (``ValueError`` when unsupported; on the CPU it runs the
    plain version); 'auto' and 'scan' return None, the eager loop."""
    method = getattr(cfg, "chunk_method", "auto")
    if method == "megakernel":
        if not ae_supports(spec, cfg):
            raise ValueError(
                f"chunk_method='megakernel' but preset {cfg.name!r} is not supported "
                "(r/terms) — see kernels.ae_chunk.ae_supports"
            )
        return make_chunk(spec, cfg)
    if method not in ("auto", "scan"):
        raise ValueError(f"unknown chunk_method {method!r}")
    return None


def make_chunk(spec, cfg) -> ChunkFn:
    """``chunk(state, batch, num_steps) -> (state, metrics)`` through
    :func:`fused_ae_chunk`, for ``train.fit(chunk=...)``."""

    def chunk(state: TrainState, batch: dict, num_steps: int):
        return fused_ae_chunk(state, batch, num_steps, spec, cfg)

    return chunk


def mlp_layout(m: int) -> list[tuple[str, tuple[int, ...], int]]:
    """(key, shape, offset) of every MLP tensor in the flat generation
    vector: ``ae_enc_w0, ae_enc_b0, ..., ae_enc_b6, ae_dec_w0, ...,
    ae_dec_b6``, weights (in, out) row-major."""
    enc = (m, *ae_model.ENCODER_WIDTHS, 2)
    out, off = [], 0
    for prefix, widths in (("ae_enc", enc), ("ae_dec", enc[::-1])):
        for i in range(ae_model.N_LAYERS):
            for key, shape in ((f"{prefix}_w{i}", (widths[i], widths[i + 1])), (f"{prefix}_b{i}", (widths[i + 1],))):
                out.append((key, shape, off))
                off += int(np.prod(shape))
    return out


def mlp_size(m: int) -> int:
    key, shape, off = mlp_layout(m)[-1]
    return off + int(np.prod(shape))


@dataclasses.dataclass
class AEChunkState:
    """Training state of one AE model in the kernel's layout; the kernel
    updates it in place."""

    mlp: torch.Tensor  # (3, mlp_size(m)): every MLP tensor, its mu and nu
    b: torch.Tensor  # (3, K, m): B = [z; z_trig], mu, nu
    coef: torch.Tensor  # (3, K): c ‖ c_trig (kind-major), mu, nu
    omega: torch.Tensor  # (3, 3r): omega (kind-major), mu, nu
    svec: torch.Tensor  # (SVEC,): group LRs, best, b1^count, count, num_bad, epoch


def pack(state: TrainState) -> AEChunkState:
    """A new :class:`AEChunkState` holding a copy of ``state``."""
    trees = (state.params, state.mu, state.nu)
    m = state.params["z"].shape[1]
    layout = mlp_layout(m)

    def stack(fn):
        return torch.stack([fn(t).to(torch.float32) for t in trees]).contiguous()

    mlp = stack(lambda t: torch.cat([t[k].reshape(-1) for k, _, _ in layout]))
    b = stack(lambda t: torch.cat([t["z"], t["z_trig"].reshape(-1, m)]))
    coef = stack(lambda t: torch.cat([t["c"], t["c_trig"].reshape(-1)]))
    omega = stack(lambda t: t["omega"].reshape(-1))
    sched = state.sched
    f32 = dict(dtype=torch.float32, device=mlp.device)
    nlr = sched.lrs.shape[0]
    svec = torch.zeros((SVEC,), **f32)
    svec[_LR0:_LR0 + nlr] = sched.lrs.to(torch.float32)
    svec[_BEST] = sched.best
    svec[_POW] = float(np.float32(B1) ** np.float32(state.count))
    svec[_COUNT] = float(state.count)
    svec[_NUMBAD] = sched.num_bad.to(torch.float32)
    svec[_EPOCH] = float(state.epoch)
    return AEChunkState(mlp=mlp, b=b, coef=coef, omega=omega, svec=svec)


def unpack(cs: AEChunkState, like: TrainState, num_steps: int) -> TrainState:
    """The :class:`TrainState` after a chunk of ``num_steps`` epochs that
    started from ``like``; parameters are views into ``cs``."""
    K, m = cs.b.shape[1:]
    r = cs.omega.shape[1] // 3
    T = K - 3 * r
    layout = mlp_layout(m)

    def tree(i):
        out = {k: cs.mlp[i, off:off + int(np.prod(shape))].view(shape) for k, shape, off in layout}
        out.update(
            c=cs.coef[i, :T], c_trig=cs.coef[i, T:].view(3, r),
            z=cs.b[i, :T], z_trig=cs.b[i, T:].view(3, r, m), omega=cs.omega[i].view(3, r),
        )
        return out

    params, mu, nu = (tree(i) for i in range(3))
    keys = list(like.params)
    nlr = like.sched.lrs.shape[-1]
    return TrainState(
        params={k: params[k] for k in keys},
        mu={k: mu[k] for k in keys},
        nu={k: nu[k] for k in keys},
        count=like.count + num_steps,
        sched=optim.PlateauState(
            lrs=cs.svec[_LR0:_LR0 + nlr].clone(),
            best=cs.svec[_BEST].clone(),
            num_bad=cs.svec[_NUMBAD].to(torch.int32),
        ),
        epoch=like.epoch + num_steps,
    )


def ae_chunk_plain(state: TrainState, batch: dict, num_steps: int, spec, cfg):
    """The chunk in plain PyTorch: the kernel's arithmetic step by step, with
    the analytic gradients (no autograd). ``batch`` holds fp32 ``x`` (n, m),
    ``x_sq`` and ``x_colsum``. Returns ``(state, metrics)`` like
    :func:`fused_ae_chunk`."""
    device_mod.fp32_matmul()
    cs = pack(state)
    x, x_sq, xcol = batch["x"], batch["x_sq"], batch["x_colsum"]
    n, m = x.shape
    r, P = spec.r, spec.poly_order
    T = spec.num_poly_terms
    K = T + 3 * r
    nm = float(n * m)
    two_nm = 2.0 / nm
    kae = 2.0 * float(cfg.ae_beta) / nm
    korth = 2.0 * float(cfg.beta) / float(n * n)
    beta, lam, ae_beta = float(cfg.beta), float(cfg.l1_lambda), float(cfg.ae_beta)
    dev = x.device
    F = torch.as_tensor(spec.factor_table(), dtype=torch.int64, device=dev)
    aerow = torch.ones(K, dtype=torch.float32, device=dev)
    aerow[T + 2 * r:] = 0.0  # the tanh channel: out of the sum and the L1
    ones = torch.ones((n, 1), dtype=torch.float32, device=dev)
    gens = [{k: cs.mlp[i, off:off + int(np.prod(shape))].view(shape) for k, shape, off in mlp_layout(m)}
            for i in range(3)]
    W, W_mu, W_nu = gens
    bm, b_mu, b_nu = cs.b.unbind(0)
    c, c_mu, c_nu = cs.coef.unbind(0)
    om, om_mu, om_nu = cs.omega.unbind(0)
    sv = cs.svec
    L = ae_model.N_LAYERS
    rows = []
    for _ in range(num_steps):
        # funnels forward: a[i] the output of encoder layer i, d[i] the decoder's activations (d[0] the latent)
        a, h = [], x
        for i in range(L):
            h = h @ W[f"ae_enc_w{i}"] + W[f"ae_enc_b{i}"]
            if i < L - 1:
                h = torch.relu(h)
            a.append(h)
        lat = a[-1]
        d = [lat]
        for i in range(L - 1):
            d.append(torch.relu(d[-1] @ W[f"ae_dec_w{i}"] + W[f"ae_dec_b{i}"]))
        d6 = d[-1]
        # the dictionary on the latent
        c_eff = c * aerow
        gathered = torch.cat([ones, lat], dim=1)[:, F]  # (n, T, P)
        theta = gathered[..., 0]
        for p in range(1, P):
            theta = theta * gathered[..., p]
        lat3 = lat.repeat(1, 3)  # column k r + j holds lat_j
        args = lat3 * om[None, :]
        th = torch.tanh(args[:, 2 * r:])
        D = torch.cat([theta, torch.sin(args[:, :r]), torch.cos(args[:, r:2 * r]), th], dim=1)
        deriv = torch.cat([torch.cos(args[:, :r]), -torch.sin(args[:, r:2 * r]), 1.0 - th * th], dim=1)
        A = D * c_eff
        gb, xb, ax, ga = bm @ bm.T, x @ bm.T, A.T @ x, A.T @ A
        dA = two_nm * (A @ gb - xb)
        dD = dA * c_eff
        g_coef = ((dA * D).sum(0) + lam * torch.sign(c)) * aerow
        darg = dD[:, T:] * deriv
        g_om = (darg * lat3).sum(0)
        dl = (darg * om[None, :]).view(n, 3, r).sum(1)
        dl_aug = torch.zeros((n, r + 1), dtype=torch.float32, device=dev)
        for p in range(P):  # product rule over the P factors
            others = dD[:, :T]
            for q in range(P):
                if q != p:
                    others = others * gathered[..., q]
            dl_aug.index_add_(1, F[:, p], others)
        dl = dl + dl_aug[:, 1:]
        s1, s2 = torch.sum(lat[:, 0] ** 2), torch.sum(lat[:, 1] ** 2)
        # the factored AE-MSE and the decoder's backward
        V6, c6 = W[f"ae_dec_w{L - 1}"], W[f"ae_dec_b{L - 1}"]
        s_dd, s_dx, s_d = d6.T @ d6, d6.T @ x, d6.sum(0)
        vv, cv = V6 @ V6.T, V6 @ c6
        g_v6 = kae * (s_dd @ V6 + s_d[:, None] * c6[None, :] - s_dx)
        sdv6 = s_d @ V6
        g_c6 = kae * (sdv6 + n * c6 - xcol)
        e = (kae * (d6 @ vv + cv[None, :] - x @ V6.T)) * (d6 > 0)
        grads = {f"ae_dec_w{L - 1}": g_v6, f"ae_dec_b{L - 1}": g_c6}
        for i in range(L - 2, -1, -1):
            grads[f"ae_dec_w{i}"], grads[f"ae_dec_b{i}"] = d[i].T @ e, e.sum(0)
            e = e @ W[f"ae_dec_w{i}"].T
            if i > 0:
                e = e * (d[i] > 0)
        # the latent's gradient, then the encoder's backward
        g = (dl + e) + korth * torch.stack([s2 * lat[:, 0], s1 * lat[:, 1]], dim=1)
        for i in range(L - 1, -1, -1):
            below = a[i - 1] if i > 0 else x
            grads[f"ae_enc_w{i}"], grads[f"ae_enc_b{i}"] = below.T @ g, g.sum(0)
            if i > 0:
                g = (g @ W[f"ae_enc_w{i}"].T) * (below > 0)
        g_b = two_nm * (ga @ bm - ax)
        # metrics of the pre-update parameters
        rec = (torch.sum(ga * gb) - 2.0 * torch.sum(ax * bm) + x_sq) / nm
        ortho = s1 * s2 / float(n * n)
        l1 = torch.sum(torch.abs(c) * aerow)
        ae = (torch.sum(s_dd * vv) - 2.0 * torch.sum(s_dx * V6) + 2.0 * torch.dot(sdv6, c6)
              - 2.0 * torch.dot(xcol, c6) + n * torch.dot(c6, c6) + x_sq) / nm
        total = rec + beta * ortho + lam * l1 + ae_beta * ae
        rows.append(torch.stack([rec, ortho, l1, total, torch.max(torch.abs(args)), ae]))
        # Adamax with the LRs in force before this step's scheduler step
        bias = 1.0 - sv[_POW] * B1
        lrs = sv[_LR0:_LR0 + 5].clone()
        for k, gk in grads.items():
            _adamax_(W[k], W_mu[k], W_nu[k], gk, lrs[_G_Z], bias)
        _adamax_(bm, b_mu, b_nu, g_b, lrs[_G_Z], bias)
        _adamax_(c, c_mu, c_nu, g_coef, lrs[_G_COEF], bias)
        _adamax_(om, om_mu, om_nu, g_om, lrs[_G_OMEGA], bias)
        sched_step_(sv[None], total.reshape(1), cfg)  # the plateau scheduler
    return unpack(cs, state, num_steps), _metrics(torch.stack(rows))


def _metrics(met: torch.Tensor) -> dict:
    return {k: met[:, i] for i, k in enumerate(METRICS)}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(_build.load("ae_chunk"))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/ae_chunk.cu``."""
    lib.ae_chunk_grid.argtypes = []
    lib.ae_chunk_grid.restype = ctypes.c_int
    lib.ae_chunk_workspace.argtypes = [ctypes.c_int] * 4
    lib.ae_chunk_workspace.restype = ctypes.c_longlong
    lib.ae_chunk_timer_offset.argtypes = [ctypes.c_int] * 4
    lib.ae_chunk_timer_offset.restype = ctypes.c_longlong
    lib.ae_train_chunk.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float] * 6 + [ctypes.c_void_p]
    )
    lib.ae_train_chunk.restype = ctypes.c_int
    return lib


@functools.cache
def _grid(device_index: int) -> int:
    """Blocks of the cooperative launch on this device: one per SM; raises
    when the device cannot launch it."""
    with torch.cuda.device(device_index):
        grid = _lib().ae_chunk_grid()
    if grid <= 0:
        raise RuntimeError(
            "fused_ae_chunk: no cooperative launch on this device "
            f"(CUDA error {-grid}: cooperative launch unsupported or no block fits an SM)"
        )
    return grid


def _checked_device(state: TrainState, batch: dict, num_steps: int, spec, cfg) -> str:
    """Checks the inputs; returns the device type."""
    if num_steps < 1:
        raise ValueError(f"fused_ae_chunk needs num_steps >= 1, got {num_steps}")
    if not ae_supports(spec, cfg):
        raise ValueError(f"fused_ae_chunk: unsupported configuration {cfg.name!r}")
    x = batch["x"]
    n, m = x.shape
    for name, shape in (("x", (n, m)), ("x_sq", ()), ("x_colsum", (m,))):
        t = batch.get(name)
        if t is None:
            raise ValueError(f"fused_ae_chunk: the batch has no {name!r}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fused_ae_chunk: {name} must be a contiguous float32 tensor of shape "
                f"{shape}, got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
        if t.device != x.device:
            raise ValueError(f"fused_ae_chunk: {name} on {t.device}, x on {x.device}")
    w0 = state.params["ae_enc_w0"]
    if tuple(w0.shape) != (m, ae_model.ENCODER_WIDTHS[0]) or tuple(state.params["z"].shape) != (
            spec.num_poly_terms, m):
        raise ValueError("fused_ae_chunk: state does not match the batch's m or the spec's terms")
    if w0.device != x.device:
        raise ValueError(f"fused_ae_chunk: state on {w0.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ae_chunk: unsupported device {x.device}")
    return x.device.type


def _launch(state: TrainState, batch: dict, num_steps: int, spec, cfg):
    """Allocate and launch one chunk on the card; returns the packed state,
    the metrics rows (num_steps, 6) and the scratch buffer."""
    x = batch["x"]
    n, m = x.shape
    K = spec.num_poly_terms + 3 * spec.r
    lib = _lib()
    grid = _grid(x.device.index)
    cs = pack(state)
    with torch.cuda.device(x.device):
        f32 = dict(dtype=torch.float32, device=x.device)
        ftab = torch.as_tensor(spec.factor_table().astype(np.int32), device=x.device).contiguous()
        met = torch.empty((num_steps, len(METRICS)), **f32)
        work = torch.empty((lib.ae_chunk_workspace(n, m, K, grid),), **f32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ae_train_chunk(
            x.data_ptr(), batch["x_sq"].data_ptr(), batch["x_colsum"].data_ptr(), ftab.data_ptr(), cs.mlp.data_ptr(),
            cs.b.data_ptr(), cs.coef.data_ptr(), cs.omega.data_ptr(), cs.svec.data_ptr(), met.data_ptr(),
            work.data_ptr(), n, m, spec.poly_order, spec.num_poly_terms, num_steps, int(cfg.sched_every), grid,
            float(cfg.patience), float(cfg.sched_factor), float(cfg.sched_min_lr), float(cfg.beta),
            float(cfg.l1_lambda), float(cfg.ae_beta), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_ae_chunk: kernel launch failed with CUDA error {rc}")
    return cs, met, work


def fused_ae_chunk(state: TrainState, batch: dict, num_steps: int, spec, cfg):
    """Run ``num_steps`` epochs of one AE model from ``state`` in one launch;
    returns ``(state, metrics)`` with (num_steps,) tensors ``rec``,
    ``ortho``, ``l1``, ``total``, ``max_arg`` and ``ae``. ``batch`` holds
    fp32 ``x`` (n, m), ``x_sq`` = sum(x*x) and ``x_colsum`` = sum(x, 0)."""
    if _checked_device(state, batch, num_steps, spec, cfg) == "cpu":
        return ae_chunk_plain(state, batch, num_steps, spec, cfg)
    cs, met, _ = _launch(state, batch, num_steps, spec, cfg)
    fused_ae_chunk.launches += 1
    return unpack(cs, state, num_steps), _metrics(met)


# the kernel clock's counters, in the order of ``enum Phase`` in the source;
# the "barrier" entries close their phase, the wait for the slowest block
# included
PHASES = (
    "prologue", "rows.forward", "rows.dictionary", "rows.decoder", "rows.barrier",
    "encoder.backward", "encoder.columns", "encoder.barrier", "columns.weights", "weights.barrier",
    "columns.v6", "columns.barrier", "finalize",
)


def phase_split(state: TrainState, batch: dict, num_steps: int, spec, cfg) -> dict:
    """Seconds of one launch of ``num_steps`` epochs by part (``PHASES``),
    from the kernel's own clock: block 0's thread reads the card's global
    timer at each mark, so a part inside a phase is block 0's own time and a
    phase's last part takes in the wait at its grid barrier. Summed over the
    epochs. Needs the card; the launch counts like any other."""
    if _checked_device(state, batch, num_steps, spec, cfg) != "cuda":
        raise ValueError("phase_split: needs CUDA tensors, the plain chunk has no phases")
    _, _, work = _launch(state, batch, num_steps, spec, cfg)
    fused_ae_chunk.launches += 1
    n, m = batch["x"].shape
    K = spec.num_poly_terms + 3 * spec.r
    off = _lib().ae_chunk_timer_offset(n, m, K, _grid(batch["x"].device.index))
    ns = work[off:off + 2 * len(PHASES)].view(torch.int64).cpu().tolist()
    return {name: t * 1e-9 for name, t in zip(PHASES, ns)}


fused_ae_chunk.launches = 0
