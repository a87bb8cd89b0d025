"""A whole training chunk of single-seed DESMO in one kernel launch. Port of
the desmo and Fourier forms of ``desmo_tpu/pallas/train_chunk.py``
(``_make_kernel``, ``make_fused_train_chunk``, ``supports``,
``select_chunk``).

A chunk runs ``num_steps`` epochs, each in the order of the eager
``train.make_train_chunk``:

1. forward of the generation-s parameters over all rows: ``lat = pod * phiᵀ``,
   the polynomial library (the product of P factor gathers from
   ``[1 | lat]``), ``sin/cos/tanh(omega * lat)``, ``D`` and ``A = D * c``;
2. the contractions ``ax = AᵀX``, ``xb = XBᵀ``, ``ga = AᵀA``, ``gb = BBᵀ``
   and the latent Gram ``latᵀlat``, and the analytic gradients
   ``dA = 2/nm (A gb - xb)``, ``gB = 2/nm (ga B - ax)``, the coefficient and
   omega gradients and the per-row latent gradient (trig part through
   ``darg * omega``, polynomial part by the product rule over the P factors);
3. the metrics row of the pre-update parameters: rec, ortho, l1, total and
   max |omega * lat|;
4. Adamax on every group with the bias ``1 - b1^(count+1)`` (kept as a
   running product, as the TPU kernel does) and the group LRs in force before
   this step's scheduler step; the coefficients add the L1 subgradient
   ``lam * sign(c)``, phi the ortho term ``beta * lat (sign(latᵀlat) *
   offdiag)``;
5. the plateau scheduler, stepped with this step's total when
   ``epoch % sched_every == 0``.

The Fourier form (``variant="fourier"``) follows the TPU kernel's arithmetic:
at the start of each epoch B is built from the series, ``th = (2 pi t) *
(1 / period)`` on the float32 ``t_points``, cos and sin of th once and the
harmonics by the recurrence ``cos((h+1) th) = c_h c_1 - s_h s_1``; gB is
carried back into the coefficients (row sums of gB, gB cos h th, gB sin h th)
and the periods (``-(1/period) * rowsum(gB dB/dth th)``), which take Adamax
steps with ``lr_z`` and ``lr_period``.

The state travels in the kernel's layout (:class:`ChunkState`): phi and its
moments as one (3, r, n) tensor; B and its moments (3, K, m) (desmo) or the
series ``z ‖ z_trig`` (3, K, 2nF+1) and the periods ``period ‖
trig_period`` (3, K) with their moments (Fourier); the coefficients ``c ‖
c_trig`` (3, K), omega (3, 3r) and a 16-slot scheduler vector (group LRs,
best, b1^count, count, num_bad, epoch).

``fused_train_chunk`` takes the plain version (:func:`train_chunk_plain`,
the same arithmetic written out in PyTorch) for CPU tensors only. On a CUDA
tensor it launches ``csrc/train_chunk.cu`` or raises; every launch adds one
to ``fused_train_chunk.launches``.
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
from desmo_tpu_torch.models import fourier
from desmo_tpu_torch.train import ChunkFn, TrainState

B1, B2, EPS = 0.9, 0.999, 1e-8
SCHED_THRESHOLD = 1e-4
METRICS = ("rec", "ortho", "l1", "total", "max_arg")
# scheduler-vector slots (floats, as in the TPU kernel's svec row)
_LR0, _BEST, _POW, _COUNT, _NUMBAD, _EPOCH = 0, 5, 6, 7, 8, 9
SVEC = 16
MAX_K, MAX_R, MAX_P, MAX_NF = 128, 8, 8, 63


def n_fourier(spec, cfg) -> int:
    """The Fourier form's harmonics nF, 0 for the desmo form."""
    return int(getattr(spec, "n_fourier", 0)) if getattr(cfg, "variant", "desmo") == "fourier" else 0


def supports(spec, cfg) -> bool:
    """Whether the mega-kernel runs this configuration, the answer of
    ``desmo_tpu.pallas.train_chunk.supports``: the desmo or Fourier variant
    with K = T + 3r <= 128, P <= 8 and r <= 8, and for Fourier
    1 <= nF <= 63."""
    variant = getattr(cfg, "variant", "desmo")
    if variant == "fourier":
        if not 1 <= getattr(spec, "n_fourier", 0) <= MAX_NF:
            return False
    elif variant != "desmo":
        return False
    r, P = spec.r, spec.poly_order
    return library.num_poly_terms(r, P) + 3 * r <= MAX_K and P <= MAX_P and r <= MAX_R


def make_chunk(spec, cfg) -> ChunkFn:
    """``chunk(state, batch, num_steps) -> (state, metrics)`` through
    :func:`fused_train_chunk`, for ``train.fit(chunk=...)``."""

    def chunk(state: TrainState, batch: dict, num_steps: int):
        return fused_train_chunk(state, batch, num_steps, spec, cfg)

    return chunk


def select_chunk(spec, cfg, device: torch.device):
    """The chunk policy of ``desmo_tpu.pallas.train_chunk.select_chunk``:
    the mega-kernel's chunk, or None for the eager loop.

    ``cfg.chunk_method``: 'scan' is always the eager loop; 'megakernel'
    requires the mega-kernel (``ValueError`` when unsupported; on the CPU it
    runs the plain version); 'auto' takes it on a CUDA device when the loss
    method is 'auto' or 'fused', and the eager loop on the CPU, as the JAX
    package scans off the TPU."""
    method = getattr(cfg, "chunk_method", "auto")
    if method == "scan":
        return None
    if method == "megakernel":
        if not supports(spec, cfg):
            raise ValueError(
                f"chunk_method='megakernel' but preset {cfg.name!r} is not supported "
                "(variant/terms) — see kernels.train_chunk.supports"
            )
        return make_chunk(spec, cfg)
    if method != "auto":
        raise ValueError(f"unknown chunk_method {method!r}")
    if torch.device(device).type != "cuda":
        return None
    if getattr(cfg, "loss_method", "auto") not in ("auto", "fused") or not supports(spec, cfg):
        return None
    return make_chunk(spec, cfg)


@dataclasses.dataclass
class ChunkState:
    """Training state in the kernel's layout; the kernel updates it in place.
    The desmo form holds ``b``, the Fourier form ``series`` and ``periods``."""

    phi: torch.Tensor  # (3, r, n): phi, its Adamax mu and nu
    coef: torch.Tensor  # (3, K): c ‖ c_trig (kind-major), mu, nu
    omega: torch.Tensor  # (3, 3r): omega (kind-major), mu, nu
    svec: torch.Tensor  # (SVEC,): group LRs, best, b1^count, count, num_bad, epoch
    b: torch.Tensor | None = None  # (3, K, m): B = [z; z_trig], mu, nu
    series: torch.Tensor | None = None  # (3, K, 2nF+1): [z; z_trig] coefficients, mu, nu
    periods: torch.Tensor | None = None  # (3, K): period ‖ trig_period, mu, nu


def pack(state: TrainState) -> ChunkState:
    """A new :class:`ChunkState` holding a copy of ``state``; builds no host
    sync (count and epoch are host ints)."""
    trees = (state.params, state.mu, state.nu)
    width = state.params["z"].shape[1]  # m, or the Fourier form's 2nF+1

    def stack(fn):
        return torch.stack([fn(t).to(torch.float32) for t in trees]).contiguous()

    phi = stack(lambda t: t["phi"])
    temporal = stack(lambda t: torch.cat([t["z"], t["z_trig"].reshape(-1, width)]))
    if "period" in state.params:
        form = dict(
            series=temporal,
            periods=stack(lambda t: torch.cat([t["period"], t["trig_period"].reshape(-1)])),
        )
    else:
        form = dict(b=temporal)
    coef = stack(lambda t: torch.cat([t["c"], t["c_trig"].reshape(-1)]))
    omega = stack(lambda t: t["omega"].reshape(-1))
    sched = state.sched
    dev = phi.device
    pow0 = float(np.float32(B1) ** np.float32(state.count))
    nlr = sched.lrs.shape[0]
    svec = torch.cat([
        sched.lrs.to(torch.float32),
        torch.zeros(_BEST - nlr, dtype=torch.float32, device=dev),
        sched.best.reshape(1).to(torch.float32),
        torch.tensor([pow0, float(state.count)], dtype=torch.float32, device=dev),
        sched.num_bad.reshape(1).to(torch.float32),
        torch.tensor([float(state.epoch)], dtype=torch.float32, device=dev),
        torch.zeros(SVEC - _EPOCH - 1, dtype=torch.float32, device=dev),
    ])
    return ChunkState(phi=phi, coef=coef, omega=omega, svec=svec, **form)


def unpack(cs: ChunkState, like: TrainState, num_steps: int) -> TrainState:
    """The :class:`TrainState` after a chunk of ``num_steps`` epochs that
    started from ``like``; parameters are views into ``cs``."""
    r, n = cs.phi.shape[1:]
    T = cs.coef.shape[1] - 3 * r
    temporal = cs.b if cs.series is None else cs.series
    width = temporal.shape[2]

    def tree(i):
        out = {
            "phi": cs.phi[i],
            "c": cs.coef[i, :T],
            "z": temporal[i, :T],
            "z_trig": temporal[i, T:].view(3, r, width),
            "c_trig": cs.coef[i, T:].view(3, r),
            "omega": cs.omega[i].view(3, r),
        }
        if cs.periods is not None:
            out["period"] = cs.periods[i, :T]
            out["trig_period"] = cs.periods[i, T:].view(3, r)
        return out

    params, mu, nu = (tree(i) for i in range(3))
    keys = list(like.params)
    nlr = like.sched.lrs.shape[0]
    sched = optim.PlateauState(
        lrs=cs.svec[_LR0:_LR0 + nlr].clone(),
        best=cs.svec[_BEST].clone(),
        num_bad=cs.svec[_NUMBAD].to(torch.int32),
    )
    return TrainState(
        params={k: params[k] for k in keys},
        mu={k: mu[k] for k in keys},
        nu={k: nu[k] for k in keys},
        count=like.count + num_steps,
        sched=sched,
        epoch=like.epoch + num_steps,
    )


def _adamax_(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, g, lr, bias) -> None:
    """One Adamax step of the kernel, in place: ``mu = b1 mu + (1-b1) g``,
    ``nu = max(b2 nu, |g| + eps)``, ``p = p - (lr/bias) mu / nu``."""
    mu.copy_(B1 * mu + (1.0 - B1) * g)
    nu.copy_(torch.maximum(B2 * nu, g.abs() + EPS))
    p.copy_(p - (lr / bias) * mu / nu)


def series_forward(zc: torch.Tensor, per: torch.Tensor, tw: torch.Tensor):
    """The Fourier form's B (K, m) from the series zc (K, 2nF+1) and the
    periods (K,) at ``tw = 2 pi t_points``, as the TPU kernel builds it;
    returns ``(B, harmonics, th)`` with the list of ``(cos h th, sin h th)``
    for h = 1..nF."""
    nf = (zc.shape[1] - 1) // 2
    th = tw[None, :] * (1.0 / per)[:, None]
    c1, s1 = torch.cos(th), torch.sin(th)
    acc = zc[:, 0:1] + zc[:, 1:2] * c1 + zc[:, 2:3] * s1
    harmonics = [(c1, s1)]
    ck, sk = c1, s1
    for h in range(2, nf + 1):
        ck, sk = ck * c1 - sk * s1, sk * c1 + ck * s1
        acc = acc + zc[:, 2 * h - 1:2 * h] * ck + zc[:, 2 * h:2 * h + 1] * sk
        harmonics.append((ck, sk))
    return acc, harmonics, th


def series_backward(g_b: torch.Tensor, zc: torch.Tensor, per: torch.Tensor, harmonics, th: torch.Tensor):
    """The gradients of the series coefficients (K, 2nF+1) and the periods
    (K,) from gB (K, m), through :func:`series_forward`'s harmonics."""
    cols = [g_b.sum(1)]
    c1, s1 = harmonics[0]
    dbdt = zc[:, 2:3] * c1 - zc[:, 1:2] * s1
    for h, (ck, sk) in enumerate(harmonics, 1):
        cols += [(g_b * ck).sum(1), (g_b * sk).sum(1)]
        if h > 1:
            dbdt = dbdt + float(h) * (zc[:, 2 * h:2 * h + 1] * ck - zc[:, 2 * h - 1:2 * h] * sk)
    g_per = -(1.0 / per) * (g_b * dbdt * th).sum(1)
    return torch.stack(cols, dim=1), g_per


def train_chunk_plain(state: TrainState, batch: dict, num_steps: int, spec, cfg):
    """The chunk in plain PyTorch: the kernel's arithmetic step by step, with
    the analytic gradients (no autograd). Returns ``(state, metrics)`` like
    :func:`fused_train_chunk`; ``metrics`` holds (num_steps,) tensors."""
    device_mod.fp32_matmul()
    cs = pack(state)
    x, pod, x_sq = batch["x"], batch["pod_modes"], batch["x_sq"]
    n, m = x.shape
    r, P = spec.r, spec.poly_order
    T = spec.num_poly_terms
    nm = float(n * m)
    beta, lam = float(cfg.beta), float(cfg.l1_lambda)
    F = torch.as_tensor(spec.factor_table(), dtype=torch.int64, device=x.device)
    offdiag = 1.0 - torch.eye(r, dtype=torch.float32, device=x.device)
    ones = torch.ones((n, 1), dtype=torch.float32, device=x.device)
    phi, phi_mu, phi_nu = cs.phi.unbind(0)
    if cs.series is None:
        bm, b_mu, b_nu = cs.b.unbind(0)
    else:
        zc, zc_mu, zc_nu = cs.series.unbind(0)
        per, per_mu, per_nu = cs.periods.unbind(0)
        tw = torch.as_tensor(fourier.TWO_PI * fourier.t_points(m), device=x.device)  # float32 2 pi t
    c, c_mu, c_nu = cs.coef.unbind(0)
    om, om_mu, om_nu = cs.omega.unbind(0)
    sv = cs.svec
    rows = []
    for _ in range(num_steps):
        # forward of the generation-s parameters
        if cs.series is not None:
            bm, harmonics, th_b = series_forward(zc, per, tw)
        lat = pod * phi.T  # (n, r)
        gathered = torch.cat([ones, lat], dim=1)[:, F]  # (n, T, P)
        theta = gathered[..., 0]
        for p in range(1, P):
            theta = theta * gathered[..., p]
        lat3 = lat.repeat(1, 3)  # column k*r + j holds lat_j
        args = lat3 * om
        a_sin, a_cos, a_tanh = args[:, :r], args[:, r:2 * r], args[:, 2 * r:]
        th = torch.tanh(a_tanh)
        D = torch.cat([theta, torch.sin(a_sin), torch.cos(a_cos), th], dim=1)
        A = D * c
        # contractions
        gb = bm @ bm.T
        xb = x @ bm.T
        ax = A.T @ x
        ga = A.T @ A
        latg = lat.T @ lat
        # gradients
        dA = (2.0 / nm) * (A @ gb - xb)
        dD = dA * c
        g_coef = (dA * D).sum(0) + lam * torch.sign(c)
        darg = dD[:, T:] * torch.cat([torch.cos(a_sin), -torch.sin(a_cos), 1.0 - th * th], dim=1)
        g_om = (darg * lat3).sum(0)
        dl = (darg * om).view(n, 3, r).sum(1)
        dl_aug = torch.zeros((n, r + 1), dtype=torch.float32, device=x.device)
        for p in range(P):  # product rule: d theta_t / d aug_F[t,p] = prod_{q != p} aug_F[t,q]
            others = dD[:, :T]
            for q in range(P):
                if q != p:
                    others = others * gathered[..., q]
            dl_aug.index_add_(1, F[:, p], others)
        dl = dl + dl_aug[:, 1:]
        g_phi = ((dl + beta * (lat @ (torch.sign(latg) * offdiag))) * pod).T
        g_b = (2.0 / nm) * (ga @ bm - ax)
        # metrics of the pre-update parameters
        rec = (torch.sum(ga * gb) - 2.0 * torch.sum(ax * bm) + x_sq) / nm
        ortho = 0.5 * torch.sum(torch.abs(latg * offdiag))
        l1 = torch.sum(torch.abs(c))
        total = rec + beta * ortho + lam * l1
        rows.append(torch.stack([rec, ortho, l1, total, torch.max(torch.abs(args))]))
        # Adamax with the LRs in force before this step's scheduler step
        powb = sv[_POW] * B1
        bias = 1.0 - powb
        lrs = sv[_LR0:_LR0 + 5].clone()
        _adamax_(c, c_mu, c_nu, g_coef, lrs[0], bias)
        _adamax_(phi, phi_mu, phi_nu, g_phi, lrs[1], bias)
        if cs.series is None:
            _adamax_(bm, b_mu, b_nu, g_b, lrs[2], bias)
        else:
            g_zc, g_per = series_backward(g_b, zc, per, harmonics, th_b)
            _adamax_(zc, zc_mu, zc_nu, g_zc, lrs[2], bias)
            _adamax_(per, per_mu, per_nu, g_per, lrs[4], bias)
        _adamax_(om, om_mu, om_nu, g_om, lrs[3], bias)
        # plateau scheduler
        best, num_bad, epoch = sv[_BEST].clone(), sv[_NUMBAD].clone(), sv[_EPOCH].clone()
        improved = total < best * (1.0 - SCHED_THRESHOLD)
        best_n = torch.where(improved, total, best)
        nb = torch.where(improved, torch.zeros_like(num_bad), num_bad + 1.0)
        red = nb > float(cfg.patience)
        stepped = torch.where(red, torch.clamp(lrs * float(cfg.sched_factor), min=float(cfg.sched_min_lr)), lrs)
        nb = torch.where(red, torch.zeros_like(nb), nb)
        do = torch.remainder(epoch, float(cfg.sched_every)) == 0.0
        sv[_LR0:_LR0 + 5] = torch.where(do, stepped, lrs)
        sv[_BEST] = torch.where(do, best_n, best)
        sv[_NUMBAD] = torch.where(do, nb, num_bad)
        sv[_POW] = powb
        sv[_COUNT] = sv[_COUNT] + 1.0
        sv[_EPOCH] = epoch + 1.0
    stacked = torch.stack(rows)
    return unpack(cs, state, num_steps), {k: stacked[:, i] for i, k in enumerate(METRICS)}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(_build.load("train_chunk"))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/train_chunk.cu``."""
    lib.desmo_chunk_grid.argtypes = [ctypes.c_int] * 3
    lib.desmo_chunk_grid.restype = ctypes.c_int
    lib.desmo_chunk_workspace.argtypes = [ctypes.c_int] * 6
    lib.desmo_chunk_workspace.restype = ctypes.c_longlong
    lib.desmo_chunk_timer_offset.argtypes = [ctypes.c_int] * 6
    lib.desmo_chunk_timer_offset.restype = ctypes.c_longlong
    lib.desmo_train_chunk.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [ctypes.c_float] * 5 + [ctypes.c_void_p]
    )
    lib.desmo_train_chunk.restype = ctypes.c_int
    return lib


@functools.cache
def _grid(device_index: int, r: int, k: int, nf: int) -> int:
    """Blocks of the cooperative launch on this device: one per SM when one
    fits there; raises when the device cannot launch it."""
    with torch.cuda.device(device_index):
        grid = _lib().desmo_chunk_grid(r, k, nf)
    if grid <= 0:
        raise RuntimeError(
            "fused_train_chunk: no cooperative launch on this device "
            f"(CUDA error {-grid}: cooperative launch unsupported or no block fits an SM)"
        )
    return grid


def _check(state: TrainState, batch: dict, spec, nf: int) -> None:
    x, pod, x_sq = batch["x"], batch["pod_modes"], batch["x_sq"]
    n, m = x.shape
    r = spec.r
    for name, t, shape in (("x", x, (n, m)), ("pod_modes", pod, (n, r)), ("x_sq", x_sq, ())):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fused_train_chunk: {name} must be a contiguous float32 tensor of shape "
                f"{shape}, got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
        if t.device != x.device:
            raise ValueError(f"fused_train_chunk: {name} on {t.device}, x on {x.device}")
    width = 2 * nf + 1 if nf else m
    if tuple(state.params["phi"].shape) != (r, n) or tuple(state.params["z"].shape[1:]) != (width,):
        raise ValueError(
            "fused_train_chunk: state does not match the batch's (n, m), the spec's r and its series length"
        )
    if nf and "period" not in state.params:
        raise ValueError("fused_train_chunk: the Fourier form needs the state's periods")
    if state.params["phi"].device != x.device:
        raise ValueError(f"fused_train_chunk: state on {state.params['phi'].device}, x on {x.device}")


def _launch(state: TrainState, batch: dict, num_steps: int, spec, cfg):
    """Allocate and launch one chunk on the card; returns the packed state,
    the metrics rows and the scratch buffer."""
    x = batch["x"]
    n, m = x.shape
    r, P, T = spec.r, spec.poly_order, spec.num_poly_terms
    K = T + 3 * r
    nf = n_fourier(spec, cfg)
    lib = _lib()
    grid = _grid(x.device.index, r, K, nf)
    cs = pack(state)
    with torch.cuda.device(x.device):
        f32 = dict(dtype=torch.float32, device=x.device)
        ftab = torch.as_tensor(spec.factor_table(), dtype=torch.int32, device=x.device).contiguous()
        tpts = torch.as_tensor(fourier.t_points(m), device=x.device) if nf else None
        met = torch.empty((num_steps, len(METRICS)), **f32)
        work = torch.empty((lib.desmo_chunk_workspace(n, m, r, K, nf, grid),), **f32)
        stream = torch.cuda.current_stream(x.device).cuda_stream

        def ptr(t):
            return None if t is None else t.data_ptr()

        rc = lib.desmo_train_chunk(
            batch["pod_modes"].data_ptr(), x.data_ptr(), batch["x_sq"].data_ptr(), ftab.data_ptr(),
            ptr(tpts), cs.phi.data_ptr(), ptr(cs.b), ptr(cs.series), ptr(cs.periods),
            cs.coef.data_ptr(), cs.omega.data_ptr(), cs.svec.data_ptr(), met.data_ptr(), work.data_ptr(),
            n, m, r, P, T, nf, num_steps, int(cfg.sched_every), grid,
            float(cfg.beta), float(cfg.l1_lambda), float(cfg.patience),
            float(cfg.sched_factor), float(cfg.sched_min_lr), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_train_chunk: kernel launch failed with CUDA error {rc}")
    fused_train_chunk.launches += 1
    return cs, met, work


def _checked_device(state: TrainState, batch: dict, num_steps: int, spec, cfg) -> str:
    if num_steps < 1:
        raise ValueError(f"fused_train_chunk needs num_steps >= 1, got {num_steps}")
    if not supports(spec, cfg):
        raise ValueError(f"fused_train_chunk: unsupported configuration {cfg.name!r}")
    _check(state, batch, spec, n_fourier(spec, cfg))
    kind = batch["x"].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"fused_train_chunk: unsupported device {batch['x'].device}")
    return kind


def fused_train_chunk(state: TrainState, batch: dict, num_steps: int, spec, cfg):
    """Run ``num_steps`` epochs from ``state`` in one launch; returns
    ``(state, metrics)`` with (num_steps,) metric tensors ``rec``, ``ortho``,
    ``l1``, ``total`` and ``max_arg``. ``batch`` holds fp32 ``x`` (n, m),
    ``pod_modes`` (n, r) and ``x_sq`` = sum(x*x)."""
    if _checked_device(state, batch, num_steps, spec, cfg) == "cpu":
        return train_chunk_plain(state, batch, num_steps, spec, cfg)
    cs, met, _ = _launch(state, batch, num_steps, spec, cfg)
    return unpack(cs, state, num_steps), {k: met[:, i] for i, k in enumerate(METRICS)}


# the kernel clock's counters, in the order of ``enum Phase`` in the source;
# the "barrier" entries close their phase, the wait for the slowest block
# included. The Fourier form adds its series update and the B Bᵀ reduction
# after it (``FOURIER_PHASES``).
PHASES = (
    "prologue", "rows.dictionary", "rows.xb", "rows.gradients", "rows.barrier", "reduce",
    "columns.phi", "columns.ax", "columns.barrier", "finalize",
)
FOURIER_PHASES = PHASES + ("series.update", "series.gram")


def phase_split(state: TrainState, batch: dict, num_steps: int, spec, cfg):
    """Seconds of one launch of ``num_steps`` epochs by part (``PHASES``, or
    ``FOURIER_PHASES`` for the Fourier form), from the kernel's own clock:
    block 0's thread reads the card's global timer at each mark, so a part
    inside a phase is block 0's own time and a phase's last part takes in the
    wait at its grid barrier. Summed over the epochs. Needs the card; the
    launch counts like any other."""
    if _checked_device(state, batch, num_steps, spec, cfg) != "cuda":
        raise ValueError("phase_split: needs CUDA tensors, the plain chunk has no phases")
    _, _, work = _launch(state, batch, num_steps, spec, cfg)
    n, m = batch["x"].shape
    K = spec.num_poly_terms + 3 * spec.r
    nf = n_fourier(spec, cfg)
    names = FOURIER_PHASES if nf else PHASES
    off = _lib().desmo_chunk_timer_offset(n, m, spec.r, K, nf, _grid(batch["x"].device.index, spec.r, K, nf))
    ns = work[off:off + 2 * len(names)].view(torch.int64).cpu().tolist()
    return {name: t * 1e-9 for name, t in zip(names, ns)}


fused_train_chunk.launches = 0
