"""One optimizer step of DESMO per kernel launch, with the rows sharded over
the ranks of a ``space`` mesh. Port of ``desmo_tpu/pallas/shard_step.py``
(``_make_step_kernel``, ``supports_sharded``, ``make_sharded_fused_chunk``),
one seed, desmo and Fourier forms.

Rank k owns a contiguous block of rows (``parallel.row_range``): its rows of
X, of the POD modes and of phi with phi's Adamax moments. Each step:

1. (Fourier) B from the series (``train_chunk.series_forward``), and
   ``gb = B Bᵀ``;
2. one launch of ``csrc/shard_step.cu`` over the rank's rows
   (:func:`step_partials`): the rows' latent gradient ``dl`` without the
   ortho term, and the partial sums ``ax = AᵀX``, ``ga = AᵀA``, the latent
   Gram ``latᵀlat``, the coefficient gradient ``sum(dA * D)``, the omega
   gradient and ``max |omega * lat|``. ``dA`` is normalised by the global
   ``n m``, never by the rank's row count;
3. ``max_arg`` all-reduced with MAX, then the other partials, one buffer,
   with SUM;
4. the replicated update, the same on every rank from the all-reduced sums:
   the metrics, the Adamax of B (Fourier: of the series and the periods,
   through ``series_backward``), of c (with ``lam * sign(c)``) and of omega,
   and the plateau scheduler;
5. the row-local phi Adamax, whose ortho term ``beta * lat (sign(latᵀlat) *
   offdiag)`` needs the all-reduced latent Gram, so it is added here and not
   in the kernel.

Updating phi at the end of each step equals the single-device mega-kernel's
delayed sweep (nothing reads phi in between), so its chunk
(``kernels.train_chunk``) is this one's reference on one device. The state
between the steps is the mega-kernel's layout (``train_chunk.ChunkState``,
one seed), with phi's rows the rank's own; the Adamax bias ``1 - b1^count``
is a running product and the scheduler steps as in the mega-kernel
(``_chunk_optim``).

``step_partials`` takes its plain version (:func:`step_partials_plain`) for
CPU tensors only. On a CUDA tensor it launches the kernel or raises; every
launch adds one to ``step_partials.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from desmo_tpu_torch import device as device_mod
from desmo_tpu_torch.kernels import _build, train_chunk
from desmo_tpu_torch.kernels._chunk_optim import _BETA, _LAM, _LR0, _POW, B1, _adamax_, sched_step_
from desmo_tpu_torch.models import fourier
from desmo_tpu_torch.train import ChunkFn, TrainState

def supports_sharded(spec, cfg) -> bool:
    """Whether the sharded chunk runs this configuration: exactly the
    single-device mega-kernel's configurations (``train_chunk.supports``),
    as ``desmo_tpu.pallas.shard_step.supports_sharded`` answers."""
    return train_chunk.supports(spec, cfg)


def split_sums(flat: torch.Tensor, K: int, m: int, r: int) -> tuple[torch.Tensor, ...]:
    """Views of the summed partials (:func:`step_partials`' ``flat``):
    ``ax`` (K, m), ``ga`` (K, K), ``latg`` (r, r), ``gcoef`` (K,) and
    ``gomega`` (3r,)."""
    ax, ga, latg, gcoef, gomega = torch.split(flat, [K * m, K * K, r * r, K, 3 * r])
    return ax.view(K, m), ga.view(K, K), latg.view(r, r), gcoef, gomega


def step_partials_plain(pod, x, phi, b, gb, coef, omega, spec, n_total: int):
    """The kernel's function in plain PyTorch, the arithmetic of one epoch of
    ``train_chunk.train_chunk_plain`` up to its sums over rows, over the
    rows given: ``pod`` (n, r), ``x`` (n, m) and ``phi`` (r, n) of the rank,
    ``b`` (K, m), ``gb`` = B Bᵀ (K, K), ``coef`` (K,) and ``omega`` (3r,)
    whole; ``n_total`` is the global row count of ``dA``'s 2/(n_total m).
    Returns ``(dl, flat, max_arg)``: ``dl`` (n, r) without the ortho term,
    the partial sums in one buffer (:func:`split_sums`) and max |omega *
    lat| (1,), in the inputs' floating type."""
    n, m = x.shape
    r, P = spec.r, spec.poly_order
    T = spec.num_poly_terms
    nm = float(n_total * m)
    F = torch.as_tensor(spec.factor_table(), dtype=torch.int64, device=x.device)
    lat = pod * phi.T  # (n, r)
    gathered = torch.cat([torch.ones((n, 1), dtype=lat.dtype, device=x.device), lat], dim=1)[:, F]  # (n, T, P)
    theta = gathered[..., 0]
    for p in range(1, P):
        theta = theta * gathered[..., p]
    lat3 = lat.repeat(1, 3)  # column k*r + j holds lat_j
    args = lat3 * omega[None, :]
    a_sin, a_cos, a_tanh = args[:, :r], args[:, r:2 * r], args[:, 2 * r:]
    th = torch.tanh(a_tanh)
    D = torch.cat([theta, torch.sin(a_sin), torch.cos(a_cos), th], dim=1)  # (n, K)
    A = D * coef[None, :]
    xb, ax, ga, latg = x @ b.T, A.T @ x, A.T @ A, lat.T @ lat
    dA = (2.0 / nm) * (A @ gb - xb)
    dD = dA * coef[None, :]
    gcoef = (dA * D).sum(0)
    darg = dD[:, T:] * torch.cat([torch.cos(a_sin), -torch.sin(a_cos), 1.0 - th * th], dim=1)
    gomega = (darg * lat3).sum(0)
    dl = (darg * omega[None, :]).view(n, 3, r).sum(1)
    dl_aug = torch.zeros((n, r + 1), dtype=lat.dtype, device=x.device)
    for p in range(P):  # product rule: d theta_t / d aug_F[t,p] = prod_{q != p} aug_F[t,q]
        others = dD[:, :T]
        for q in range(P):
            if q != p:
                others = others * gathered[..., q]
        dl_aug.index_add_(1, F[:, p], others)
    dl = dl + dl_aug[:, 1:]
    flat = torch.cat([ax.reshape(-1), ga.reshape(-1), latg.reshape(-1), gcoef, gomega])
    return dl, flat, torch.max(torch.abs(args)).reshape(1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("shard_step")
    lib.desmo_step_grid.argtypes = [ctypes.c_int] * 3
    lib.desmo_step_grid.restype = ctypes.c_int
    lib.desmo_step_workspace.argtypes = [ctypes.c_int] * 4
    lib.desmo_step_workspace.restype = ctypes.c_longlong
    lib.desmo_step_partials.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.desmo_step_partials.restype = ctypes.c_int
    return lib


@functools.cache
def _grid(device_index: int, r: int, P: int, K: int) -> int:
    """Blocks of the cooperative launch on this device: one per SM when one
    fits there; raises when the device cannot launch it."""
    with torch.cuda.device(device_index):
        grid = _lib().desmo_step_grid(r, P, K)
    if grid <= 0:
        raise RuntimeError(
            "step_partials: no cooperative launch on this device "
            f"(CUDA error {-grid}: cooperative launch unsupported or no block fits an SM)"
        )
    return grid


@functools.cache
def _column_table(spec, device: torch.device) -> torch.Tensor:
    """The one-seed column table of ``train_chunk.column_table``, on ``device``."""
    return torch.as_tensor(train_chunk.column_table(spec, 1), device=device).contiguous()


def _check(pod, x, phi, b, gb, coef, omega, spec, n_total: int) -> None:
    n, m = x.shape
    r = spec.r
    K = spec.num_poly_terms + 3 * r
    if not (r <= train_chunk.MAX_R and spec.poly_order <= train_chunk.MAX_P and K <= train_chunk.MAX_K):
        raise ValueError(f"step_partials: unsupported shape r={r}, P={spec.poly_order}, K={K}")
    for name, t, shape in (("x", x, (n, m)), ("pod", pod, (n, r)), ("phi", phi, (r, n)), ("b", b, (K, m)),
                           ("gb", gb, (K, K)), ("coef", coef, (K,)), ("omega", omega, (3 * r,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"step_partials: {name} must be a contiguous float32 tensor of shape {shape}, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
        if t.device != x.device:
            raise ValueError(f"step_partials: {name} on {t.device}, x on {x.device}")
    if not 1 <= n <= n_total:
        raise ValueError(f"step_partials: {n} rows of n_total={n_total}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"step_partials: unsupported device {x.device}")


def step_partials(pod, x, phi, b, gb, coef, omega, spec, n_total: int):
    """One step's forward and gradient partials over the rows given, in one
    launch of ``csrc/shard_step.cu``; the arguments and results of
    :func:`step_partials_plain`, which runs instead for CPU tensors."""
    _check(pod, x, phi, b, gb, coef, omega, spec, n_total)
    if x.device.type == "cpu":
        return step_partials_plain(pod, x, phi, b, gb, coef, omega, spec, n_total)
    n, m = x.shape
    r, P = spec.r, spec.poly_order
    K = spec.num_poly_terms + 3 * r
    lib = _lib()
    grid = _grid(x.device.index, r, P, K)
    with torch.cuda.device(x.device):
        f32 = dict(dtype=torch.float32, device=x.device)
        dl = torch.empty((n, r), **f32)
        flat = torch.empty((K * m + K * K + r * r + K + 3 * r,), **f32)
        max_arg = torch.empty((1,), **f32)
        work = torch.empty((lib.desmo_step_workspace(n, r, K, grid),), **f32)
        ctab = _column_table(spec, x.device)
        rc = lib.desmo_step_partials(
            pod.data_ptr(), x.data_ptr(), phi.data_ptr(), b.data_ptr(), gb.data_ptr(), coef.data_ptr(),
            omega.data_ptr(), ctab.data_ptr(), dl.data_ptr(), flat.data_ptr(), max_arg.data_ptr(), work.data_ptr(),
            n, m, r, P, K, n_total, grid, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"step_partials: kernel launch failed with CUDA error {rc}")
    step_partials.launches += 1
    return dl, flat, max_arg


def make_sharded_fused_chunk(spec, cfg, mesh) -> ChunkFn:
    """``chunk(state, batch, num_steps) -> (state, metrics)`` running each
    step as one :func:`step_partials` launch on this rank's rows and an
    all-reduce over ``mesh`` (``parallel.make_mesh``), the contract of
    ``train.fit(chunk=...)``. ``batch`` is this rank's
    (``parallel.shard_batch``): its rows of ``x`` and ``pod_modes``, and the
    global ``x_sq``; ``state`` holds its rows of phi and of phi's moments,
    (r, n_loc), and they stay there. The metrics are (num_steps,) tensors
    ``rec``, ``ortho``, ``l1``, ``total`` and ``max_arg``, equal on every
    rank, as is every other part of the state."""
    if not supports_sharded(spec, cfg):
        raise ValueError(f"sharded mega-kernel does not support preset {cfg.name!r}")
    nf = train_chunk.n_fourier(spec, cfg)
    r = spec.r
    T = spec.num_poly_terms
    K = T + 3 * r
    n, m = spec.n, spec.m
    nm = float(n * m)

    def chunk(state: TrainState, batch: dict, num_steps: int):
        if num_steps < 1:
            raise ValueError(f"sharded chunk needs num_steps >= 1, got {num_steps}")
        device_mod.fp32_matmul()
        x, pod, x_sq = batch["x"], batch["pod_modes"], batch["x_sq"]
        if tuple(x.shape[1:]) != (m,) or tuple(state.params["phi"].shape) != (r, x.shape[0]):
            raise ValueError(
                f"sharded chunk: x {tuple(x.shape)} and phi {tuple(state.params['phi'].shape)} are not this rank's "
                f"rows of the spec's (n, m) = ({n}, {m})"
            )
        stacked = train_chunk.stack_seed(state)
        cs = train_chunk.pack_seeds(stacked, [cfg.beta], [cfg.l1_lambda])
        phi, phi_mu, phi_nu = cs.phi.unbind(0)  # (r, n_loc) each
        if nf:
            zc, zc_mu, zc_nu = cs.series.unbind(0)
            per, per_mu, per_nu = cs.periods.unbind(0)
            tw = torch.as_tensor(fourier.TWO_PI * fourier.t_points(m), device=x.device)  # float32 2 pi t
        else:
            bm, b_mu, b_nu = cs.b.unbind(0)
        c, c_mu, c_nu = cs.coef.unbind(0)
        om, om_mu, om_nu = cs.omega.unbind(0)
        sv = cs.svec
        beta, lam = sv[0, _BETA], sv[0, _LAM]
        offdiag = 1.0 - torch.eye(r, dtype=torch.float32, device=x.device)
        rows, maxargs = [], []
        for _ in range(num_steps):
            if nf:
                bm, harmonics, th_b = train_chunk.series_forward(zc, per, tw)
            gb = bm @ bm.T
            dl, flat, max_arg = step_partials(pod, x, phi, bm, gb, c, om, spec, n)
            # max_arg is a max over the ranks: reduced before the sum of the rest
            mesh.all_reduce(max_arg, "max")
            mesh.all_reduce(flat, "sum")
            ax, ga, latg, gcoef, gomega = split_sums(flat, K, m, r)
            # metrics of the pre-update parameters
            rec = (torch.sum(ga * gb) - 2.0 * torch.sum(ax * bm) + x_sq) / nm
            ortho = 0.5 * torch.sum(torch.abs(latg * offdiag))
            l1 = torch.sum(torch.abs(c))
            total = rec + beta * ortho + lam * l1
            rows.append(torch.stack([rec, ortho, l1, total]))
            maxargs.append(max_arg)
            # the ortho term of phi's gradient, from the summed Gram's sign
            lat = pod * phi.T
            g_phi = ((dl + beta * (lat @ (torch.sign(latg) * offdiag))) * pod).T
            g_coef = gcoef + lam * torch.sign(c)
            g_b = (2.0 / nm) * (ga @ bm - ax)
            # Adamax with the LRs in force before this step's scheduler step
            bias = 1.0 - sv[0, _POW] * B1
            lrs = sv[0, _LR0:_LR0 + 5].clone()
            _adamax_(c, c_mu, c_nu, g_coef, lrs[0], bias)
            _adamax_(phi, phi_mu, phi_nu, g_phi, lrs[1], bias)
            if nf:
                g_zc, g_per = train_chunk.series_backward(g_b, zc, per, harmonics, th_b)
                _adamax_(zc, zc_mu, zc_nu, g_zc, lrs[2], bias)
                _adamax_(per, per_mu, per_nu, g_per, lrs[4], bias)
            else:
                _adamax_(bm, b_mu, b_nu, g_b, lrs[2], bias)
            _adamax_(om, om_mu, om_nu, gomega, lrs[3], bias)
            sched_step_(sv, total.reshape(1), cfg)
        out = train_chunk.seed_view(train_chunk.unpack_seeds(cs, stacked, num_steps), 0)
        mets = torch.stack(rows)
        metrics = {k: mets[:, i] for i, k in enumerate(train_chunk.METRICS[:4])}
        metrics["max_arg"] = torch.cat(maxargs)
        return out, metrics

    return chunk


step_partials.launches = 0
