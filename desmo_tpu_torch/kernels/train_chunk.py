"""A whole training chunk of DESMO in one kernel launch, for one model or S
seed-packed models. Port of ``desmo_tpu/pallas/train_chunk.py``
(``_make_kernel``, ``make_fused_train_chunk``, ``make_fused_ensemble_chunk``,
``supports``, ``supports_packed``, ``select_chunk``,
``select_ensemble_chunk``), desmo and Fourier forms.

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

The packed form trains S models (``ensemble.py``) that share one read of X:
seed s owns columns ``[s K, (s+1) K)`` of the packed width S K, and every
Gram, gradient and metric runs over the seed's own block, so the seeds'
trajectories are those each would follow alone. Each seed has its own
scheduler row, its own beta and lambda (the hyperparameter multi-start) and
its own metrics; the Adamax count and the epoch are shared. A single model
is the packed form at S = 1.

The state travels in the kernel's layout (:class:`ChunkState`): phi and its
moments as one (3, S r, n) tensor; B and its moments (3, S K, m) (desmo) or
the series ``z ‖ z_trig`` (3, S K, 2nF+1) and the periods ``period ‖
trig_period`` (3, S K) with their moments (Fourier); the coefficients ``c ‖
c_trig`` (3, S K), omega (3, 3 S r) and one 16-slot scheduler vector per seed
(group LRs, best, b1^count, count, num_bad, epoch, beta, lambda).

``fused_train_chunk`` (one model) and ``fused_ensemble_chunk`` (S seeds,
a stacked state) take the plain version (:func:`train_chunk_plain`,
:func:`train_chunk_plain_packed`: the same arithmetic written out in
PyTorch) for CPU tensors only. On a CUDA tensor they launch
``csrc/train_chunk.cu`` or raise; every launch adds one to the wrapper's
``launches``. ``contract_probe`` runs the kernel's two contractions with X
alone (its own X·Bᵀ and AᵀX routines, in one launch), a test entry off the
training path that holds them against float64 on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import time

import numpy as np
import torch

from desmo_tpu_torch import device as device_mod
from desmo_tpu_torch import library, optim, profiling
from desmo_tpu_torch.kernels import _build, ae_chunk
from desmo_tpu_torch.kernels._chunk_optim import (
    _BEST, _BETA, _LAM, _LR0, _NUMBAD, _POW, B1, SVEC, _adamax_, sched_step_,
)
from desmo_tpu_torch.models import fourier
from desmo_tpu_torch.train import ChunkFn, TrainState

METRICS = ("rec", "ortho", "l1", "total", "max_arg")
# the packed form's per-seed metrics, each (num_steps, S); it adds "total"
# (their sum over the seeds) and the global "max_arg", as the TPU kernel does
SEED_METRICS = ("rec", "ortho", "l1", "total_s")
MAX_K, MAX_R, MAX_P, MAX_NF = 128, 8, 8, 63
# the TPU kernel's cap of packed seeds (its scheduler block has 8 rows); the
# port keeps it so that both packages select the same path
MAX_SEEDS = 8
# the column table's leading entries: seed, kind, latent lane, omega slot
_CT = 4


def n_fourier(spec, cfg) -> int:
    """The Fourier form's harmonics nF, 0 for the desmo form."""
    return int(getattr(spec, "n_fourier", 0)) if getattr(cfg, "variant", "desmo") == "fourier" else 0


def supports(spec, cfg) -> bool:
    """Whether the mega-kernel runs this configuration, the answer of
    ``desmo_tpu.pallas.train_chunk.supports``: the desmo or Fourier variant
    with K = T + 3r <= 128, P <= 8 and r <= 8, and for Fourier
    1 <= nF <= 63."""
    return supports_packed(spec, cfg, 1)


def supports_packed(spec, cfg, n_seeds: int) -> bool:
    """Whether the packed mega-kernel runs ``n_seeds`` models of this
    configuration, the answer of
    ``desmo_tpu.pallas.train_chunk.supports_packed``: the desmo or Fourier
    variant (1 <= nF <= 63), S K <= 128, 1 + S r <= 128, S <= 8, P <= 8 and
    r <= 8."""
    variant = getattr(cfg, "variant", "desmo")
    if variant == "fourier":
        if not 1 <= getattr(spec, "n_fourier", 0) <= MAX_NF:
            return False
    elif variant != "desmo":
        return False
    if n_seeds < 1:
        return False
    r, P = spec.r, spec.poly_order
    K = library.num_poly_terms(r, P) + 3 * r
    return (n_seeds * K <= MAX_K and 1 + n_seeds * r <= MAX_K and n_seeds <= MAX_SEEDS
            and P <= MAX_P and r <= MAX_R)


def _kernel_allowed(cfg, device: torch.device) -> bool:
    """'auto' takes a kernel on a CUDA device when the loss method is 'auto'
    or 'fused', and the eager loop on the CPU, as the JAX package scans off
    the TPU."""
    return torch.device(device).type == "cuda" and getattr(cfg, "loss_method", "auto") in ("auto", "fused")


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
    package scans off the TPU. The AE variant has a kernel of its own
    (``kernels.ae_chunk.select_ae_chunk``): 'megakernel' takes it, 'auto'
    keeps the eager loop, as the JAX package does."""
    if getattr(cfg, "variant", "desmo") == "ae":
        return ae_chunk.select_ae_chunk(spec, cfg)
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
    if not _kernel_allowed(cfg, device) or not supports(spec, cfg):
        return None
    return make_chunk(spec, cfg)


def select_ensemble_chunk(spec, cfg, n_seeds: int, device: torch.device, betas=None, lams=None, device_mesh=None):
    """The packed chunk policy of
    ``desmo_tpu.pallas.train_chunk.select_ensemble_chunk``: the packed
    mega-kernel's chunk (:func:`fused_ensemble_chunk`), or None for the
    packed eager loop (``ensemble.make_ensemble_chunk``). ``betas``/``lams``
    (length ``n_seeds``) are the seeds' loss weights.

    'scan' is always the eager loop; 'megakernel' requires the kernel
    (``ValueError`` when the seeds do not pack; on the CPU it runs the plain
    version); 'auto' takes it on a CUDA device, the eager loop on the CPU.
    Under a ``device_mesh`` (``parallel.make_mesh``) the kernel is the
    sharded step's packed form
    (``kernels.shard_step.make_sharded_fused_ensemble_chunk``), which 'auto'
    takes on any device when the loss method is 'auto' or 'fused', as the
    one-seed sharded chunk is taken (``runner.select_sharded_chunk``); its
    plain version runs on the CPU."""
    method = getattr(cfg, "chunk_method", "auto")
    if method == "scan":
        return None
    if method not in ("megakernel", "auto"):
        raise ValueError(f"unknown chunk_method {method!r}")
    if device_mesh is not None:
        from desmo_tpu_torch.kernels import shard_step

        if not shard_step.supports_sharded_packed(spec, cfg, n_seeds):
            if method == "megakernel":
                raise ValueError(
                    f"chunk_method='megakernel' with a device mesh but preset {cfg.name!r} at S={n_seeds} has no "
                    "sharded seed-packed kernel — see kernels.shard_step.supports_sharded_packed"
                )
            return None
        if method == "auto" and getattr(cfg, "loss_method", "auto") not in ("auto", "fused"):
            return None
        return shard_step.make_sharded_fused_ensemble_chunk(spec, cfg, device_mesh, n_seeds, betas=betas, lams=lams)
    if method == "megakernel":
        if not supports_packed(spec, cfg, n_seeds):
            raise ValueError(
                f"chunk_method='megakernel' but {n_seeds} seeds don't pack for preset {cfg.name!r} "
                "— see kernels.train_chunk.supports_packed"
            )
    elif not _kernel_allowed(cfg, device) or not supports_packed(spec, cfg, n_seeds):
        return None

    def chunk(state: TrainState, batch: dict, num_steps: int):
        return fused_ensemble_chunk(state, batch, num_steps, spec, cfg, betas=betas, lams=lams)

    return chunk


def column_table(spec, n_seeds: int) -> np.ndarray:
    """The kernel's (S K, 4 + P) int32 column table: per packed column its
    seed, kind (0 polynomial, 1 sin, 2 cos, 3 tanh), latent lane in
    ``[1 | lat_0 | lat_1 | ...]`` (``1 + s r + j``), omega slot
    (``s 3r + kind r + j``), then the P factor lanes of a polynomial column
    (``ensemble.packed_factor_table``'s entries; 0 is the constant one). At
    S = 1: columns [0, T) polynomial, [T, K) trig, as the single-seed
    kernel's layout."""
    r, P = spec.r, spec.poly_order
    F = library.factor_table(r, P)
    T = F.shape[0]
    K = T + 3 * r
    tab = np.zeros((n_seeds * K, _CT + P), np.int32)
    for s in range(n_seeds):
        rows = tab[s * K:(s + 1) * K]
        rows[:, 0] = s
        rows[:T, _CT:] = np.where(F > 0, F + s * r, 0)
        q = np.arange(3 * r)
        rows[T:, 1] = 1 + q // r
        rows[T:, 2] = 1 + s * r + q % r
        rows[T:, 3] = s * 3 * r + q
    return tab


def seed_hypers(cfg, n_seeds: int, betas=None, lams=None) -> tuple[np.ndarray, np.ndarray]:
    """Each seed's (beta, lambda) as float32 arrays: ``betas``/``lams`` when
    given, else the config's."""
    out = []
    for vals, default in ((betas, cfg.beta), (lams, cfg.l1_lambda)):
        arr = np.full(n_seeds, default, np.float32) if vals is None else np.asarray(vals, np.float32)
        if arr.shape != (n_seeds,):
            raise ValueError(f"per-seed loss weights must have shape ({n_seeds},), got {arr.shape}")
        out.append(arr)
    return out[0], out[1]


@dataclasses.dataclass
class ChunkState:
    """Training state of S packed seeds in the kernel's layout; the kernel
    updates it in place. The desmo form holds ``b``, the Fourier form
    ``series`` and ``periods``."""

    phi: torch.Tensor  # (3, S r, n): phi, its Adamax mu and nu
    coef: torch.Tensor  # (3, S K): per seed c ‖ c_trig (kind-major), mu, nu
    omega: torch.Tensor  # (3, 3 S r): per seed omega (kind-major), mu, nu
    svec: torch.Tensor  # (S, SVEC): group LRs, best, b1^count, count, num_bad, epoch, beta, lambda
    b: torch.Tensor | None = None  # (3, S K, m): B = [z; z_trig] per seed, mu, nu
    series: torch.Tensor | None = None  # (3, S K, 2nF+1): [z; z_trig] coefficients, mu, nu
    periods: torch.Tensor | None = None  # (3, S K): period ‖ trig_period, mu, nu


def stack_seed(state: TrainState) -> TrainState:
    """A one-model state as a stacked state of one seed (views)."""
    sched = state.sched
    return TrainState(
        params={k: v[None] for k, v in state.params.items()},
        mu={k: v[None] for k, v in state.mu.items()},
        nu={k: v[None] for k, v in state.nu.items()},
        count=state.count,
        sched=optim.PlateauState(sched.lrs[None], sched.best.reshape(1), sched.num_bad.reshape(1)),
        epoch=state.epoch,
    )


def seed_view(state: TrainState, s: int) -> TrainState:
    """Seed ``s`` of a stacked state as a one-model state (views)."""
    sched = state.sched
    return TrainState(
        params={k: v[s] for k, v in state.params.items()},
        mu={k: v[s] for k, v in state.mu.items()},
        nu={k: v[s] for k, v in state.nu.items()},
        count=state.count,
        sched=optim.PlateauState(sched.lrs[s], sched.best[s], sched.num_bad[s]),
        epoch=state.epoch,
    )


def pack_seeds(state: TrainState, betas, lams) -> ChunkState:
    """A new :class:`ChunkState` holding a copy of the stacked ``state``
    (every leaf with a leading seed axis, the scheduler's lrs (S, G), best
    and num_bad (S,)) and the seeds' loss weights; builds no host sync
    (count and epoch are host ints)."""
    trees = (state.params, state.mu, state.nu)
    S = state.params["phi"].shape[0]
    width = state.params["z"].shape[2]  # m, or the Fourier form's 2nF+1

    def stack(fn):
        return torch.stack([fn(t).to(torch.float32) for t in trees]).contiguous()

    phi = stack(lambda t: t["phi"].reshape(-1, t["phi"].shape[2]))
    temporal = stack(lambda t: torch.cat([t["z"], t["z_trig"].reshape(S, -1, width)], 1).reshape(-1, width))
    if "period" in state.params:
        form = dict(
            series=temporal,
            periods=stack(lambda t: torch.cat([t["period"], t["trig_period"].reshape(S, -1)], 1).reshape(-1)),
        )
    else:
        form = dict(b=temporal)
    coef = stack(lambda t: torch.cat([t["c"], t["c_trig"].reshape(S, -1)], 1).reshape(-1))
    omega = stack(lambda t: t["omega"].reshape(-1))
    sched = state.sched
    dev = phi.device
    f32 = dict(dtype=torch.float32, device=dev)
    pow0 = float(np.float32(B1) ** np.float32(state.count))
    nlr = sched.lrs.shape[1]

    def column(v):
        return torch.as_tensor(v, **f32).reshape(S, 1)

    svec = torch.cat([
        sched.lrs.to(torch.float32),
        torch.zeros((S, _BEST - nlr), **f32),
        column(sched.best),
        torch.tensor([[pow0, float(state.count)]], **f32).expand(S, 2),
        column(sched.num_bad.to(torch.float32)),
        torch.full((S, 1), float(state.epoch), **f32),
        column(np.asarray(betas, np.float32)),
        column(np.asarray(lams, np.float32)),
        torch.zeros((S, SVEC - _LAM - 1), **f32),
    ], dim=1).contiguous()
    return ChunkState(phi=phi, coef=coef, omega=omega, svec=svec, **form)


def unpack_seeds(cs: ChunkState, like: TrainState, num_steps: int) -> TrainState:
    """The stacked :class:`TrainState` after a chunk of ``num_steps`` epochs
    that started from ``like``; parameters are views into ``cs``."""
    S = cs.svec.shape[0]
    rs, n = cs.phi.shape[1:]
    r = rs // S
    K = cs.coef.shape[1] // S
    T = K - 3 * r
    temporal = cs.b if cs.series is None else cs.series
    width = temporal.shape[2]

    def tree(i):
        co = cs.coef[i].view(S, K)
        tm = temporal[i].view(S, K, width)
        out = {
            "phi": cs.phi[i].view(S, r, n),
            "c": co[:, :T],
            "z": tm[:, :T],
            "z_trig": tm[:, T:].reshape(S, 3, r, width),
            "c_trig": co[:, T:].reshape(S, 3, r),
            "omega": cs.omega[i].view(S, 3, r),
        }
        if cs.periods is not None:
            pe = cs.periods[i].view(S, K)
            out["period"] = pe[:, :T]
            out["trig_period"] = pe[:, T:].reshape(S, 3, r)
        return out

    params, mu, nu = (tree(i) for i in range(3))
    keys = list(like.params)
    nlr = like.sched.lrs.shape[-1]
    sched = optim.PlateauState(
        lrs=cs.svec[:, _LR0:_LR0 + nlr].clone(),
        best=cs.svec[:, _BEST].clone(),
        num_bad=cs.svec[:, _NUMBAD].to(torch.int32),
    )
    return TrainState(
        params={k: params[k] for k in keys},
        mu={k: mu[k] for k in keys},
        nu={k: nu[k] for k in keys},
        count=like.count + num_steps,
        sched=sched,
        epoch=like.epoch + num_steps,
    )


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


def train_chunk_plain_packed(state: TrainState, batch: dict, num_steps: int, spec, cfg, betas=None, lams=None):
    """The packed chunk in plain PyTorch: the kernel's arithmetic step by
    step, batched over the seeds (every product over a seed's own block),
    with the analytic gradients (no autograd). ``state`` is stacked (a
    leading seed axis on every leaf); ``betas``/``lams`` (length S) default
    to the config's. Returns ``(state, metrics)`` like
    :func:`fused_ensemble_chunk`."""
    device_mod.fp32_matmul()
    S = state.params["phi"].shape[0]
    with profiling.span("chunk.pack"):
        cs = pack_seeds(state, *seed_hypers(cfg, S, betas, lams))
    x, pod, x_sq = batch["x"], batch["pod_modes"], batch["x_sq"]
    n, m = x.shape
    r, P = spec.r, spec.poly_order
    T = spec.num_poly_terms
    K = T + 3 * r
    nm = float(n * m)
    F = torch.as_tensor(spec.factor_table(), dtype=torch.int64, device=x.device)
    offdiag = 1.0 - torch.eye(r, dtype=torch.float32, device=x.device)
    ones = torch.ones((S, n, 1), dtype=torch.float32, device=x.device)
    phi, phi_mu, phi_nu = (v.view(S, r, n) for v in cs.phi.unbind(0))
    if cs.series is None:
        bm, b_mu, b_nu = (v.view(S, K, m) for v in cs.b.unbind(0))
    else:
        nc = cs.series.shape[2]
        zc, zc_mu, zc_nu = (v.view(S, K, nc) for v in cs.series.unbind(0))
        per, per_mu, per_nu = (v.view(S, K) for v in cs.periods.unbind(0))
        tw = torch.as_tensor(fourier.TWO_PI * fourier.t_points(m), device=x.device)  # float32 2 pi t
    c, c_mu, c_nu = (v.view(S, K) for v in cs.coef.unbind(0))
    om, om_mu, om_nu = (v.view(S, 3 * r) for v in cs.omega.unbind(0))
    sv = cs.svec
    beta, lam = sv[:, _BETA], sv[:, _LAM]
    rows, maxargs = [], []
    with profiling.span("chunk.enqueue"):  # the plain epochs, in the launch's place
        for _ in range(num_steps):
            # forward of the generation-s parameters
            if cs.series is not None:
                flat, harmonics, th_b = series_forward(zc.reshape(S * K, nc), per.reshape(-1), tw)
                bm = flat.view(S, K, m)
            lat = pod[None] * phi.transpose(1, 2)  # (S, n, r)
            gathered = torch.cat([ones, lat], dim=2)[:, :, F]  # (S, n, T, P)
            theta = gathered[..., 0]
            for p in range(1, P):
                theta = theta * gathered[..., p]
            lat3 = lat.repeat(1, 1, 3)  # column k*r + j holds lat_j
            args = lat3 * om[:, None, :]
            a_sin, a_cos, a_tanh = args[..., :r], args[..., r:2 * r], args[..., 2 * r:]
            th = torch.tanh(a_tanh)
            D = torch.cat([theta, torch.sin(a_sin), torch.cos(a_cos), th], dim=2)  # (S, n, K)
            A = D * c[:, None, :]
            # contractions, each over the seed's own block, as one 2-D product
            # per seed (on the GPU cuBLAS's batched products of these shapes
            # part from the 2-D ones by about 1e-5 of rec)
            gb, xb, ax, ga, latg = (torch.stack(t) for t in zip(*(
                (bm[s] @ bm[s].T, x @ bm[s].T, A[s].T @ x, A[s].T @ A[s], lat[s].T @ lat[s]) for s in range(S))))
            # gradients
            dA = (2.0 / nm) * (A @ gb - xb)
            dD = dA * c[:, None, :]
            g_coef = (dA * D).sum(1) + lam[:, None] * torch.sign(c)
            darg = dD[..., T:] * torch.cat([torch.cos(a_sin), -torch.sin(a_cos), 1.0 - th * th], dim=2)
            g_om = (darg * lat3).sum(1)
            dl = (darg * om[:, None, :]).view(S, n, 3, r).sum(2)
            dl_aug = torch.zeros((S, n, r + 1), dtype=torch.float32, device=x.device)
            for p in range(P):  # product rule: d theta_t / d aug_F[t,p] = prod_{q != p} aug_F[t,q]
                others = dD[..., :T]
                for q in range(P):
                    if q != p:
                        others = others * gathered[..., q]
                dl_aug.index_add_(2, F[:, p], others)
            dl = dl + dl_aug[..., 1:]
            ortho_dir = lat @ (torch.sign(latg) * offdiag)
            g_phi = ((dl + beta[:, None, None] * ortho_dir) * pod[None]).transpose(1, 2)
            g_b = (2.0 / nm) * (ga @ bm - ax)
            # metrics of the pre-update parameters, per seed
            rec = (torch.sum(ga * gb, (1, 2)) - 2.0 * torch.sum(ax * bm, (1, 2)) + x_sq) / nm
            ortho = 0.5 * torch.sum(torch.abs(latg * offdiag), (1, 2))
            l1 = torch.sum(torch.abs(c), 1)
            total = rec + beta * ortho + lam * l1
            rows.append(torch.stack([rec, ortho, l1, total], dim=1))
            maxargs.append(torch.max(torch.abs(args)))
            # Adamax with each seed's LRs in force before this step's scheduler step
            powb = sv[0, _POW] * B1
            bias = 1.0 - powb
            lrs = sv[:, _LR0:_LR0 + 5].clone()
            _adamax_(c, c_mu, c_nu, g_coef, lrs[:, 0:1], bias)
            _adamax_(phi, phi_mu, phi_nu, g_phi, lrs[:, 1, None, None], bias)
            if cs.series is None:
                _adamax_(bm, b_mu, b_nu, g_b, lrs[:, 2, None, None], bias)
            else:
                g_zc, g_per = series_backward(g_b.reshape(S * K, m), zc.reshape(S * K, nc), per.reshape(-1),
                                              harmonics, th_b)
                _adamax_(zc, zc_mu, zc_nu, g_zc.view(S, K, nc), lrs[:, 2, None, None], bias)
                _adamax_(per, per_mu, per_nu, g_per.view(S, K), lrs[:, 4:5], bias)
            _adamax_(om, om_mu, om_nu, g_om, lrs[:, 3:4], bias)
            sched_step_(sv, total, cfg)  # the plateau schedulers, one per seed
    with profiling.span("chunk.unpack"):
        return unpack_seeds(cs, state, num_steps), _seed_metrics(torch.stack(rows), torch.stack(maxargs))


def _seed_metrics(per_seed: torch.Tensor, max_arg: torch.Tensor) -> dict:
    """The packed form's metrics from (num_steps, S, 4) per-seed rows and the
    (num_steps,) global max |omega * lat|."""
    out = {k: per_seed[:, :, i] for i, k in enumerate(SEED_METRICS)}
    out["total"] = out["total_s"].sum(1)
    out["max_arg"] = max_arg
    return out


def _one_seed_metrics(packed: dict) -> dict:
    """The packed metrics of S = 1 under the one-model names (``METRICS``)."""
    out = {k: packed[k][:, 0] for k in ("rec", "ortho", "l1")}
    out["total"] = packed["total_s"][:, 0]
    out["max_arg"] = packed["max_arg"]
    return out


def train_chunk_plain(state: TrainState, batch: dict, num_steps: int, spec, cfg):
    """The chunk of one model in plain PyTorch: :func:`train_chunk_plain_packed`
    at S = 1 with the config's beta and lambda. Returns ``(state, metrics)``
    like :func:`fused_train_chunk`; ``metrics`` holds (num_steps,) tensors."""
    out, mets = train_chunk_plain_packed(stack_seed(state), batch, num_steps, spec, cfg)
    return seed_view(out, 0), _one_seed_metrics(mets)


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(_build.load("train_chunk"))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/train_chunk.cu``."""
    lib.desmo_chunk_grid.argtypes = [ctypes.c_int] * 5
    lib.desmo_chunk_grid.restype = ctypes.c_int
    lib.desmo_chunk_workspace.argtypes = [ctypes.c_int] * 7
    lib.desmo_chunk_workspace.restype = ctypes.c_longlong
    lib.desmo_chunk_timer_offset.argtypes = [ctypes.c_int] * 7
    lib.desmo_chunk_timer_offset.restype = ctypes.c_longlong
    lib.desmo_chunk_sums_offset.argtypes = [ctypes.c_int] * 7
    lib.desmo_chunk_sums_offset.restype = ctypes.c_longlong
    lib.desmo_train_chunk.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    )
    lib.desmo_train_chunk.restype = ctypes.c_int
    return lib


@functools.cache
def _grid(device_index: int, r: int, P: int, k: int, seeds: int, nf: int) -> int:
    """Blocks of the cooperative launch on this device: one per SM when one
    fits there; raises when the device cannot launch it."""
    with torch.cuda.device(device_index):
        grid = _lib().desmo_chunk_grid(r, P, k, seeds, nf)
    if grid <= 0:
        raise RuntimeError(
            "fused_train_chunk: no cooperative launch on this device "
            f"(CUDA error {-grid}: cooperative launch unsupported or no block fits an SM)"
        )
    return grid


def _check(state: TrainState, batch: dict, spec, nf: int) -> None:
    """``state`` is stacked (a leading seed axis)."""
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
    phi = state.params["phi"]
    if tuple(phi.shape[1:]) != (r, n) or tuple(state.params["z"].shape[2:]) != (width,):
        raise ValueError(
            "fused_train_chunk: state does not match the batch's (n, m), the spec's r and its series length"
        )
    if nf and "period" not in state.params:
        raise ValueError("fused_train_chunk: the Fourier form needs the state's periods")
    if phi.device != x.device:
        raise ValueError(f"fused_train_chunk: state on {phi.device}, x on {x.device}")


def _checked_device(state: TrainState, batch: dict, num_steps: int, spec, cfg) -> str:
    """Checks a stacked ``state``; returns the device type."""
    if num_steps < 1:
        raise ValueError(f"fused_train_chunk needs num_steps >= 1, got {num_steps}")
    seeds = state.params["phi"].shape[0]
    if not supports_packed(spec, cfg, seeds):
        raise ValueError(f"fused_train_chunk: unsupported configuration {cfg.name!r} at {seeds} seed(s)")
    _check(state, batch, spec, n_fourier(spec, cfg))
    kind = batch["x"].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"fused_train_chunk: unsupported device {batch['x'].device}")
    return kind


def _launch(state: TrainState, batch: dict, num_steps: int, spec, cfg, betas, lams):
    """Pack and launch one chunk of the stacked ``state`` on the card (spans
    ``chunk.pack`` and ``chunk.enqueue``); returns the packed state, the
    metrics rows (num_steps, S, 5) and the scratch buffer. While tracing is
    on the launch's kernel clock is kept (``profiling.kernel_clock``)."""
    x = batch["x"]
    n, m = x.shape
    r, P, K = spec.r, spec.poly_order, spec.num_poly_terms + 3 * spec.r
    S = state.params["phi"].shape[0]
    nf = n_fourier(spec, cfg)
    lib = _lib()
    grid = _grid(x.device.index, r, P, K, S, nf)
    with profiling.span("chunk.pack"), torch.cuda.device(x.device):
        cs = pack_seeds(state, *seed_hypers(cfg, S, betas, lams))
        ctab = torch.as_tensor(column_table(spec, S), device=x.device).contiguous()
        tpts = torch.as_tensor(fourier.t_points(m), device=x.device) if nf else None
    with profiling.span("chunk.enqueue"), torch.cuda.device(x.device):
        f32 = dict(dtype=torch.float32, device=x.device)
        met = torch.empty((num_steps, S, len(METRICS)), **f32)
        work = torch.empty((lib.desmo_chunk_workspace(n, m, r, K, S, nf, grid),), **f32)
        stream = torch.cuda.current_stream(x.device).cuda_stream

        def ptr(t):
            return None if t is None else t.data_ptr()

        args = (
            batch["pod_modes"].data_ptr(), x.data_ptr(), batch["x_sq"].data_ptr(), ctab.data_ptr(),
            ptr(tpts), cs.phi.data_ptr(), ptr(cs.b), ptr(cs.series), ptr(cs.periods),
            cs.coef.data_ptr(), cs.omega.data_ptr(), cs.svec.data_ptr(), met.data_ptr(), work.data_ptr(),
            n, m, r, P, K, S, nf, num_steps, int(cfg.sched_every), grid,
            float(cfg.patience), float(cfg.sched_factor), float(cfg.sched_min_lr), stream,
        )
        launched = time.perf_counter() if profiling.tracing() else None
        rc = lib.desmo_train_chunk(*args)
        if rc != 0:
            raise RuntimeError(f"fused_train_chunk: kernel launch failed with CUDA error {rc}")
        if launched is not None:
            names = FOURIER_PHASES if nf else PHASES
            off = lib.desmo_chunk_timer_offset(n, m, r, K, S, nf, grid)
            profiling.kernel_clock(work[off:off + 2 * len(names)], names, launched)
    return cs, met, work


def _kernel_metrics(met: torch.Tensor) -> dict:
    return _seed_metrics(met[:, :, :4], met[:, 0, 4])


def fused_train_chunk(state: TrainState, batch: dict, num_steps: int, spec, cfg):
    """Run ``num_steps`` epochs of one model from ``state`` in one launch;
    returns ``(state, metrics)`` with (num_steps,) metric tensors ``rec``,
    ``ortho``, ``l1``, ``total`` and ``max_arg``. ``batch`` holds fp32 ``x``
    (n, m), ``pod_modes`` (n, r) and ``x_sq`` = sum(x*x)."""
    stacked = stack_seed(state)
    if _checked_device(stacked, batch, num_steps, spec, cfg) == "cpu":
        return train_chunk_plain(state, batch, num_steps, spec, cfg)
    cs, met, _ = _launch(stacked, batch, num_steps, spec, cfg, None, None)
    fused_train_chunk.launches += 1
    with profiling.span("chunk.unpack"):
        return seed_view(unpack_seeds(cs, stacked, num_steps), 0), _one_seed_metrics(_kernel_metrics(met))


def fused_ensemble_chunk(state: TrainState, batch: dict, num_steps: int, spec, cfg, betas=None, lams=None):
    """Run ``num_steps`` epochs of S packed seeds from the stacked ``state``
    (``ensemble.init_state``'s: a leading seed axis on every leaf, per-seed
    scheduler rows) in one launch; ``betas``/``lams`` (length S) are the
    seeds' loss weights, the config's by default. An S = 1 group takes the
    same kernel with its own beta and lambda (the TPU kernel's remainder-group
    rule). Returns ``(state, metrics)``: ``rec``, ``ortho``, ``l1`` and
    ``total_s`` (num_steps, S), ``total`` their sum over the seeds, and the
    global ``max_arg`` (num_steps,)."""
    if _checked_device(state, batch, num_steps, spec, cfg) == "cpu":
        return train_chunk_plain_packed(state, batch, num_steps, spec, cfg, betas, lams)
    cs, met, _ = _launch(state, batch, num_steps, spec, cfg, betas, lams)
    fused_ensemble_chunk.launches += 1
    with profiling.span("chunk.unpack"):
        return unpack_seeds(cs, state, num_steps), _kernel_metrics(met)


# the kernel clock's counters, in the order of ``enum Phase`` in the source;
# the "barrier" entries close their phase, the wait for the slowest block
# included ("columns.ax" is block 0's own AᵀX partial, "columns.ax_barrier"
# the wait for the split's other blocks). The Fourier form adds its series update and the B Bᵀ reduction
# after it (``FOURIER_PHASES``).
PHASES = (
    "prologue", "rows.dictionary", "rows.xb", "rows.gradients", "rows.barrier", "reduce",
    "columns.phi", "columns.ax", "columns.ax_barrier", "columns.barrier", "finalize",
)
FOURIER_PHASES = PHASES + ("series.update", "series.gram")


def phase_split(state: TrainState, batch: dict, num_steps: int, spec, cfg):
    """Seconds of one launch of ``num_steps`` epochs by part (``PHASES``, or
    ``FOURIER_PHASES`` for the Fourier form), from the kernel's own clock:
    block 0's thread reads the card's global timer at each mark, so a part
    inside a phase is block 0's own time and a phase's last part takes in the
    wait at its grid barrier. Summed over the epochs. ``state`` is one
    model's, or a stacked state of S seeds (the packed form). Needs the
    card; the launch counts like any other."""
    packed = state.params["phi"].dim() == 3
    stacked = state if packed else stack_seed(state)
    if _checked_device(stacked, batch, num_steps, spec, cfg) != "cuda":
        raise ValueError("phase_split: needs CUDA tensors, the plain chunk has no phases")
    _, _, work = _launch(stacked, batch, num_steps, spec, cfg, None, None)
    if packed:
        fused_ensemble_chunk.launches += 1
    else:
        fused_train_chunk.launches += 1
    n, m = batch["x"].shape
    K = spec.num_poly_terms + 3 * spec.r
    S = stacked.params["phi"].shape[0]
    nf = n_fourier(spec, cfg)
    names = FOURIER_PHASES if nf else PHASES
    grid = _grid(batch["x"].device.index, spec.r, spec.poly_order, K, S, nf)
    off = _lib().desmo_chunk_timer_offset(n, m, spec.r, K, S, nf, grid)
    ns = work[off:off + 2 * len(names)].view(torch.int64).cpu().tolist()
    return {name: t * 1e-9 for name, t in zip(names, ns)}


def epoch_sums(state: TrainState, batch: dict, spec, cfg, betas=None, lams=None) -> dict:
    """The summed partials of one epoch from ``state`` (one model's, or a
    stacked state of S seeds with their ``betas``/``lams``), read back from
    the kernel's scratch after a launch of one epoch: ``ga`` (S, Ks, Ks),
    the seeds' diagonal Gram blocks of A; ``latg`` (S, r, r); ``gcoef``
    (S Ks,) and ``gomega`` (3 S r,), the coefficient and omega gradients. A
    test entry, to hold the kernel's sums against a float64 reference
    (``kernels.shard_step.step_plain``); needs the card, and the launch
    counts like any other."""
    packed = state.params["phi"].dim() == 3
    stacked = state if packed else stack_seed(state)
    if _checked_device(stacked, batch, 1, spec, cfg) != "cuda":
        raise ValueError("epoch_sums: needs CUDA tensors, the plain chunk keeps no partial sums")
    _, _, work = _launch(stacked, batch, 1, spec, cfg, betas, lams)
    if packed:
        fused_ensemble_chunk.launches += 1
    else:
        fused_train_chunk.launches += 1
    n, m = batch["x"].shape
    r, Ks = spec.r, spec.num_poly_terms + 3 * spec.r
    S = stacked.params["phi"].shape[0]
    nf = n_fourier(spec, cfg)
    grid = _grid(batch["x"].device.index, r, spec.poly_order, Ks, S, nf)
    off = _lib().desmo_chunk_sums_offset(n, m, r, Ks, S, nf, grid)
    ga, latg, gcoef, gomega = torch.split(work[off:off + S * (Ks * Ks + r * r + Ks + 3 * r)],
                                          [S * Ks * Ks, S * r * r, S * Ks, 3 * S * r])
    return {"ga": ga.view(S, Ks, Ks), "latg": latg.view(S, r, r), "gcoef": gcoef, "gomega": gomega}


def contract_probe_plain(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor):
    """``(X Bᵀ (n, K), Aᵀ X (K, m))`` in plain PyTorch."""
    device_mod.fp32_matmul()
    return x @ b.T, a.T @ x


def contract_probe(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor):
    """``(X Bᵀ (n, K), Aᵀ X (K, m))`` from fp32 ``a`` (n, K), ``b`` (K, m)
    and ``x`` (n, m), through the mega-kernel's own contraction routines: X·Bᵀ
    over each block's rows as the rows phase forms it, AᵀX through the
    columns phase's 2-D split, in one cooperative launch. A test entry, off
    the training path, to hold the kernel's contractions against a float64
    reference on the card; on CPU tensors, the plain version."""
    n, k = a.shape
    m = x.shape[1]
    for name, t, shape in (("a", a, (n, k)), ("b", b, (k, m)), ("x", x, (n, m))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"contract_probe: {name} must be a contiguous float32 {shape} tensor on x's device")
    if not 1 <= k <= 128:
        raise ValueError(f"contract_probe: K={k} outside 1..128")
    if x.device.type == "cpu":
        return contract_probe_plain(a, b, x)
    if x.device.type != "cuda":
        raise ValueError(f"contract_probe: unsupported device {x.device}")
    lib = _lib()
    lib.desmo_chunk_probe_workspace.argtypes = [ctypes.c_int] * 4
    lib.desmo_chunk_probe_workspace.restype = ctypes.c_longlong
    lib.desmo_chunk_contract_probe.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.desmo_chunk_contract_probe.restype = ctypes.c_int
    grid = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        f32 = dict(dtype=torch.float32, device=x.device)
        xb, ax = torch.empty((n, k), **f32), torch.empty((k, m), **f32)
        work = torch.empty((lib.desmo_chunk_probe_workspace(n, m, k, grid),), **f32)
        rc = lib.desmo_chunk_contract_probe(
            a.data_ptr(), b.data_ptr(), x.data_ptr(), xb.data_ptr(), ax.data_ptr(), work.data_ptr(), n, m, k, grid,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"contract_probe: kernel launch failed with CUDA error {rc}")
    contract_probe.launches += 1
    return xb, ax


fused_train_chunk.launches = 0
fused_ensemble_chunk.launches = 0
contract_probe.launches = 0
