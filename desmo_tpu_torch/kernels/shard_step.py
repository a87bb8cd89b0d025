"""One optimizer step of DESMO per kernel launch, with the rows sharded over
the ranks of a ``space`` mesh. Port of ``desmo_tpu/pallas/shard_step.py``
(``_make_step_kernel``, ``supports_sharded``, ``make_sharded_fused_chunk``,
``supports_sharded_packed``, ``make_sharded_fused_ensemble_chunk``), desmo
and Fourier forms, one seed or S seed-packed models.

Rank k owns a contiguous block of rows (``parallel.row_range``): its rows of
X, of the POD modes and of phi with phi's Adamax moments. A chunk of
``num_steps`` steps is ``num_steps`` launches of ``csrc/shard_step.cu``
(:func:`step`), each followed by one SUM all-reduce of its partial sums, and
one launch more that runs the prologue alone. Launch s:

1. (s > 0, the prologue) the replicated update of step s - 1 from its
   all-reduced sums, the same on every rank: the metrics row s - 1 of the
   pre-update parameters; the Adamax of B (Fourier: of the series and the
   periods, through ``series_backward``), of c (with ``lam * sign(c)``) and
   of omega; the plateau scheduler; and the row-local phi Adamax, whose
   ortho term ``beta * lat (sign(latᵀlat) * offdiag)`` needs the summed
   latent Gram and step s - 1's ``dl``;
2. (the rows) B (Fourier: from the series, ``series_forward``), ``gb = B
   Bᵀ``, and over the rank's rows the latent gradient ``dl`` without the
   ortho term and the partial sums ``ax = AᵀX``, ``ga = AᵀA``, the latent
   Gram ``latᵀlat``, the coefficient gradient ``sum(dA * D)`` and the omega
   gradient into one buffer; ``dA`` is normalised by the global ``n m``,
   never by the rank's row count. ``max |omega * lat|`` goes to row s of a
   (num_steps,) buffer, which one MAX all-reduce per chunk reduces over the
   ranks.

The packed form trains S models side by side as the packed mega-kernel
does (``kernels.train_chunk``): seed s owns its block of K columns, only the
seeds' diagonal blocks of ``gb`` and ``ga`` exist, and the latent Gram,
rec, l1 and ``sum(ax * B)`` are per seed, so one seed's NaN reaches no other
seed's metrics; each seed has its own LRs, beta, lambda, plateau scheduler
and metrics row, and ``max_arg`` is the max over every seed. The plain
version is S one-seed steps sharing the read of X.

Updating phi at the start of the next launch equals the single-device
mega-kernel's delayed sweep (nothing reads phi in between), so its chunk
(``kernels.train_chunk``) is this one's reference on one device. The state
between the steps is the mega-kernel's layout (``train_chunk.ChunkState``),
with phi's rows the rank's own; the Adamax bias ``1 - b1^count``
is a running product and the scheduler steps as in the mega-kernel
(``_chunk_optim``). Everything a launch reads or writes is allocated once a
chunk (:class:`StepBuffers`), the step counter on the device, so on the card
the chunk captures one step, the launch and its all-reduce, as a CUDA graph
(:func:`capture`) and replays it: the host's part of a step, a launch and
an NCCL call from Python, can take longer than the launch on a busy host.

``step`` takes its plain version (:func:`step_plain`) for CPU buffers only.
On CUDA buffers it launches the kernel or raises; every launch adds one to
``step.launches``, and so does every replay of a captured step
(:func:`run_steps`). :func:`step_partials` runs the partials alone from
given parameters, for the tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from desmo_tpu_torch import device as device_mod
from desmo_tpu_torch.kernels import _build, train_chunk
from desmo_tpu_torch.kernels._chunk_optim import _BETA, _LAM, _LR0, _POW, B1, SVEC, _adamax_, sched_step_
from desmo_tpu_torch.models import fourier
from desmo_tpu_torch.train import ChunkFn, TrainState

# the metrics rows the prologue writes; the chunk adds max_arg
ROW_METRICS = train_chunk.METRICS[:4]
# the kernel clock's counters, in the order of ``enum Phase`` in the source:
# from the launch's start, its Layout and tables; the prologue's update and
# its B Bᵀ reduction with block 0's finalize; the
# rows phase (the last part takes in the wait at its grid barrier); the
# partials' reduction; block 0's AᵀX partial, the wait at the AᵀX split's
# barrier and the owners' sums
PHASES = (
    "setup", "update", "gram", "rows.dictionary", "rows.xb", "rows.gradients", "rows.barrier", "reduce", "ax", "ax.barrier",
    "ax.sum",
)


def supports_sharded(spec, cfg) -> bool:
    """Whether the sharded chunk runs this configuration: exactly the
    single-device mega-kernel's configurations (``train_chunk.supports``),
    as ``desmo_tpu.pallas.shard_step.supports_sharded`` answers."""
    return train_chunk.supports(spec, cfg)


def supports_sharded_packed(spec, cfg, n_seeds: int) -> bool:
    """Whether the sharded chunk runs ``n_seeds`` packed models of this
    configuration: the sharded chunk's variants and the packed
    mega-kernel's bounds (``train_chunk.supports_packed``), as
    ``desmo_tpu.pallas.shard_step.supports_sharded_packed`` answers."""
    return supports_sharded(spec, cfg) and train_chunk.supports_packed(spec, cfg, n_seeds)


def sums_size(K: int, m: int, r: int, n_seeds: int = 1) -> int:
    """Floats of the partial sums' buffer of ``n_seeds`` seeds of K columns
    each (:func:`split_seed_sums`)."""
    return n_seeds * (K * m + K * K + r * r + K + 3 * r)


def split_seed_sums(flat: torch.Tensor, K: int, m: int, r: int, n_seeds: int) -> tuple[torch.Tensor, ...]:
    """Views of the summed partials of S = ``n_seeds`` seeds of K columns
    each: ``ax`` (S K, m), the seeds' diagonal blocks of ``ga`` (S, K, K),
    their latent Grams ``latg`` (S, r, r), ``gcoef`` (S K,) and ``gomega``
    (3 S r,), seed s at rows, columns and slots of its own block."""
    S = n_seeds
    ax, ga, latg, gcoef, gomega = torch.split(flat, [S * K * m, S * K * K, S * r * r, S * K, 3 * S * r])
    return ax.view(S * K, m), ga.view(S, K, K), latg.view(S, r, r), gcoef, gomega


def split_sums(flat: torch.Tensor, K: int, m: int, r: int) -> tuple[torch.Tensor, ...]:
    """Views of one seed's summed partials (:func:`step_partials`' ``flat``):
    ``ax`` (K, m), ``ga`` (K, K), ``latg`` (r, r), ``gcoef`` (K,) and
    ``gomega`` (3r,)."""
    ax, ga, latg, gcoef, gomega = split_seed_sums(flat, K, m, r, 1)
    return ax, ga[0], latg[0], gcoef, gomega


def step_partials_plain(pod, x, phi, b, gb, coef, omega, spec, n_total: int):
    """The rows part of the kernel's function in plain PyTorch, the arithmetic
    of one epoch of ``train_chunk.train_chunk_plain`` up to its sums over
    rows, over the rows given: ``pod`` (n, r), ``x`` (n, m) and ``phi`` (r, n)
    of the rank, ``b`` (K, m), ``gb`` = B Bᵀ (K, K), ``coef`` (K,) and
    ``omega`` (3r,) whole; ``n_total`` is the global row count of ``dA``'s
    2/(n_total m). Returns ``(dl, flat, max_arg)``: ``dl`` (n, r) without the
    ortho term, the partial sums in one buffer (:func:`split_sums`) and max
    |omega * lat| (1,), in the inputs' floating type."""
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


@dataclasses.dataclass
class StepBuffers:
    """Everything the launches of one chunk read and write, allocated once
    (:func:`make_buffers`); a launch updates them in place. ``cs`` is the
    state of S packed seeds (S = 1: one model) in the kernel's layout, its
    phi the rank's rows; ``count`` is the step counter s, the launches with
    rows so far (int32, on the device: a captured step reads it there).
    ``xp`` (X padded to rows of a multiple of 8 floats), ``work``, ``ctab``
    (:func:`kernel_table`) and ``tpts`` are the kernel's, None on the CPU;
    ``tw`` (2 pi t) is the plain Fourier form's."""

    cs: train_chunk.ChunkState
    pod: torch.Tensor  # (n, r)
    x: torch.Tensor  # (n, m)
    x_sq: torch.Tensor  # () sum(X * X) over every rank's rows
    sums: torch.Tensor  # (sums_size,) this step's partials; all-reduced between launches
    dl: torch.Tensor  # (n, S r) the last partials' dl
    gb: torch.Tensor  # (S, K, K) the seeds' blocks of B Bᵀ of the B the last partials used
    met: torch.Tensor  # (num_steps, S, 4) rec, ortho, l1, total
    max_arg: torch.Tensor  # (num_steps,)
    count: torch.Tensor  # (1,) int32
    n_total: int
    nf: int
    cfg: object  # the RunConfig of the scheduler (None: no update runs)
    xp: torch.Tensor | None = None
    work: torch.Tensor | None = None
    ctab: torch.Tensor | None = None
    tpts: torch.Tensor | None = None
    tw: torch.Tensor | None = None
    args: tuple | None = dataclasses.field(default=None, repr=False)  # the kernel's arguments, made at first launch

    @property
    def seeds(self) -> int:
        return self.cs.svec.shape[0]

    def clone(self) -> StepBuffers:
        """A copy of the buffers that a launch changes (the state, sums, dl,
        gb, the metrics and max_arg rows, the counter), sharing the rest."""
        cs = train_chunk.ChunkState(**{f.name: None if getattr(self.cs, f.name) is None else
                                       getattr(self.cs, f.name).clone() for f in dataclasses.fields(self.cs)})
        changed = {k: getattr(self, k).clone() for k in ("sums", "dl", "gb", "met", "max_arg", "count")}
        return dataclasses.replace(self, cs=cs, args=None, **changed)

    def to(self, device, dtype) -> StepBuffers:
        """A copy of the buffers on ``device`` with the floating ones in
        ``dtype`` (the counter stays int32), for the plain version: the
        kernel's own buffers are left out."""

        def conv(t):
            return None if t is None else t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype,
                                               copy=True)

        cs = train_chunk.ChunkState(**{f.name: conv(getattr(self.cs, f.name))
                                       for f in dataclasses.fields(train_chunk.ChunkState)})
        keep = {"xp", "work", "ctab", "tpts", "tw", "n_total", "nf", "cfg", "cs", "args"}
        out = StepBuffers(cs=cs, n_total=self.n_total, nf=self.nf, cfg=self.cfg,
                          **{f.name: conv(getattr(self, f.name)) for f in dataclasses.fields(self)
                             if f.name not in keep})
        if self.nf:
            out.tw = _tw(self.x.shape[1], torch.device(device))
        return out


def _tw(m: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(fourier.TWO_PI * fourier.t_points(m), device=device)  # float32 2 pi t


def make_buffers(cs: train_chunk.ChunkState, batch: dict, num_steps: int, spec, cfg, n_total: int) -> StepBuffers:
    """The buffers of a chunk of ``num_steps`` steps from the state ``cs`` of
    S packed seeds (``train_chunk.pack_seeds``, used in place) and this
    rank's ``batch`` (``x``, ``pod_modes``, the global ``x_sq``); the counter
    starts at 0, so the first launch runs the partials alone. On the card:
    X's padded copy, the scratch (its clock zeroed), the column table and the
    t points."""
    x, pod = batch["x"], batch["pod_modes"]
    n, m = x.shape
    S = cs.svec.shape[0]
    r = spec.r
    K = spec.num_poly_terms + 3 * r
    nf = 0 if cs.series is None else (cs.series.shape[2] - 1) // 2
    dev = x.device
    f = dict(dtype=cs.phi.dtype, device=dev)
    buf = StepBuffers(
        cs=cs, pod=pod, x=x, x_sq=batch["x_sq"], sums=torch.zeros((sums_size(K, m, r, S),), **f),
        dl=torch.zeros((n, S * r), **f), gb=torch.zeros((S, K, K), **f),
        met=torch.zeros((num_steps, S, len(ROW_METRICS)), **f), max_arg=torch.zeros((num_steps,), **f),
        count=torch.zeros((1,), dtype=torch.int32, device=dev), n_total=n_total, nf=nf, cfg=cfg,
    )
    if dev.type == "cuda":
        mp = (m + 7) // 8 * 8
        buf.xp = torch.zeros((n, mp), **f)
        buf.xp[:, :m] = x
        grid = _grid(dev.index, r, spec.poly_order, K, S, nf)
        lib = _lib()
        buf.work = torch.empty((lib.desmo_step_workspace(n, m, r, K, S, nf, grid),), **f)
        off = lib.desmo_step_timer_offset(n, m, r, K, S, nf, grid)
        buf.work[off:off + 2 * len(PHASES)] = 0.0
        buf.ctab = _kernel_table(spec, S, dev)
        if nf:
            buf.tpts = torch.as_tensor(fourier.t_points(m), device=dev)
    if nf:
        buf.tw = _tw(m, dev)
    return buf


def packed_seed(cs: train_chunk.ChunkState, q: int, r: int, K: int) -> train_chunk.ChunkState:
    """Seed q of the packed state ``cs`` as a one-seed state of views."""
    ks = slice(q * K, (q + 1) * K)

    def rows(t):
        return None if t is None else t[:, ks]

    return train_chunk.ChunkState(phi=cs.phi[:, q * r:(q + 1) * r], coef=cs.coef[:, ks],
                                  omega=cs.omega[:, 3 * q * r:3 * (q + 1) * r], svec=cs.svec[q:q + 1],
                                  b=rows(cs.b), series=rows(cs.series), periods=rows(cs.periods))


def step_plain(buf: StepBuffers, spec, rows: bool = True) -> None:
    """The kernel's function in plain PyTorch, in place on ``buf``: with the
    counter s > 0 the update of step s - 1 from the summed partials in
    ``buf.sums`` (each seed's metrics row s - 1, the Adamax of c, phi, B or
    the series and periods, and omega, then the schedulers' step), then,
    with ``rows``, step s's partials (:func:`step_partials_plain`, one seed
    at a time) with gb, dl, the sums and max_arg row s, and the counter
    advanced. The arithmetic of each seed's update, in order, is the one the
    chunk ran after each step's partials before the kernel took it over."""
    cs, x, pod = buf.cs, buf.x, buf.pod
    s = int(buf.count)
    m = x.shape[1]
    r = spec.r
    K = spec.num_poly_terms + 3 * r
    S = buf.seeds
    nm = float(buf.n_total * m)
    sv = cs.svec
    seeds = [packed_seed(cs, q, r, K) for q in range(S)]
    if s > 0:
        offdiag = 1.0 - torch.eye(r, dtype=x.dtype, device=x.device)
        ax_all, ga_all, latg_all, gcoef_all, gomega_all = split_seed_sums(buf.sums, K, m, r, S)
        totals = []
        for q, sd in enumerate(seeds):
            phi, phi_mu, phi_nu = sd.phi.unbind(0)  # (r, n_loc) each
            if buf.nf:
                zc, zc_mu, zc_nu = sd.series.unbind(0)
                per, per_mu, per_nu = sd.periods.unbind(0)
                bm, harmonics, th_b = train_chunk.series_forward(zc, per, buf.tw)
            else:
                bm, b_mu, b_nu = sd.b.unbind(0)
            c, c_mu, c_nu = sd.coef.unbind(0)
            om, om_mu, om_nu = sd.omega.unbind(0)
            beta, lam = sv[q, _BETA], sv[q, _LAM]
            ax, ga, latg = ax_all[q * K:(q + 1) * K], ga_all[q], latg_all[q]
            gcoef, gomega = gcoef_all[q * K:(q + 1) * K], gomega_all[3 * q * r:3 * (q + 1) * r]
            # metrics of the pre-update parameters
            rec = (torch.sum(ga * buf.gb[q]) - 2.0 * torch.sum(ax * bm) + buf.x_sq) / nm
            ortho = 0.5 * torch.sum(torch.abs(latg * offdiag))
            l1 = torch.sum(torch.abs(c))
            total = rec + beta * ortho + lam * l1
            buf.met[s - 1, q] = torch.stack([rec, ortho, l1, total])
            totals.append(total)
            # the ortho term of phi's gradient, from the summed Gram's sign
            lat = pod * phi.T
            g_phi = ((buf.dl[:, q * r:(q + 1) * r] + beta * (lat @ (torch.sign(latg) * offdiag))) * pod).T
            g_coef = gcoef + lam * torch.sign(c)
            g_b = (2.0 / nm) * (ga @ bm - ax)
            # Adamax with the LRs in force before this step's scheduler step
            bias = 1.0 - sv[q, _POW] * B1
            lrs = sv[q, _LR0:_LR0 + 5].clone()
            _adamax_(c, c_mu, c_nu, g_coef, lrs[0], bias)
            _adamax_(phi, phi_mu, phi_nu, g_phi, lrs[1], bias)
            if buf.nf:
                g_zc, g_per = train_chunk.series_backward(g_b, zc, per, harmonics, th_b)
                _adamax_(zc, zc_mu, zc_nu, g_zc, lrs[2], bias)
                _adamax_(per, per_mu, per_nu, g_per, lrs[4], bias)
            else:
                _adamax_(bm, b_mu, b_nu, g_b, lrs[2], bias)
            _adamax_(om, om_mu, om_nu, gomega, lrs[3], bias)
        sched_step_(sv, torch.stack(totals), buf.cfg)
    if rows:
        parts = []
        for q, sd in enumerate(seeds):
            bm = train_chunk.series_forward(sd.series[0], sd.periods[0], buf.tw)[0] if buf.nf else sd.b[0]
            buf.gb[q].copy_(bm @ bm.T)
            parts.append(step_partials_plain(pod, x, sd.phi[0], bm, buf.gb[q], sd.coef[0], sd.omega[0], spec,
                                             buf.n_total))
        buf.dl.copy_(torch.cat([dl for dl, _, _ in parts], dim=1))
        pieces = [split_seed_sums(flat, K, m, r, 1) for _, flat, _ in parts]
        buf.sums.copy_(torch.cat([piece[i].reshape(-1) for i in range(5) for piece in pieces]))
        buf.max_arg[s] = torch.max(torch.cat([max_arg for _, _, max_arg in parts]))
        buf.count += 1



def plain_trace(state: TrainState, batch: dict, num_steps: int, spec, cfg, dtype=torch.float64) -> dict:
    """The metrics rows (``ROW_METRICS``) of ``num_steps`` epochs of one seed
    from ``state`` through :func:`step_plain` in ``dtype`` on the batch's
    device: ``num_steps + 1`` calls, the last one's update writing the last
    row. In float64 it is the exact trajectory that the float32 versions
    part from by rounding; in float32 on the CPU it is
    ``train_chunk.train_chunk_plain``'s trace."""
    cs = train_chunk.pack_seeds(train_chunk.stack_seed(state), *train_chunk.seed_hypers(cfg, 1))
    buf = make_buffers(cs, batch, num_steps + 1, spec, cfg, batch["x"].shape[0]).to(batch["x"].device, dtype)
    for _ in range(num_steps + 1):
        step_plain(buf, spec)
    return {k: buf.met[:num_steps, 0, i] for i, k in enumerate(ROW_METRICS)}

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("shard_step")
    lib.desmo_step_grid.argtypes = [ctypes.c_int] * 5
    lib.desmo_step_grid.restype = ctypes.c_int
    lib.desmo_step_workspace.argtypes = [ctypes.c_int] * 7
    lib.desmo_step_workspace.restype = ctypes.c_longlong
    lib.desmo_step_timer_offset.argtypes = [ctypes.c_int] * 7
    lib.desmo_step_timer_offset.restype = ctypes.c_longlong
    lib.desmo_step.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 12 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    lib.desmo_step.restype = ctypes.c_int
    return lib


@functools.cache
def _grid(device_index: int, r: int, P: int, K: int, seeds: int, nf: int) -> int:
    """Blocks of the cooperative launch on this device: one per SM when one
    fits there; raises when the device cannot launch it. Sets the kernel's
    shared memory limit on the device, which a launch needs."""
    with torch.cuda.device(device_index):
        grid = _lib().desmo_step_grid(r, P, K, seeds, nf)
    if grid <= 0:
        raise RuntimeError(
            "shard_step.step: no cooperative launch on this device "
            f"(CUDA error {-grid}: cooperative launch unsupported or no block fits an SM)"
        )
    return grid


def kernel_table(spec, n_seeds: int = 1) -> np.ndarray:
    """The kernel's int32 table of the shape: the column table of
    ``train_chunk.column_table`` (S K, 4 + P) for S = ``n_seeds``, then the
    polynomial backward's lane lists: the offsets ``d_off`` (S r + 1) and,
    for each latent lane j in turn, the entries ``k P + p`` (ascending) whose
    factor p of polynomial column k is lane j + 1 (S K P, zero beyond their
    count)."""
    ct = train_chunk.column_table(spec, n_seeds)
    K, P = ct.shape[0], ct.shape[1] - 4
    lanes = [[e for e in range(K * P) if ct[e // P, 1] == 0 and ct[e // P, 4 + e % P] == j + 1]
             for j in range(n_seeds * spec.r)]
    d_tp = np.zeros(K * P, np.int32)
    flat = [e for lane in lanes for e in lane]
    d_tp[:len(flat)] = flat
    d_off = np.cumsum([0] + [len(lane) for lane in lanes]).astype(np.int32)
    return np.concatenate([ct.reshape(-1), d_off, d_tp])


@functools.cache
def _kernel_table(spec, n_seeds: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(kernel_table(spec, n_seeds), device=device).contiguous()


def _launch_args(buf: StepBuffers, spec) -> tuple[tuple, tuple]:
    """The arguments of ``desmo_step`` before and after its rows flag, from
    buffers that stay where they are for the chunk."""
    x, cs, cfg = buf.x, buf.cs, buf.cfg
    n, m = x.shape
    r, P = spec.r, spec.poly_order
    K = spec.num_poly_terms + 3 * r
    grid = _grid(x.device.index, r, P, K, buf.seeds, buf.nf)

    def ptr(t):
        return None if t is None else t.data_ptr()

    sched = (1, 0.0, 1.0, 0.0) if cfg is None else (int(cfg.sched_every), float(cfg.patience),
                                                    float(cfg.sched_factor), float(cfg.sched_min_lr))
    head = (buf.pod.data_ptr(), buf.xp.data_ptr(), buf.x_sq.data_ptr(), buf.ctab.data_ptr(), ptr(buf.tpts),
            cs.phi.data_ptr(), ptr(cs.b), ptr(cs.series), ptr(cs.periods), cs.coef.data_ptr(), cs.omega.data_ptr(),
            cs.svec.data_ptr(), buf.sums.data_ptr(), buf.dl.data_ptr(), buf.gb.data_ptr(), buf.met.data_ptr(),
            buf.max_arg.data_ptr(), buf.count.data_ptr(), buf.work.data_ptr(), n, m, r, P, K, buf.seeds, buf.nf,
            buf.n_total)
    return head, (sched[0], buf.met.shape[0], grid) + sched[1:]


def step(buf: StepBuffers, spec, rows: bool = True) -> None:
    """One launch of ``csrc/shard_step.cu`` on ``buf`` (in place): the
    update from the previous step's summed partials when the counter is
    above 0, then, with ``rows``, this step's partials; the function of
    :func:`step_plain`, which runs instead for CPU buffers. A launch made
    while a CUDA graph captures the stream launches nothing and is not
    counted (:func:`capture`)."""
    x = buf.x
    if x.device.type == "cpu":
        step_plain(buf, spec, rows)
        return
    if x.device.type != "cuda" or buf.cs.phi.dtype != torch.float32:
        raise ValueError(f"shard_step.step: needs float32 buffers on the CPU or a CUDA device, got "
                         f"{buf.cs.phi.dtype} on {x.device}")
    if buf.args is None:
        buf.args = _launch_args(buf, spec)
    head, tail = buf.args
    with torch.cuda.device(x.device):
        rc = _lib().desmo_step(*head, int(rows), *tail, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"shard_step.step: kernel launch failed with CUDA error {rc}")
    if not torch.cuda.is_current_stream_capturing():
        step.launches += 1


def run_steps(buf: StepBuffers, spec, mesh, num_steps: int) -> None:
    """A chunk's launches on ``buf``: ``num_steps`` steps, each one launch
    and one SUM all-reduce of its partials over ``mesh``; then the prologue
    alone for the last step's update, and one MAX all-reduce of the
    max_arg rows. On the card the first step runs as it is (its all-reduce
    sets up the communicator) and the rest replay a CUDA graph of one step
    (:func:`capture`), each replay counted as the launch it makes; on the
    CPU the same loop runs the plain versions."""
    step(buf, spec)
    mesh.all_reduce(buf.sums, "sum")
    if buf.x.device.type == "cuda" and num_steps > 1:
        graph = capture(buf, spec, mesh)
        for _ in range(num_steps - 1):
            graph.replay()
            step.launches += 1
    else:
        for _ in range(num_steps - 1):
            step(buf, spec)
            mesh.all_reduce(buf.sums, "sum")
    step(buf, spec, rows=False)
    mesh.all_reduce(buf.max_arg, "max")


def capture(buf: StepBuffers, spec, mesh) -> torch.cuda.CUDAGraph:
    """A CUDA graph of one step on the card's buffers ``buf``, its launch
    and the SUM all-reduce of its partials over ``mesh``; each replay runs
    the next step, as the device counter says. Captured on a side stream,
    as ``torch.cuda.graph`` captures, without its garbage collection and
    cache release (tens of ms a chunk). The communicator must have run an
    all-reduce before; the capture runs no step."""
    graph, side, main = torch.cuda.CUDAGraph(), torch.cuda.Stream(buf.x.device), torch.cuda.current_stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        graph.capture_begin()
        step(buf, spec)
        mesh.all_reduce(buf.sums, "sum")
        graph.capture_end()
    main.wait_stream(side)
    return graph


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
    """One step's forward and gradient partials over the rows given, from
    these parameters (B given as it is, in any form): on the card one launch
    of :func:`step` with the counter at 0 (the partials alone), which forms
    B Bᵀ itself; :func:`step_partials_plain`, which takes ``gb`` as given,
    for CPU tensors. Returns ``(dl, flat, max_arg)``."""
    _check(pod, x, phi, b, gb, coef, omega, spec, n_total)
    if x.device.type == "cpu":
        return step_partials_plain(pod, x, phi, b, gb, coef, omega, spec, n_total)

    def state(t):
        return torch.stack([t, torch.zeros_like(t), torch.zeros_like(t)]).contiguous()

    cs = train_chunk.ChunkState(phi=state(phi), coef=state(coef), omega=state(omega), b=state(b),
                                svec=torch.zeros((1, SVEC), dtype=torch.float32, device=x.device))
    buf = make_buffers(cs, {"x": x, "pod_modes": pod, "x_sq": torch.zeros((), device=x.device)}, 1, spec, None,
                       n_total)
    step(buf, spec)
    return buf.dl, buf.sums, buf.max_arg


def run_chunk(spec, cfg, mesh, state: TrainState, batch: dict, num_steps: int, betas=None, lams=None):
    """One chunk of :func:`make_sharded_fused_chunk` from one model's
    ``state``, or of :func:`make_sharded_fused_ensemble_chunk` from a stacked
    state of S seeds (phi (S, r, n_loc)) with the seeds' ``betas``/``lams``
    (the config's by default); returns ``(state, metrics, buffers)``."""
    if num_steps < 1:
        raise ValueError(f"sharded chunk needs num_steps >= 1, got {num_steps}")
    device_mod.fp32_matmul()
    r = spec.r
    x = batch["x"]
    packed = state.params["phi"].dim() == 3
    stacked = state if packed else train_chunk.stack_seed(state)
    S = stacked.params["phi"].shape[0]
    if tuple(x.shape[1:]) != (spec.m,) or tuple(stacked.params["phi"].shape[1:]) != (r, x.shape[0]):
        raise ValueError(
            f"sharded chunk: x {tuple(x.shape)} and phi {tuple(state.params['phi'].shape)} are not this rank's "
            f"rows of the spec's (n, m) = ({spec.n}, {spec.m})"
        )
    cs = train_chunk.pack_seeds(stacked, *train_chunk.seed_hypers(cfg, S, betas, lams))
    buf = make_buffers(cs, batch, num_steps, spec, cfg, spec.n)
    run_steps(buf, spec, mesh, num_steps)
    out = train_chunk.unpack_seeds(cs, stacked, num_steps)
    metrics = train_chunk._seed_metrics(buf.met, buf.max_arg)
    if packed:
        return out, metrics, buf
    return train_chunk.seed_view(out, 0), train_chunk._one_seed_metrics(metrics), buf


def make_sharded_fused_chunk(spec, cfg, mesh) -> ChunkFn:
    """``chunk(state, batch, num_steps) -> (state, metrics)`` running each
    step as one :func:`step` launch on this rank's rows and one all-reduce
    over ``mesh`` (``parallel.make_mesh``), the contract of
    ``train.fit(chunk=...)``. ``batch`` is this rank's
    (``parallel.shard_batch``): its rows of ``x`` and ``pod_modes``, and the
    global ``x_sq``; ``state`` holds its rows of phi and of phi's moments,
    (r, n_loc), and they stay there. The metrics are (num_steps,) tensors
    ``rec``, ``ortho``, ``l1``, ``total`` and ``max_arg``, equal on every
    rank, as is every other part of the state."""
    if not supports_sharded(spec, cfg):
        raise ValueError(f"sharded mega-kernel does not support preset {cfg.name!r}")

    def chunk(state: TrainState, batch: dict, num_steps: int):
        out, metrics, _ = run_chunk(spec, cfg, mesh, state, batch, num_steps)
        return out, metrics

    return chunk


def make_sharded_fused_ensemble_chunk(spec, cfg, mesh, n_seeds: int, betas=None, lams=None) -> ChunkFn:
    """The packed form of :func:`make_sharded_fused_chunk`: ``chunk(state,
    batch, num_steps) -> (state, metrics)`` for S = ``n_seeds`` seeds, a
    drop-in for ``ensemble.make_ensemble_chunk``. ``state`` is the stacked
    state of ``ensemble.init_state`` with phi and its moments (S, r, n_loc),
    this rank's rows, which stay there; ``betas``/``lams`` (length S) are the
    seeds' loss weights, the config's by default. The metrics are ``rec``,
    ``ortho``, ``l1`` and ``total_s`` (num_steps, S), ``total`` their sum over
    the seeds and ``max_arg`` (num_steps,), the max over every seed, equal on
    every rank."""
    S = int(n_seeds)
    if not supports_sharded_packed(spec, cfg, S):
        raise ValueError(f"sharded seed-packed kernel does not support preset {cfg.name!r} at S={S} "
                         "(see supports_sharded_packed)")
    betas, lams = train_chunk.seed_hypers(cfg, S, betas, lams)

    def chunk(state: TrainState, batch: dict, num_steps: int):
        if tuple(state.params["phi"].shape[:1]) != (S,) or state.params["phi"].dim() != 3:
            raise ValueError(f"sharded ensemble chunk of {S} seeds: phi {tuple(state.params['phi'].shape)} is not "
                             "a stacked state's (S, r, n_loc)")
        out, metrics, _ = run_chunk(spec, cfg, mesh, state, batch, num_steps, betas, lams)
        return out, metrics

    return chunk


def phase_split(spec, cfg, mesh, state: TrainState, batch: dict, num_steps: int) -> dict:
    """Seconds of a chunk's launches by part (``PHASES``), from the kernel's
    own clock, summed over its ``num_steps + 1`` launches: block 0's thread
    reads the card's global timer at each mark, so a part inside a phase is
    block 0's own time and a phase's last part takes in the wait at its grid
    barrier. ``state`` is one model's, or a stacked state of S seeds (the
    packed form). Needs the card; the launches count like any other."""
    if batch["x"].device.type != "cuda":
        raise ValueError("phase_split: needs CUDA tensors, the plain version has no phases")
    return clock(run_chunk(spec, cfg, mesh, state, batch, num_steps)[2], spec)


def clock(buf: StepBuffers, spec) -> dict:
    """Seconds by part (``PHASES``) of the kernel's own clock, summed over
    every launch on the card's buffers ``buf`` so far (:func:`phase_split`);
    the sum over the parts is each launch's time from its entry to its end
    in block 0. Synchronizes with the device."""
    if buf.work is None:
        raise ValueError("shard_step.clock: needs the card's buffers, the plain version has no clock")
    n, m = buf.x.shape
    r, P, K = spec.r, spec.poly_order, spec.num_poly_terms + 3 * spec.r
    grid = _grid(buf.x.device.index, r, P, K, buf.seeds, buf.nf)
    off = _lib().desmo_step_timer_offset(n, m, r, K, buf.seeds, buf.nf, grid)
    ns = buf.work[off:off + 2 * len(PHASES)].view(torch.int64).cpu().tolist()
    return {name: t * 1e-9 for name, t in zip(PHASES, ns)}


step.launches = 0
