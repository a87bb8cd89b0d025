"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The module imports
no jax, so it runs on a machine that has none; ``tests/conftest.py`` does
import jax, so run it there with

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from desmo_tpu_torch import configs, ensemble, losses, parallel, pod, profiling, runner, train  # noqa: E402
from desmo_tpu_torch import device as device_mod  # noqa: E402
from desmo_tpu_torch.io import synthetic  # noqa: E402
from desmo_tpu_torch.kernels import ae_chunk, dual_gemm, shard_step, train_chunk  # noqa: E402
from desmo_tpu_torch.models import autoencoder, desmo, fourier  # noqa: E402

pytestmark = pytest.mark.gpu

# the shapes of tests/test_torch_dual_gemm.py, the cylinder preset's, and the
# packed widths of the ensemble's eager loss: fourier_cylinder S=8 (K'=96)
# and aneurysm S=4 (K'=108); and K'=128, the largest; the eager loss of
# fourier_cylinder and ae_cylinder (K=12)
SHAPES = [(100, 7, 50), (512, 47, 128), (700, 50, 333), (3961, 47, 1001), (3961, 96, 1001),
          (27000, 108, 1000), (600, 128, 77), (3961, 12, 1001)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, k, m, device, seed=0, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return tuple(
        (torch.randn(shape, generator=gen) * s).to(device)
        for shape, s in (((n, k), scale), ((k, m), scale), ((n, m), 1.0))
    )


@pytest.mark.parametrize("n,k,m", SHAPES)
def test_kernel_matches_twin(cuda, n, k, m):
    a, b, x = _inputs(n, k, m, cuda)
    launches = dual_gemm.dual_contractions.launches
    ax, xb = dual_gemm.dual_contractions(a, b, x)
    torch.cuda.synchronize()
    assert dual_gemm.dual_contractions.launches == launches + 1
    pax, pxb = dual_gemm.dual_contractions_plain(a, b, x)
    assert (ax - pax).abs().max() <= 5e-5 * pax.abs().max()
    assert (xb - pxb).abs().max() <= 5e-5 * pxb.abs().max()
    ax2, xb2 = dual_gemm.dual_contractions(a, b, x)
    assert torch.equal(ax, ax2) and torch.equal(xb, xb2)  # fixed-order reductions


@pytest.mark.parametrize("n,k,m", [(3961, 47, 1001), (3961, 12, 1001), (700, 50, 333)])
def test_kernel_on_rows_apart_matches_contiguous(cuda, n, k, m):
    """X as a view whose rows are padded to 16 bytes (the kernel's 16-byte
    copies where m is not a multiple of 4): the same bits as contiguous X,
    and float64 to 5e-6 of max|ref|."""
    a, b, x = _inputs(n, k, m, cuda)
    xv = torch.zeros((n, (m + 3) // 4 * 4), device=cuda)[:, :m]
    xv.copy_(x)
    assert xv.stride(0) % 4 == 0 and torch.equal(xv, x)
    ax, xb = dual_gemm.dual_contractions(a, b, x)
    axv, xbv = dual_gemm.dual_contractions(a, b, xv)
    assert torch.equal(ax, axv) and torch.equal(xb, xbv)
    rax, rxb = a.double().T @ x.double(), x.double() @ b.double().T
    assert (ax.double() - rax).abs().max() <= 5e-6 * rax.abs().max()
    assert (xb.double() - rxb).abs().max() <= 5e-6 * rxb.abs().max()


@pytest.mark.parametrize("k", [47, 12])
def test_fused_loss_grads_match_autograd_of_factored_mse(cuda, k):
    a, b, x = _inputs(3961, k, 1001, cuda, seed=1, scale=0.3)
    out = []
    for fn in (
        lambda a_, b_: dual_gemm.factored_mse_fused(a_, b_, x, torch.sum(x * x)),
        lambda a_, b_: losses.factored_mse(a_, b_, x),
    ):
        a_, b_ = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        val = fn(a_, b_)
        out.append((val.detach(),) + torch.autograd.grad(val, (a_, b_)))
    (v, da, db), (rv, rda, rdb) = out
    assert abs(float(v - rv)) <= 1e-4 * abs(float(rv))
    assert (da - rda).abs().max() <= 2e-4 * rda.abs().max()
    assert (db - rdb).abs().max() <= 2e-4 * rdb.abs().max()


def test_kernel_rejects_k_above_its_limit(cuda):
    a, b, x = _inputs(64, 129, 32, cuda)
    with pytest.raises(ValueError, match="K=129"):
        dual_gemm.dual_contractions(a, b, x)


def _chunk_problem(device, n, m, r, P, **over):
    """The cylinder preset's configuration at (n, m, r, P) on its synthetic
    data, POD init and all-ones params, with ``over`` applied."""
    cfg = dataclasses.replace(configs.get("cylinder"), n=n, m=m, r=r, poly_order=P, **over)
    x = synthetic.cylinder_wake(n, m, seed=cfg.seed)
    batch = runner.prepare_batch(x, pod.pod_host(x, r, device).modes, device)
    spec = desmo.DesmoSpec(n, m, r, P, cfg.omega_init)
    return cfg, spec, batch, train.init_state(desmo.Desmo(spec, device=device).params(), cfg)


@pytest.mark.parametrize(
    "n, m, k",
    # K at every KP form (32, 48, 64, 128); ragged slabs and row groups; the
    # cylinder's and aneurysm S=4's shapes
    [(100, 50, 7), (700, 333, 47), (513, 77, 60), (600, 130, 128), (3961, 1001, 47), (27000, 1000, 108)],
)
def test_contract_probe_matches_float64(cuda, n, m, k):
    """The mega-kernel's own X·Bᵀ and AᵀX routines (3xTF32 tiles) against
    the products in float64, to the step kernel's 5e-6 of max|ref|, with X
    centred over its rows and a constant column in A, so that the constant
    column's sums cancel; two launches bit-identical."""
    a, b, x = _inputs(n, k, m, cuda, seed=k)
    x = (x - x.mean(dim=0, keepdim=True)).contiguous()
    a[:, 0] = 1.0
    launches = train_chunk.contract_probe.launches
    xb, ax = train_chunk.contract_probe(a, b, x)
    xb2, ax2 = train_chunk.contract_probe(a, b, x)
    torch.cuda.synchronize()
    assert train_chunk.contract_probe.launches == launches + 2
    assert torch.equal(xb, xb2) and torch.equal(ax, ax2)
    for got, ref in ((xb, x.double() @ b.double().T), (ax, a.double().T @ x.double())):
        assert ((got.double() - ref).abs().max() / ref.abs().max()).item() <= 5e-6


@pytest.mark.parametrize(
    "n, m, r, P, steps",
    # the CPU suite's size; K=82 (the K <= 128 build); the cylinder preset;
    # the aneurysm preset's shape, which the TPU kernel streamed
    [(96, 40, 2, 2, 30), (200, 64, 4, 4, 10), (3961, 1001, 4, 3, 20), (27000, 1000, 4, 2, 10)],
)
def test_mega_kernel_matches_plain_chunk(cuda, n, m, r, P, steps):
    """omega_init=1 and lr_omega=1 keep the dynamics tame: the trace is held
    to 2e-4 (rec, l1, total) and the state to 2e-3 of each array's largest
    entry. Ortho starts at the rounding of an orthonormal Gram, whose sign
    steers phi, so the trajectories' ortho rows part; every metric, ortho
    included (plus the CPU suite's 1e-5 absolute), is held to 2e-4 on one
    epoch from the kernel's final state."""
    cfg, spec, batch, state = _chunk_problem(cuda, n, m, r, P, omega_init=1.0, lr_omega=1.0)
    launches = train_chunk.fused_train_chunk.launches
    sk, mk = train_chunk.fused_train_chunk(state, batch, steps, spec, cfg)
    torch.cuda.synchronize()
    assert train_chunk.fused_train_chunk.launches == launches + 1
    sp, mp = train_chunk.train_chunk_plain(state, batch, steps, spec, cfg)
    for key in ("rec", "l1", "total"):
        assert ((mk[key] - mp[key]).abs() / mp[key].abs()).max() <= 2e-4, key
    assert torch.isfinite(mk["ortho"]).all() and (mk["max_arg"] > 0).all()
    _, mk1 = train_chunk.fused_train_chunk(sk, batch, 1, spec, cfg)
    _, mp1 = train_chunk.train_chunk_plain(sk, batch, 1, spec, cfg)
    for key in train_chunk.METRICS:
        atol = 1e-5 if key == "ortho" else 0.0
        assert (mk1[key] - mp1[key]).abs() <= 2e-4 * mp1[key].abs() + atol, key
    for key in sk.params:
        assert (sk.params[key] - sp.params[key]).abs().max() <= 2e-3 * sp.params[key].abs().max(), key
    assert sk.epoch == sp.epoch == steps and torch.equal(sk.sched.lrs, sp.sched.lrs)
    sk2, mk2 = train_chunk.fused_train_chunk(state, batch, steps, spec, cfg)
    assert all(torch.equal(mk[k], mk2[k]) for k in mk)  # fixed-order reductions
    assert all(torch.equal(sk.params[k], sk2.params[k]) for k in sk.params)


def test_mega_kernel_plateau_drops_match_plain_chunk(cuda):
    cfg, spec, batch, state = _chunk_problem(
        cuda, 96, 40, 2, 2, omega_init=1.0, lr_omega=1.0, patience=3, sched_every=2
    )
    state.sched = dataclasses.replace(state.sched, best=torch.tensor(0.0, device=cuda))  # no epoch improves
    sk, _ = train_chunk.fused_train_chunk(state, batch, 12, spec, cfg)
    sp, _ = train_chunk.train_chunk_plain(state, batch, 12, spec, cfg)
    assert float(sk.sched.lrs[0]) < cfg.lr_coef
    assert torch.equal(sk.sched.lrs, sp.sched.lrs) and int(sk.sched.num_bad) == int(sp.sched.num_bad)


def test_phase_split_and_runner_path(cuda, tmp_path):
    cfg, spec, batch, state = _chunk_problem(cuda, 3961, 1001, 4, 3)
    split = train_chunk.phase_split(state, batch, 50, spec, cfg)
    assert list(split) == list(train_chunk.PHASES) and all(v > 0 for v in split.values())
    x = synthetic.cylinder_wake(500, 200, seed=cfg.seed)
    small = dataclasses.replace(cfg, checkpoint_every=100)
    dual_gemm.dual_contractions.launches = train_chunk.fused_train_chunk.launches = 0
    art = runner.run(small, x, out_dir=str(tmp_path), num_epochs=300, echo=False, device=cuda)
    assert train_chunk.fused_train_chunk.launches == 3 and dual_gemm.dual_contractions.launches == 0
    assert np.isfinite(art.history["total"]).all() and len(art.sweep) == 14


def test_per_launch_kernel_clock_matches_phase_split(cuda):
    """While tracing is on each launch keeps its kernel clock on its
    ``chunk.enqueue`` record (``profiling.kernel_clock``): a 200-epoch
    launch's phase shares are within 2 points of ``phase_split``'s over the
    same epochs from the same state; off, no launch keeps one."""
    cfg, spec, batch, state = _chunk_problem(cuda, 3961, 1001, 4, 3)
    profiling.reset()
    train_chunk.fused_train_chunk(state, batch, 200, spec, cfg)
    torch.cuda.synchronize()
    assert profiling.records() == []
    with profiling.enable():
        with profiling.span("fit.launch"):
            train_chunk.fused_train_chunk(state, batch, 200, spec, cfg)
        torch.cuda.synchronize()
    recs = profiling.records()
    assert [r.name for r in recs] == ["fit.launch", "chunk.pack", "chunk.enqueue", "chunk.unpack"]
    clock = recs[2].clock
    assert list(clock) == list(train_chunk.PHASES) and recs[2].launched is not None
    split = train_chunk.phase_split(state, batch, 200, spec, cfg)
    total, want = sum(clock.values()), sum(split.values())
    for name in train_chunk.PHASES:
        assert abs(100 * clock[name] / total - 100 * split[name] / want) <= 2.0, name
    profiling.reset()


def _fourier_problem(device, preset, **over):
    """A Fourier preset at full width on the cylinder's synthetic data at its
    (n, m), POD init and all-ones params, with ``over`` applied."""
    cfg = dataclasses.replace(configs.get(preset), **over)
    x = synthetic.cylinder_wake(cfg.n, cfg.m, seed=cfg.seed)
    batch = runner.prepare_batch(x, pod.pod_host(x, cfg.r, device).modes, device)
    spec = fourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier, cfg.period_init)
    return cfg, spec, batch, train.init_state(fourier.Fourier(spec, device=device).params(), cfg)


@pytest.mark.parametrize("preset, steps", [("fourier_cylinder", 30), ("fourier_aneurysm", 10)])
def test_fourier_mega_kernel_matches_plain_chunk(cuda, preset, steps):
    """The Fourier form at fourier_cylinder's shape (n=3961, m=1001, nF=10,
    K=12) and fourier_aneurysm's (n=27000, m=1000, nF=30), omega_init=1 and
    lr_omega=1: the trace (rec, l1, total) to 2e-4; one epoch from the
    kernel's state: every metric to 2e-4 (ortho plus 1e-5 absolute) and
    every parameter to 1e-5 of its largest entry; two launches
    bit-identical. Along the trajectory the parameters are held to 1e-2
    only: the series row of the lat1*lat2 term has near-zero gradients,
    which Adamax steps by +-lr on rounding alone, so two plain chunks, one on
    the GPU and one on the CPU, part there by 4e-3 after 30 epochs
    (``PERF.md``, Findings)."""
    cfg, spec, batch, state = _fourier_problem(cuda, preset, omega_init=1.0, lr_omega=1.0)
    launches = train_chunk.fused_train_chunk.launches
    sk, mk = train_chunk.fused_train_chunk(state, batch, steps, spec, cfg)
    torch.cuda.synchronize()
    assert train_chunk.fused_train_chunk.launches == launches + 1
    sp, mp = train_chunk.train_chunk_plain(state, batch, steps, spec, cfg)
    for key in ("rec", "l1", "total"):
        assert ((mk[key] - mp[key]).abs() / mp[key].abs()).max() <= 2e-4, key
    sk1, mk1 = train_chunk.fused_train_chunk(sk, batch, 1, spec, cfg)
    sp1, mp1 = train_chunk.train_chunk_plain(sk, batch, 1, spec, cfg)
    for key in train_chunk.METRICS:
        atol = 1e-5 if key == "ortho" else 0.0
        assert (mk1[key] - mp1[key]).abs() <= 2e-4 * mp1[key].abs() + atol, key
    for key in sk.params:
        assert (sk1.params[key] - sp1.params[key]).abs().max() <= 1e-5 * sp1.params[key].abs().max(), key
        assert (sk.params[key] - sp.params[key]).abs().max() <= 1e-2 * sp.params[key].abs().max(), key
    sk2, mk2 = train_chunk.fused_train_chunk(state, batch, steps, spec, cfg)
    assert all(torch.equal(mk[k], mk2[k]) for k in mk)
    assert all(torch.equal(sk.params[k], sk2.params[k]) for k in sk.params)


def test_fourier_mega_kernel_plateau_drops_match_plain_chunk(cuda):
    cfg, spec, batch, state = _fourier_problem(
        cuda, "fourier_cylinder", n=500, m=200, omega_init=1.0, lr_omega=1.0, patience=3, sched_every=2
    )
    state.sched = dataclasses.replace(state.sched, best=torch.tensor(0.0, device=cuda))  # no epoch improves
    sk, _ = train_chunk.fused_train_chunk(state, batch, 12, spec, cfg)
    sp, _ = train_chunk.train_chunk_plain(state, batch, 12, spec, cfg)
    assert float(sk.sched.lrs[4]) < cfg.lr_period
    assert torch.equal(sk.sched.lrs, sp.sched.lrs) and int(sk.sched.num_bad) == int(sp.sched.num_bad)


def test_fourier_phase_split_and_runner_path(cuda, tmp_path):
    cfg, spec, batch, state = _fourier_problem(cuda, "fourier_cylinder")
    split = train_chunk.phase_split(state, batch, 50, spec, cfg)
    assert list(split) == list(train_chunk.FOURIER_PHASES) and all(v > 0 for v in split.values())
    x = synthetic.cylinder_wake(500, 200, seed=cfg.seed)
    small = dataclasses.replace(cfg, checkpoint_every=100)
    dual_gemm.dual_contractions.launches = train_chunk.fused_train_chunk.launches = 0
    art = runner.run(small, x, out_dir=str(tmp_path), num_epochs=300, echo=False, device=cuda)
    assert train_chunk.fused_train_chunk.launches == 3 and dual_gemm.dual_contractions.launches == 0
    assert np.isfinite(art.history["total"]).all() and len(art.sweep) == 14
    sd = torch.load(f"{art.out_dir}/fourier_cylinder_r2_final.pt", weights_only=True)
    assert {"period_list.0", "trig_period_list.5"} <= set(sd)


def _packed_problem(device, preset, S, **over):
    """A preset at full width on the cylinder's synthetic data at its (n, m),
    POD init, and S seeds from ``ensemble.init_params`` with the preset's
    jitter (phi by 2%), as ``ensemble.fit`` starts them, with ``over``
    applied. (At fourier_cylinder, seeds jittered by 10% in phi and 0.2
    decades in omega part from the plain chunk by percents of rec within 30
    epochs, while each equals the single-seed kernel run alone bit for bit:
    the series' near-zero gradients, which Adamax steps by +-lr on rounding,
    amplify the rounding of the two implementations.)"""
    cfg = dataclasses.replace(configs.get(preset), **over)
    x = synthetic.cylinder_wake(cfg.n, cfg.m, seed=cfg.seed)
    batch = runner.prepare_batch(x, pod.pod_host(x, cfg.r, device).modes, device)
    if cfg.variant == "fourier":
        spec = fourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier,
                                   cfg.period_init)
    else:
        spec = desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
    params = ensemble.init_params(spec, S, seed=cfg.seed, phi_sigma=cfg.seed_phi_sigma,
                                  omega_spread=cfg.seed_omega_spread, device=device)
    return cfg, spec, batch, params


@pytest.mark.parametrize("preset, S, steps", [("aneurysm", 4, 20), ("fourier_cylinder", 8, 30)])
def test_packed_mega_kernel_matches_plain_chunk(cuda, preset, S, steps):
    """The packed form at the ensemble cells' shapes (aneurysm S=4: n=27000,
    m=1000, K'=108; fourier_cylinder S=8: K'=96), omega_init=1 and
    lr_omega=1, with per-seed beta, lambda and LR scale: the
    per-seed trace (rec, l1, total_s) to 2e-4; one epoch from the kernel's
    state: every metric to 2e-4 (ortho plus 1e-5 absolute); each seed
    against the single-seed kernel run alone from that seed's state, trace
    to 2e-5 (the tolerance of tests/test_ensemble_kernel.py); two launches
    bit-identical."""
    cfg, spec, batch, params = _packed_problem(cuda, preset, S, omega_init=1.0, lr_omega=1.0)
    betas = np.geomspace(1e-3, 1e-2, S).astype(np.float32)
    lams = np.geomspace(1e-5, 1e-3, S).astype(np.float32)
    state = ensemble.init_state(params, cfg, S, lr_scales=np.where(np.arange(S) % 2, 0.5, 1.0))
    launches = train_chunk.fused_ensemble_chunk.launches
    sk, mk = train_chunk.fused_ensemble_chunk(state, batch, steps, spec, cfg, betas, lams)
    torch.cuda.synchronize()
    assert train_chunk.fused_ensemble_chunk.launches == launches + 1
    sp, mp = train_chunk.train_chunk_plain_packed(state, batch, steps, spec, cfg, betas, lams)
    for key in ("rec", "l1", "total_s"):
        assert ((mk[key] - mp[key]).abs() / mp[key].abs()).max() <= 2e-4, key
    assert mk["total_s"].shape == (steps, S) and (mk["max_arg"] > 0).all()
    _, mk1 = train_chunk.fused_ensemble_chunk(sk, batch, 1, spec, cfg, betas, lams)
    _, mp1 = train_chunk.train_chunk_plain_packed(sk, batch, 1, spec, cfg, betas, lams)
    for key in train_chunk.SEED_METRICS:
        atol = 1e-5 if key == "ortho" else 0.0
        assert ((mk1[key] - mp1[key]).abs() <= 2e-4 * mp1[key].abs() + atol).all(), key
    sk2, mk2 = train_chunk.fused_ensemble_chunk(state, batch, steps, spec, cfg, betas, lams)
    assert all(torch.equal(mk[k], mk2[k]) for k in mk)
    assert all(torch.equal(sk.params[k], sk2.params[k]) for k in sk.params)
    for s in range(S):
        one_cfg = dataclasses.replace(cfg, beta=float(betas[s]), l1_lambda=float(lams[s]))
        so, mo = train_chunk.fused_train_chunk(train_chunk.seed_view(state, s), batch, steps, spec, one_cfg)
        assert ((mk["total_s"][:, s] - mo["total"]).abs() <= 2e-5 * mo["total"].abs() + 1e-7).all(), s
        for key in so.params:
            ref = so.params[key]
            assert ((sk.params[key][s] - ref).abs() <= 1e-4 * ref.abs() + 1e-6).all(), (s, key)


def test_packed_mega_kernel_isolates_a_diverged_seed(cuda):
    """Seed 1's phi is NaN: its metrics are non-finite from the first epoch,
    every other seed's stay finite."""
    cfg, spec, batch, params = _packed_problem(cuda, "fourier_cylinder", 4, omega_init=1.0, lr_omega=1.0)
    params["phi"][1] = float("nan")
    state = ensemble.init_state(params, cfg, 4)
    _, mk = train_chunk.fused_ensemble_chunk(state, batch, 3, spec, cfg)
    for key in ("rec", "ortho", "total_s"):
        assert not torch.isfinite(mk[key][:, 1]).any(), key
        assert torch.isfinite(mk[key][:, [0, 2, 3]]).all(), key


def test_packed_phase_split_and_runner_path(cuda, tmp_path):
    """The packed form's phase split, and ``runner.run`` with n_seeds=4 at a
    small size: one packed launch per chunk, ensemble.json and
    term_stability.json written."""
    pcfg, spec, batch, params = _packed_problem(cuda, "fourier_cylinder", 8)
    split = train_chunk.phase_split(ensemble.init_state(params, pcfg, 8), batch, 50, spec, pcfg)
    assert list(split) == list(train_chunk.FOURIER_PHASES) and all(v > 0 for v in split.values())
    cfg = dataclasses.replace(configs.get("aneurysm"), checkpoint_every=100, n_seeds=4)
    x = synthetic.cylinder_wake(500, 200, seed=cfg.seed)
    dual_gemm.dual_contractions.launches = train_chunk.fused_ensemble_chunk.launches = 0
    art = runner.run(cfg, x, out_dir=str(tmp_path), num_epochs=300, echo=False, device=cuda)
    assert train_chunk.fused_ensemble_chunk.launches == 3 and dual_gemm.dual_contractions.launches == 0
    assert np.isfinite(art.history["total"]).all() and len(art.history["total"]) == 300
    files = set(tmp_path.joinpath(cfg.name).iterdir())
    assert {tmp_path / cfg.name / "ensemble.json", tmp_path / cfg.name / "term_stability.json"} <= files


def test_packed_fit_checkpoints_the_boundary_state(cuda, monkeypatch):
    """``ensemble.fit`` through the packed mega-kernel at cylinder S=2 over 3
    chunk boundaries: each state the checkpoint worker writes equals, bit for
    bit, the best seed's state as its boundary's launch left it (its pinned
    copies are queued ahead of the next launch), and no hand-off waited on
    the previous write (``ckpt.waits``)."""
    cfg, spec, batch, _ = _packed_problem(cuda, "cylinder", 2, checkpoint_every=500)
    returned = []
    select = train_chunk.select_ensemble_chunk

    def recording(*args, **kw):
        chunk = select(*args, **kw)
        assert chunk is not None  # the packed mega-kernel

        def run(state, batch, n):
            out, mets = chunk(state, batch, n)
            returned.append((ensemble._snapshot(out), mets["total_s"][-1].clone()))
            return out, mets

        return run

    monkeypatch.setattr(train_chunk, "select_ensemble_chunk", recording)
    saved = []
    before = profiling.counters()
    ensemble.fit(cfg, spec, batch, n_seeds=2, num_epochs=1500, seed=cfg.seed, phi_sigma=cfg.seed_phi_sigma,
                 log=None, checkpoint_fn=lambda st, ep: saved.append((st, ep)))
    after = profiling.counters()
    assert [ep for _, ep in saved] == [500, 1000, 1500] and len(returned) == 3
    assert after["ckpt.writes"] - before.get("ckpt.writes", 0) == 3
    assert after.get("ckpt.waits", 0) - before.get("ckpt.waits", 0) == 0
    for (got, ep), (st, tot) in zip(saved, returned):
        assert torch.isfinite(tot).all()
        want = ensemble.seed_state(st, cfg, int(torch.argmin(tot)))
        assert got.epoch == want.epoch == ep and got.params["phi"].device.type == "cpu"
        for tree in ("params", "mu", "nu"):
            for k, v in getattr(want, tree).items():
                assert torch.equal(getattr(got, tree)[k], v.cpu()), (ep, tree, k)
        for k in ("lrs", "best", "num_bad"):
            assert torch.equal(getattr(got.sched, k), getattr(want.sched, k).cpu()), (ep, k)


def _ae_problem(device, n=3961, m=1001, **over):
    """The AE preset at (n, m) on the cylinder's synthetic data from the live
    init (the reference init's decoder is dead, so it proves nothing about
    the funnel's backward), omega_init=1 and tame LRs (at the preset's 1e4 a
    1-ulp latent difference flips the signs of sin), with ``over`` applied."""
    base = dict(n=n, m=m, omega_init=1.0, lr_coef=1e-3, lr_z=1e-3, lr_omega=1e-2)
    cfg = dataclasses.replace(configs.get("ae_cylinder"), **{**base, **over})
    x = synthetic.cylinder_wake(n, m, seed=cfg.seed)
    batch = runner.prepare_batch(x, None, device)
    spec = autoencoder.AESpec(n, m, cfg.r, cfg.poly_order, cfg.omega_init)
    return cfg, spec, batch, train.init_state(autoencoder.init_params_live(spec, device=device), cfg)


@pytest.mark.parametrize("n, m, steps", [(64, 40, 25), (3961, 1001, 30)])
def test_ae_kernel_matches_plain_chunk(cuda, n, m, steps):
    """The AE kernel against its plain chunk at the CPU suite's size and at
    ae_cylinder's (n=3961, m=1001, K=12): one epoch from one state, every
    metric to 2e-4 and every parameter to 1e-5 of its largest entry; the
    trace to tests/test_ae_chunk.py's 5e-4 and the parameters on its two
    tiers (a 1-ulp pre-activation difference flips a ReLU unit's gradient
    for one step); two launches bit-identical."""
    cfg, spec, batch, state = _ae_problem(cuda, n, m)
    launches = ae_chunk.fused_ae_chunk.launches
    sk, mk = ae_chunk.fused_ae_chunk(state, batch, steps, spec, cfg)
    torch.cuda.synchronize()
    assert ae_chunk.fused_ae_chunk.launches == launches + 1
    sp, mp = ae_chunk.ae_chunk_plain(state, batch, steps, spec, cfg)
    for key in ae_chunk.METRICS:
        assert ((mk[key] - mp[key]).abs() <= 5e-4 * mp[key].abs() + 1e-7).all(), key
    for key in sk.params:
        d = (sk.params[key] - sp.params[key]).abs() / sp.params[key].abs().max()
        assert d.max() < 2e-2 and (d < 5e-3).float().mean() >= 0.95, key
    sk1, mk1 = ae_chunk.fused_ae_chunk(sk, batch, 1, spec, cfg)
    sp1, mp1 = ae_chunk.ae_chunk_plain(sk, batch, 1, spec, cfg)
    for key in ae_chunk.METRICS:
        assert (mk1[key] - mp1[key]).abs() <= 2e-4 * mp1[key].abs(), key
    for key in sk1.params:
        assert (sk1.params[key] - sp1.params[key]).abs().max() <= 1e-5 * sp1.params[key].abs().max(), key
    assert sk.epoch == sp.epoch == steps and torch.equal(sk.sched.lrs, sp.sched.lrs)
    sk2, mk2 = ae_chunk.fused_ae_chunk(state, batch, steps, spec, cfg)
    assert all(torch.equal(mk[k], mk2[k]) for k in mk)
    assert all(torch.equal(sk.params[k], sk2.params[k]) for k in sk.params)


def test_ae_kernel_plateau_drops_match_plain_chunk(cuda):
    cfg, spec, batch, state = _ae_problem(cuda, 500, 200, patience=3, sched_every=2)
    state.sched = dataclasses.replace(state.sched, best=torch.tensor(0.0, device=cuda))  # no epoch improves
    sk, _ = ae_chunk.fused_ae_chunk(state, batch, 12, spec, cfg)
    sp, _ = ae_chunk.ae_chunk_plain(state, batch, 12, spec, cfg)
    assert float(sk.sched.lrs[0]) < cfg.lr_coef
    assert torch.equal(sk.sched.lrs, sp.sched.lrs) and int(sk.sched.num_bad) == int(sp.sched.num_bad)


def test_ae_phase_split_and_runner_paths(cuda, tmp_path):
    """The AE kernel's phase split; ``runner.run`` on the AE preset at a
    small size: ``megakernel`` launches the AE kernel once per chunk and no
    other kernel, ``auto`` runs the eager loop, the dual contraction once
    per epoch and the AE kernel never."""
    cfg, spec, batch, state = _ae_problem(cuda)
    split = ae_chunk.phase_split(state, batch, 20, spec, cfg)
    assert list(split) == list(ae_chunk.PHASES) and all(v > 0 for v in split.values())
    x = synthetic.cylinder_wake(500, 200, seed=cfg.seed)
    small = dataclasses.replace(configs.get("ae_cylinder"), checkpoint_every=100)
    counters = (ae_chunk.fused_ae_chunk, dual_gemm.dual_contractions, train_chunk.fused_train_chunk)
    for method, want in (("megakernel", (3, 0, 0)), ("auto", (0, 300, 0))):
        for fn in counters:
            fn.launches = 0
        art = runner.run(dataclasses.replace(small, chunk_method=method), x, out_dir=str(tmp_path / method),
                         num_epochs=300, echo=False, device=cuda)
        assert tuple(fn.launches for fn in counters) == want, method
        assert np.isfinite(art.history["total"]).all() and len(art.history["ae"]) == 300
        assert len(art.sweep) == 14


def _step_inputs(cfg, spec, batch, state):
    """The step kernel's arguments at the state: all rows, B built from the
    series for the Fourier form."""
    cs = train_chunk.pack_seeds(train_chunk.stack_seed(state), [cfg.beta], [cfg.l1_lambda])
    if cs.series is None:
        b = cs.b[0]
    else:
        tw = torch.as_tensor(fourier.TWO_PI * fourier.t_points(cfg.m), device=batch["x"].device)
        b = train_chunk.series_forward(cs.series[0], cs.periods[0], tw)[0]
    return (batch["pod_modes"], batch["x"], cs.phi[0], b, b @ b.T, cs.coef[0], cs.omega[0])


@pytest.mark.parametrize("preset", ["cylinder", "fourier_cylinder"])
def test_step_kernel_matches_plain_version(cuda, preset):
    """The step kernel at the preset's full width from the live init at
    omega_init=1, over all rows and over 2 and 3 uneven shards with the
    partials summed, against the plain version over all rows in float64:
    each summed part within 5e-6 of its largest entry (the dual
    contraction's contract), dl within 1e-5; max_arg equal to the float32
    plain version's; two launches give the same bits. The float32 plain
    version is no yardstick for AᵀX: cuBLAS sums it over n in one chain,
    and the constant column's sums of X cancel (6.4e-6 of max|AᵀX| from
    float64 at cylinder, 2.3e-5 at fourier_cylinder; the kernel 8.9e-7)."""
    device_mod.fp32_matmul()
    if preset == "cylinder":
        cfg, spec, batch, state = _chunk_problem(cuda, 3961, 1001, 4, 3, omega_init=1.0, lr_omega=1.0)
    else:
        cfg, spec, batch, state = _fourier_problem(cuda, preset, omega_init=1.0, lr_omega=1.0)
    args = _step_inputs(cfg, spec, batch, state)
    n, m, r = cfg.n, cfg.m, cfg.r
    K = spec.num_poly_terms + 3 * r
    ref32 = shard_step.step_partials_plain(*args, spec, n)
    ref = shard_step.step_partials_plain(*(a.double() for a in args), spec, n)
    launches = shard_step.step.launches
    first = shard_step.step_partials(*args, spec, n)
    again = shard_step.step_partials(*args, spec, n)
    torch.cuda.synchronize()
    assert shard_step.step.launches == launches + 2
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    for d in (1, 2, 3):
        bounds = [parallel.row_range(n, d, k) for k in range(d)]
        parts = [shard_step.step_partials(args[0][lo:hi].contiguous(), args[1][lo:hi].contiguous(),
                                          args[2][:, lo:hi].contiguous(), *args[3:], spec, n) for lo, hi in bounds]
        torch.cuda.synchronize()
        dl = torch.cat([p[0] for p in parts])
        assert (dl.double() - ref[0]).abs().max() <= 1e-5 * ref[0].abs().max()
        summed = shard_step.split_sums(sum(p[1] for p in parts), K, m, r)
        for name, got, want in zip(("ax", "ga", "latg", "gcoef", "gomega"), summed, shard_step.split_sums(ref[1], K, m, r)):
            assert (got.double() - want).abs().max() <= 5e-6 * want.abs().max(), (d, name)
        assert float(max(p[2] for p in parts)) == float(ref32[2])


@pytest.mark.parametrize("preset", ["cylinder", "fourier_cylinder"])
def test_sharded_chunk_matches_mega_kernel(cuda, preset):
    """The sharded chunk on a one-rank NCCL mesh against the mega-kernel from
    the live init at omega_init=1: one epoch from one state, metrics within
    2e-4 (ortho plus 1e-5 absolute) and params within 1e-5 of each array's
    largest entry; 25 epochs, rec and total within 2e-4 and params within
    2e-3, as the mega-kernel against its plain chunk."""
    mesh = parallel.make_mesh(1, device=cuda)
    if preset == "cylinder":
        cfg, spec, batch, state = _chunk_problem(cuda, 3961, 1001, 4, 3, omega_init=1.0, lr_omega=1.0)
    else:
        cfg, spec, batch, state = _fourier_problem(cuda, preset, omega_init=1.0, lr_omega=1.0)
    chunk = shard_step.make_sharded_fused_chunk(spec, cfg, mesh)
    local = parallel.shard_batch(batch, mesh)
    launches = shard_step.step.launches
    s1, m1 = chunk(state, local, 1)
    k1, mk1 = train_chunk.fused_train_chunk(state, batch, 1, spec, cfg)
    torch.cuda.synchronize()
    assert shard_step.step.launches == launches + 2  # the step, then the prologue alone
    for key in train_chunk.METRICS:
        atol = 1e-5 if key == "ortho" else 0.0
        assert (m1[key] - mk1[key]).abs().max() <= 2e-4 * mk1[key].abs().max() + atol, key
    for key in s1.params:
        assert (s1.params[key] - k1.params[key]).abs().max() <= 1e-5 * k1.params[key].abs().max(), key
    s25, m25 = chunk(state, local, 25)
    k25, mk25 = train_chunk.fused_train_chunk(state, batch, 25, spec, cfg)
    for key in ("rec", "total"):
        assert ((m25[key] - mk25[key]).abs() / mk25[key].abs()).max() <= 2e-4, key
    for key in s25.params:
        assert (s25.params[key] - k25.params[key]).abs().max() <= 2e-3 * k25.params[key].abs().max(), key
    assert s25.epoch == 25 and torch.equal(s25.sched.lrs, k25.sched.lrs)


def test_runner_over_a_one_rank_mesh(cuda, tmp_path):
    """``runner.run`` over a one-rank NCCL mesh: one step kernel launch per
    epoch and one more per chunk, no other kernel, the exports written."""
    mesh = parallel.make_mesh(1, device=cuda)
    cfg = dataclasses.replace(configs.get("cylinder"), checkpoint_every=100)
    x = synthetic.cylinder_wake(500, 200, seed=cfg.seed)
    counters = (shard_step.step, train_chunk.fused_train_chunk, dual_gemm.dual_contractions)
    for fn in counters:
        fn.launches = 0
    art = runner.run(cfg, x, out_dir=str(tmp_path), num_epochs=300, echo=False, device=cuda, device_mesh=mesh)
    assert [fn.launches for fn in counters] == [300 + 3, 0, 0]
    assert np.isfinite(art.history["total"]).all() and len(art.sweep) == 14
    assert {"state_final.npz", "cylinder_r4_final.pt"} <= {p.name for p in (tmp_path / "cylinder").iterdir()}


def _step_buffers(cfg, spec, batch, state, num_steps):
    cs = train_chunk.pack_seeds(train_chunk.stack_seed(state), [cfg.beta], [cfg.l1_lambda])
    return shard_step.make_buffers(cs, batch, num_steps, spec, cfg, cfg.n)


@pytest.mark.parametrize("preset", ["cylinder", "fourier_cylinder"])
def test_step_kernel_update_matches_step_plain(cuda, preset):
    """The step kernel's prologue at the preset's full width (omega_init=1):
    from the kernel's state after one step, the launch that updates that
    step and forms the next partials against ``step_plain`` in float64 on
    the same state and sums: the metrics row within 2e-4 (ortho plus 1e-5
    absolute), every parameter within 1e-5 of its largest entry, the LRs
    equal, the next partials within 5e-6 and dl within 1e-5 of their largest
    entries; two launches from the same buffers give the same bits."""
    device_mod.fp32_matmul()
    if preset == "cylinder":
        cfg, spec, batch, state = _chunk_problem(cuda, 3961, 1001, 4, 3, omega_init=1.0, lr_omega=1.0)
    else:
        cfg, spec, batch, state = _fourier_problem(cuda, preset, omega_init=1.0, lr_omega=1.0)
    K, m, r = spec.num_poly_terms + 3 * cfg.r, cfg.m, cfg.r
    buf = _step_buffers(cfg, spec, batch, state, 2)
    shard_step.step(buf, spec)
    ref = buf.to("cpu", torch.float64)
    twice = [buf.clone(), buf.clone()]
    for run in twice:
        shard_step.step(run, spec)
    torch.cuda.synchronize()
    shard_step.step_plain(ref, spec)
    got = twice[0]
    for f in ("sums", "dl", "gb", "met", "max_arg", "count"):
        assert torch.equal(getattr(twice[0], f), getattr(twice[1], f)), f
    assert int(got.count) == 2
    for i, key in enumerate(shard_step.ROW_METRICS):
        atol = 1e-5 if key == "ortho" else 0.0
        assert abs(float(got.met[0, 0, i]) - float(ref.met[0, 0, i])) <= 2e-4 * abs(float(ref.met[0, 0, i])) + atol, key
    for f in ("phi", "coef", "omega") + (("series", "periods") if got.nf else ("b",)):
        g, w = getattr(got.cs, f)[0].double().cpu(), getattr(ref.cs, f)[0]
        assert (g - w).abs().max() <= 1e-5 * w.abs().max(), f
    assert torch.equal(got.cs.svec[0, :5].cpu(), ref.cs.svec[0, :5].float())
    assert (got.dl.double().cpu() - ref.dl).abs().max() <= 1e-5 * ref.dl.abs().max()
    for name, g, w in zip(("ax", "ga", "latg", "gcoef", "gomega"), shard_step.split_sums(got.sums, K, m, r),
                          shard_step.split_sums(ref.sums, K, m, r)):
        assert (g.double().cpu() - w).abs().max() <= 5e-6 * w.abs().max(), name


@pytest.mark.parametrize("preset", ["cylinder", "fourier_cylinder"])
def test_graph_replay_matches_the_uncaptured_loop(cuda, preset):
    """The chunk's steps replayed from a CUDA graph of one step
    (``run_steps``) give the bits of the same launches and all-reduces
    called one by one, over 30 steps on a one-rank NCCL mesh; each replay
    counts as one launch, and the profiler sees one step kernel a count."""
    mesh = parallel.make_mesh(1, device=cuda)
    if preset == "cylinder":
        cfg, spec, batch, state = _chunk_problem(cuda, 3961, 1001, 4, 3)
    else:
        cfg, spec, batch, state = _fourier_problem(cuda, preset)
    local = parallel.shard_batch(batch, mesh)
    steps = 30
    graph = _step_buffers(cfg, spec, local, state, steps)
    launches = shard_step.step.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        shard_step.run_steps(graph, spec, mesh, steps)
        torch.cuda.synchronize()
    assert shard_step.step.launches == launches + steps + 1
    assert sum(e.count for e in prof.key_averages() if "step_kernel" in e.key) == steps + 1
    loop = _step_buffers(cfg, spec, local, state, steps)
    for _ in range(steps):
        shard_step.step(loop, spec)
        mesh.all_reduce(loop.sums, "sum")
    shard_step.step(loop, spec, rows=False)
    mesh.all_reduce(loop.max_arg, "max")
    torch.cuda.synchronize()
    for f in ("sums", "dl", "gb", "met", "max_arg", "count"):
        assert torch.equal(getattr(graph, f), getattr(loop, f)), f
    for f in ("phi", "coef", "omega", "svec") + (("series", "periods") if graph.nf else ("b",)):
        assert torch.equal(getattr(graph.cs, f), getattr(loop.cs, f)), f
    assert bool(torch.isfinite(graph.met).all()) and int(graph.count) == steps


def _packed_step_buffers(cfg, spec, batch, state, lo, hi, num_steps, betas=None, lams=None):
    """The packed step's buffers over rows [lo, hi) of the stacked ``state``
    and ``batch``, as a rank holding those rows builds them."""
    S = state.params["phi"].shape[0]
    cs = train_chunk.pack_seeds(state, *train_chunk.seed_hypers(cfg, S, betas, lams))
    cs.phi = cs.phi[:, :, lo:hi].contiguous()
    local = {"x": batch["x"][lo:hi].contiguous(), "pod_modes": batch["pod_modes"][lo:hi].contiguous(),
             "x_sq": batch["x_sq"]}
    return shard_step.make_buffers(cs, local, num_steps, spec, cfg, cfg.n)


# the partials' limits of max|ref| against float64: 5e-6 (the dual
# contraction's contract), but for AᵀX at the reference init, where B is all
# ones, X·Bᵀ cancels to rounding and float32 itself misses 5e-6 on its
# constant row at n=27000 (1.9e-5; ``chip_smoke.py`` ``STEP_INIT_RTOL``)
STEP_LIMITS = dict.fromkeys(("ax", "ga", "latg", "gcoef", "gomega"), 5e-6)
INIT_LIMITS = {**STEP_LIMITS, "ax": 5e-5}


@pytest.mark.parametrize("preset, S, epochs, limits", [
    ("aneurysm", 4, 200, STEP_LIMITS), ("aneurysm", 4, 0, INIT_LIMITS), ("aneurysm", 1, 0, INIT_LIMITS),
    ("fourier_cylinder", 8, 200, STEP_LIMITS), ("fourier_cylinder", 8, 0, INIT_LIMITS),
], ids=["aneurysm-4-trained", "aneurysm-4-init", "aneurysm-1-init", "fourier_cylinder-8-trained",
        "fourier_cylinder-8-init"])
def test_packed_step_kernel_matches_step_plain(cuda, preset, S, epochs, limits):
    """The step kernel's packed form at the ensemble cells' full width
    (omega_init=1, per-seed beta, lambda and LR scale), from the state after
    200 epochs of the packed mega-kernel and from the reference init,
    against ``step_plain`` in float64: the partials over all rows and over 2
    and 3 uneven shards (summed) within ``rtol`` of each part's largest
    entry, dl within 1e-5, max_arg the float32 plain's; the mega-kernel's
    first-epoch sums of the same state (``train_chunk.epoch_sums``) within
    the same limits; from the kernel's state, the update and the next
    partials: each seed's metrics row within 2e-4 (ortho plus 1e-5
    absolute), the parameters within 1e-5, the LRs equal; two launches the
    same bits; a NaN seed's metrics non-finite, the others' finite. The
    limits are 5e-6 of each part's largest entry, AᵀX's 5e-5 at the
    reference init (``INIT_LIMITS``); gomega, whose rows both kernels sum as
    a pairwise tree per row tile, is held to 5e-6 there (one fmaf chain over
    a block's ~205 rows reached 1.7e-5)."""
    device_mod.fp32_matmul()
    cfg, spec, batch, params = _packed_problem(cuda, preset, S, omega_init=1.0, lr_omega=1.0)
    betas = np.geomspace(1e-3, 1e-2, S).astype(np.float32)
    lams = np.geomspace(1e-5, 1e-3, S).astype(np.float32)
    state = ensemble.init_state(params, cfg, S, lr_scales=np.where(np.arange(S) % 2, 0.5, 1.0))
    if epochs:
        state = train_chunk.fused_ensemble_chunk(state, batch, epochs, spec, cfg, betas, lams)[0]
    n, m, r = cfg.n, cfg.m, cfg.r
    K = spec.num_poly_terms + 3 * r
    whole = _packed_step_buffers(cfg, spec, batch, state, 0, n, 2, betas, lams)
    ref = whole.to(cuda, torch.float64)
    shard_step.step_plain(ref, spec)
    ref32 = whole.to(cuda, torch.float32)
    shard_step.step_plain(ref32, spec)
    for d in (1, 2, 3):
        runs = [whole] if d == 1 else [_packed_step_buffers(cfg, spec, batch, state, lo, hi, 2, betas, lams)
                                       for lo, hi in (parallel.row_range(n, d, q) for q in range(d))]
        for run in runs:
            shard_step.step(run, spec)
        torch.cuda.synchronize()
        dl = torch.cat([run.dl for run in runs])
        assert (dl.double() - ref.dl).abs().max() <= 1e-5 * ref.dl.abs().max(), d
        for name, got, want in zip(("ax", "ga", "latg", "gcoef", "gomega"),
                                   shard_step.split_seed_sums(sum(run.sums for run in runs), K, m, r, S),
                                   shard_step.split_seed_sums(ref.sums, K, m, r, S)):
            assert (got.double() - want).abs().max() <= limits[name] * want.abs().max(), (d, name)
        assert max(float(run.max_arg[0]) for run in runs) == float(ref32.max_arg[0])
    mega = train_chunk.epoch_sums(state, batch, spec, cfg, betas, lams)
    for name, want in zip(("ga", "latg", "gcoef", "gomega"), shard_step.split_seed_sums(ref.sums, K, m, r, S)[1:]):
        assert (mega[name].double() - want).abs().max() <= limits[name] * want.abs().max(), name
    ref = whole.to(cuda, torch.float64)
    twice = [whole.clone(), whole.clone()]
    for run in twice:
        shard_step.step(run, spec)
    torch.cuda.synchronize()
    shard_step.step_plain(ref, spec)
    got = twice[0]
    for f in ("sums", "dl", "gb", "met", "max_arg", "count"):
        assert torch.equal(getattr(twice[0], f), getattr(twice[1], f)), f
    atol = torch.tensor([0.0, 1e-5, 0.0, 0.0], dtype=torch.float64, device=cuda)
    assert ((got.met[0].double() - ref.met[0]).abs() <= 2e-4 * ref.met[0].abs() + atol).all()
    for f in ("phi", "coef", "omega") + (("series", "periods") if got.nf else ("b",)):
        g, w = getattr(got.cs, f)[0].double(), getattr(ref.cs, f)[0]
        assert (g - w).abs().max() <= 1e-5 * w.abs().max(), f
    assert torch.equal(got.cs.svec[:, :5], ref.cs.svec[:, :5].float())
    if S == 1:
        return
    bad = ensemble.init_state({**params, "phi": params["phi"].clone()}, cfg, S)
    bad.params["phi"][1] = float("nan")
    bbuf = _packed_step_buffers(cfg, spec, batch, bad, 0, n, 3)
    for _ in range(3):
        shard_step.step(bbuf, spec)
    others = [q for q in range(S) if q != 1]
    assert not torch.isfinite(bbuf.met[:2, 1][:, [0, 1, 3]]).any() and torch.isfinite(bbuf.met[:2, others]).all()


@pytest.mark.parametrize("preset, S", [("aneurysm", 4), ("fourier_cylinder", 8)])
def test_sharded_packed_chunk_matches_packed_mega_kernel(cuda, preset, S):
    """The sharded packed chunk on a one-rank NCCL mesh against the packed
    mega-kernel from the same state (omega_init=1, per-seed beta and lambda):
    one epoch within 2e-4 of every metric (ortho plus 1e-5 absolute) and
    1e-5 of each parameter's largest entry; 25 epochs, rec and total_s
    within 2e-4; the launches one a step and one a chunk."""
    mesh = parallel.make_mesh(1, device=cuda)
    cfg, spec, batch, params = _packed_problem(cuda, preset, S, omega_init=1.0, lr_omega=1.0)
    betas = np.geomspace(1e-3, 1e-2, S).astype(np.float32)
    lams = np.geomspace(1e-5, 1e-3, S).astype(np.float32)
    state = ensemble.init_state(params, cfg, S)
    chunk = shard_step.make_sharded_fused_ensemble_chunk(spec, cfg, mesh, S, betas, lams)
    local = parallel.shard_batch(batch, mesh)
    launches = shard_step.step.launches
    s1, m1 = chunk(state, local, 1)
    k1, mk1 = train_chunk.fused_ensemble_chunk(state, batch, 1, spec, cfg, betas, lams)
    torch.cuda.synchronize()
    assert shard_step.step.launches == launches + 2
    for key in train_chunk.SEED_METRICS:
        atol = 1e-5 if key == "ortho" else 0.0
        assert ((m1[key] - mk1[key]).abs() <= 2e-4 * mk1[key].abs() + atol).all(), key
    for key in s1.params:
        assert (s1.params[key] - k1.params[key]).abs().max() <= 1e-5 * k1.params[key].abs().max(), key
    s25, m25 = chunk(state, local, 25)
    _, mk25 = train_chunk.fused_ensemble_chunk(state, batch, 25, spec, cfg, betas, lams)
    for key in ("rec", "total_s"):
        assert ((m25[key] - mk25[key]).abs() / mk25[key].abs()).max() <= 2e-4, key
    assert s25.epoch == 25 and s25.params["phi"].shape == (S, cfg.r, cfg.n)


def test_runner_with_seeds_over_a_one_rank_mesh(cuda, tmp_path):
    """``runner.run`` with 4 seeds over a one-rank NCCL mesh: one step kernel
    launch per epoch and one more per chunk, no other kernel, the records
    and exports written."""
    mesh = parallel.make_mesh(1, device=cuda)
    cfg = dataclasses.replace(configs.get("aneurysm"), checkpoint_every=100, n_seeds=4)
    x = synthetic.cylinder_wake(500, 200, seed=cfg.seed)
    counters = (shard_step.step, train_chunk.fused_ensemble_chunk, dual_gemm.dual_contractions)
    for fn in counters:
        fn.launches = 0
    art = runner.run(cfg, x, out_dir=str(tmp_path), num_epochs=300, echo=False, device=cuda, device_mesh=mesh)
    assert [fn.launches for fn in counters] == [300 + 3, 0, 0]
    assert np.isfinite(art.history["total"]).all() and art.state.params["phi"].shape == (cfg.r, 500)
    assert {"ensemble.json", "term_stability.json", "state_final.npz"} <= {
        p.name for p in (tmp_path / cfg.name).iterdir()}


def _decaying(n, m, k=8, seed=0):
    """Data whose leading singular values are well apart (each mode fixed to
    rounding up to its sign)."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n, k)))
    v, _ = np.linalg.qr(rng.standard_normal((m, k)))
    return ((u * (10.0 * 0.5 ** np.arange(k))) @ v.T).astype(np.float32)


@pytest.mark.parametrize("method", ["snapshots", "svd", "randomized"])
def test_device_pod_on_the_card_matches_the_cpu(cuda, method):
    """The device POD at cylinder's shape (n=3961, m=1001) with canonical
    signs: modes within 1e-5 of their largest entry, singular values 1e-5,
    the same sketch on both devices for 'randomized'; on the card two calls
    give the same bits, what ``evaluate`` relies on."""
    x = _decaying(3961, 1001)
    got = pod.canonical_signs(pod.pod(x, 4, method=method, device=cuda))
    want = pod.canonical_signs(pod.pod(x, 4, method=method, device="cpu"))
    assert (got.modes.cpu() - want.modes).abs().max() <= 1e-5 * want.modes.abs().max()
    assert ((got.singular_values.cpu() - want.singular_values).abs() <= 1e-5 * want.singular_values).all()
    again = pod.canonical_signs(pod.pod(x, 4, method=method, device=cuda))
    assert torch.equal(again.modes, got.modes) and torch.equal(again.temporal, got.temporal)


def test_evaluate_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``runner.evaluate`` of a Fourier checkpoint with ``forecast_after``
    at fourier_cylinder's width: the errors, the sweep and the forecast on
    the card as on the CPU (1e-4 relative, the sweep's counts equal). The
    errors are norms over 3.2M float32 terms: on the CPU the relative error
    of these parameters lies 3.1e-5 from the float64 value, on an H100
    1.5e-7."""
    cfg = dataclasses.replace(configs.get("fourier_cylinder"), omega_init=1.0)
    spec = fourier.FourierSpec(cfg.n, 801, cfg.r, cfg.poly_order, 1.0, cfg.n_fourier, 100.0)
    gen = torch.Generator().manual_seed(0)
    params = {k: v * (1.0 + 0.1 * torch.randn(v.shape, generator=gen))
              for k, v in fourier.Fourier(spec).params().items()}
    pt = str(tmp_path / "f.pt")
    from desmo_tpu_torch import checkpoint

    checkpoint.save_pt(pt, checkpoint.state_dict_from_params({k: v.detach() for k, v in params.items()}, "fourier"))
    x = synthetic.cylinder_wake(cfg.n, cfg.m, seed=cfg.seed)
    got = runner.evaluate(cfg, x, pt, echo=False, device=cuda, forecast_after=801)
    want = runner.evaluate(cfg, x, pt, echo=False, device="cpu", forecast_after=801)
    for key in ("relative_error", "pod_error_r", "pod_error_2r"):
        assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]), key
    for key in ("holdout_error", "train_error", "baseline_last_error"):
        assert abs(got["forecast"][key] - want["forecast"][key]) <= 1e-4 * abs(want["forecast"][key]), key
    assert [e[2] for e in got["sweep"]] == [e[2] for e in want["sweep"]]


def test_multistart_through_the_kernel_at_m801(cuda):
    """The period multi-start at fourier_cylinder's width cut by a 0.2
    holdout (m=801), omega_init=1: the probes through the mega-kernel and
    through its plain chunk give the same candidates, recs within 2e-4 and
    the same pick; one launch a probe."""
    cfg, spec, batch, state = _fourier_problem(cuda, "fourier_cylinder", m=801, omega_init=1.0, lr_omega=1.0,
                                               period_multistart=4, period_probe_epochs=50)
    loss_fn = fourier.build_loss(spec, cfg.beta, cfg.l1_lambda, method="fused")
    groups = fourier.param_groups(state.params)
    logs = {}
    for name, chunk in (("kernel", train_chunk.make_chunk(spec, cfg)),
                        ("plain", lambda s, b, n: train_chunk.train_chunk_plain(s, b, n, spec, cfg))):
        launches = train_chunk.fused_train_chunk.launches
        lines = []
        runner.fourier_period_multistart(cfg, state.params, batch, loss_fn, groups, chunk=chunk, log=lines.append)
        logs[name] = (lines, train_chunk.fused_train_chunk.launches - launches)
    (kl, kn), (pl, pn) = logs["kernel"], logs["plain"]
    assert kn == len(kl) - 1 and pn == 0
    kc = [ln.split(" -> rec ") for ln in kl[:-1]]
    pc = [ln.split(" -> rec ") for ln in pl[:-1]]
    assert [c for c, _ in kc] == [c for c, _ in pc]
    for (_, a), (_, b) in zip(kc, pc):
        assert abs(float(a) - float(b)) <= 2e-4 * float(b)
    assert kl[-1].split(" (rec")[0] == pl[-1].split(" (rec")[0]
