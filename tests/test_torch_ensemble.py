"""The port's seed-packed ensemble (``desmo_tpu_torch.ensemble``) against
``desmo_tpu.ensemble`` on the same numpy inputs: the pure parts, the packed
loss and its gradient, the packed eager chunk, ``fit``'s containment and
selection, ``term_stability``, the runner's ``n_seeds > 1`` branch and the
CLI's seed and sweep flags; and the per-seed scheduler step and the stacked
state carried over from the JAX package."""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from desmo_tpu import configs as jconfigs  # noqa: E402
from desmo_tpu import ensemble as jens  # noqa: E402
from desmo_tpu import optim as joptim  # noqa: E402
from desmo_tpu import pod as jpod  # noqa: E402
from desmo_tpu import runner as jrunner  # noqa: E402
from desmo_tpu.io import synthetic as jsynthetic  # noqa: E402
from desmo_tpu.models import desmo as jdesmo  # noqa: E402
from desmo_tpu.models import fourier as jfourier  # noqa: E402
from desmo_tpu_torch import checkpoint, configs, ensemble, optim, parallel, runner, train  # noqa: E402
from desmo_tpu_torch.models import desmo, fourier  # noqa: E402

MODELS = {"desmo": (desmo, jdesmo), "fourier": (fourier, jfourier)}


def problem(variant="desmo", S=3, n=96, m=40, r=2, P=2, nf=3):
    """Small data, POD modes, both packages' configs and specs, and the JAX
    package's jittered params for S seeds (seed 1), distinct periods for the
    Fourier variant."""
    cfg = configs.RunConfig(
        name="ens", variant=variant, n=n, m=m, r=r, poly_order=P, omega_init=1.0, lr_omega=0.1,
        n_fourier=nf, period_init=float(m), num_epochs=20, patience=300, sched_every=1, log_every=100,
        checkpoint_every=1000,
    )
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    if variant == "fourier":
        args = (n, m, r, P, 1.0, nf, float(m))
        spec, jspec = fourier.FourierSpec(*args), jfourier.FourierSpec(*args)
        t = jfourier.t_points(m)
        s = np.linspace(0, 2 * np.pi, n)
        x = np.outer(np.sin(s), np.sin(2 * np.pi * 2 * t / m)) + 0.5 * np.outer(np.cos(s), np.cos(2 * np.pi * 3 * t / m))
        periods = [float(m), 0.6 * m, 0.8 * m][:S]
    else:
        spec, jspec = desmo.DesmoSpec(n, m, r, P, 1.0), jdesmo.DesmoSpec(n, m, r, P, 1.0)
        x = jsynthetic.separable_rank_k(n, m, k=r, seed=0)
        periods = None
    x = (x - x.mean(axis=1, keepdims=True)).astype(np.float32)
    modes = np.array(jpod.pod(x, r).modes, np.float32)
    jparams = jens.init_params(jspec, S, seed=1, phi_sigma=0.1, omega_spread=0.2, periods=periods)
    return cfg, jcfg, spec, jspec, x, modes, jparams


def batches(x, modes):
    xt = torch.as_tensor(x)
    return ({"x": xt, "x_sq": torch.sum(xt * xt), "pod_modes": torch.as_tensor(modes)},
            {"x": jnp.asarray(x), "x_sq": jnp.sum(jnp.asarray(x) ** 2), "pod_modes": jnp.asarray(modes)})


@pytest.mark.parametrize("r, P", [(2, 2), (4, 2), (4, 3), (8, 2), (3, 4)])
def test_pure_parts_match_jax(r, P):
    """max_seeds_packed, packed_factor_table and resolve_hypers."""
    spec, jspec = desmo.DesmoSpec(50, 20, r, P), jdesmo.DesmoSpec(50, 20, r, P)
    assert ensemble.max_seeds_packed(spec) == jens.max_seeds_packed(jspec)
    for S in (1, 2, 4):
        np.testing.assert_array_equal(ensemble.packed_factor_table(spec, S), jens.packed_factor_table(jspec, S))
    cfg = configs.get("cylinder")
    for over in ({}, {"sweep_beta": (1e-3, 1e-2)}, {"sweep_lam": (1e-5,), "sweep_lr_scale": (0.5, 1.0, 2.0)},
                 {"sweep_beta": (cfg.beta,)}):
        for S in (2, 6):
            ours = ensemble.resolve_hypers(dataclasses.replace(cfg, **over), S, warn=False)
            ref = jens.resolve_hypers(jconfigs.RunConfig(**dataclasses.asdict(dataclasses.replace(cfg, **over))), S,
                                      warn=False)
            assert (ours is None) == (ref is None)
            if ours is not None:
                assert ours["combos"] == ref["combos"]
                for k in ("betas", "lams", "lr_scales"):
                    np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("variant", ["desmo", "fourier"])
def test_seed0_is_the_reference_init(variant):
    cfg, _, spec, jspec, _, _, _ = problem(variant)
    ours = ensemble.init_params(spec, 4, seed=3, phi_sigma=0.1, omega_spread=0.3)
    ref = jens.init_params(jspec, 4, seed=3, phi_sigma=0.1, omega_spread=0.3)
    base = MODELS[variant][0]
    single = (base.Fourier(spec) if variant == "fourier" else base.Desmo(spec)).params()
    assert list(ours) == list(ref)
    for k, v in ours.items():
        assert v.shape == ref[k].shape, k
        np.testing.assert_array_equal(v[0].numpy(), np.asarray(ref[k][0]), err_msg=k)
        assert torch.equal(v[0], single[k].detach()), k
    assert not torch.equal(ours["phi"][1], ours["phi"][0]) and not torch.equal(ours["omega"][2], ours["omega"][0])
    again = ensemble.init_params(spec, 4, seed=3, phi_sigma=0.1, omega_spread=0.3)
    assert all(torch.equal(again[k], ours[k]) for k in ours)  # the draws repeat from the seed


def _grads(loss_fn, params):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    total, mets = loss_fn(leaves, _grads.batch)
    grads = torch.autograd.grad(total, list(leaves.values()))
    return total, mets, dict(zip(leaves, grads))


@pytest.mark.parametrize("variant", ["desmo", "fourier"])
@pytest.mark.parametrize("method", ["factored", "fused"])
@pytest.mark.parametrize("hypers", [False, True])
def test_packed_loss_and_gradient_match_jax(variant, method, hypers):
    """The packed loss (sum of the seeds' totals), its per-seed metrics and
    its gradient against ``desmo_tpu.ensemble.build_loss`` (the fused form
    through its interpret-mode Pallas kernel) on the same params: values to
    1e-4 relative, gradients to 2e-4 of each array's largest entry (the
    tolerances of tests/test_torch_dual_gemm.py). Seed 0's latents are
    exactly the orthonormal POD modes, so its ortho is fp32 rounding (~1e-8)
    and is held to 1e-7 absolute."""
    cfg, jcfg, spec, jspec, x, modes, jparams = problem(variant)
    betas = lams = None
    if hypers:
        betas, lams = np.array([1e-3, 5e-3, 1e-2], np.float32), np.array([1e-4, 1e-5, 1e-3], np.float32)
    batch, jbatch = batches(x, modes)
    params = checkpoint.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    _grads.batch = batch
    total, mets, grads = _grads(ensemble.build_loss(spec, cfg, 3, method=method, betas=betas, lams=lams), params)
    jloss = jens.build_loss(jspec, jcfg, 3, method=method, betas=betas, lams=lams)
    (jtotal, jmets), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams, jbatch)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-4)
    for k in ("rec", "ortho", "l1", "total_s"):
        atol = 1e-7 if k == "ortho" else 0.0
        np.testing.assert_allclose(mets[k].detach().numpy(), np.asarray(jmets[k]), rtol=1e-4, atol=atol, err_msg=k)
    for k, g in grads.items():
        ref = np.asarray(jgrads[k])
        assert np.abs(g.numpy() - ref).max() <= 2e-4 * np.abs(ref).max(), k


def test_fused_blocks_equal_factored_blocks_per_seed():
    """``FactoredMSEFusedBlocks`` against autograd of the per-seed factored
    MSE on the CPU (the fused form's twin): values and gradients to 1e-5,
    and the per-seed cotangents scale each seed's block alone."""
    from desmo_tpu_torch.kernels import dual_gemm

    rng = np.random.default_rng(0)
    S, K, n, m = 3, 7, 60, 25
    a = torch.as_tensor(0.3 * rng.standard_normal((n, S * K)).astype(np.float32))
    b = torch.as_tensor(0.3 * rng.standard_normal((S * K, m)).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal((n, m)).astype(np.float32))
    g = torch.tensor([1.0, 0.0, 2.5])
    out = []
    for fn in (lambda a_, b_: dual_gemm.factored_mse_fused_blocks(a_, b_, x, torch.sum(x * x), S),
               lambda a_, b_: ensemble.factored_mse_blocks(a_, b_, x, None, S)):
        a_, b_ = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        vals = fn(a_, b_)
        out.append((vals.detach(),) + torch.autograd.grad(vals, (a_, b_), grad_outputs=g))
    for got, ref in zip(*out):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert torch.equal(out[0][1][:, K:2 * K], torch.zeros(n, K))  # seed 1's cotangent is 0


def test_plateau_step_over_seeds_matches_jax_vmap():
    """Per-seed rows stepped by their own metric, as ``jax.vmap`` of
    ``desmo_tpu.optim.plateau_step``; each row equals the one-seed call bit
    for bit."""
    rng = np.random.default_rng(1)
    S, G = 4, 5
    lrs = rng.uniform(1e-3, 1.0, (S, G)).astype(np.float32)
    best = np.array([1.0, 0.5, np.inf, 0.2], np.float32)
    num_bad = np.array([0, 3, 1, 5], np.int32)
    metric = np.array([0.9, 0.6, 1.0, 0.3], np.float32)
    kw = dict(patience=3, factor=0.1, min_lr=1e-4)
    ours = optim.plateau_step(optim.PlateauState(*map(torch.as_tensor, (lrs, best, num_bad))),
                              torch.as_tensor(metric), **kw)
    ref = jax.vmap(lambda st, mm: joptim.plateau_step(st, mm, **kw))(
        joptim.PlateauState(*map(jnp.asarray, (lrs, best, num_bad))), jnp.asarray(metric))
    np.testing.assert_array_equal(ours.lrs.numpy(), np.asarray(ref.lrs))
    np.testing.assert_array_equal(ours.best.numpy(), np.asarray(ref.best))
    np.testing.assert_array_equal(ours.num_bad.numpy(), np.asarray(ref.num_bad))
    assert (ours.lrs[3] < torch.as_tensor(lrs[3])).all() and (ours.lrs[0] == torch.as_tensor(lrs[0])).all()
    for s in range(S):
        one = optim.plateau_step(
            optim.PlateauState(torch.as_tensor(lrs[s]), torch.tensor(best[s]), torch.tensor(num_bad[s])),
            torch.tensor(metric[s]), **kw)
        assert torch.equal(one.lrs, ours.lrs[s]) and torch.equal(one.best, ours.best[s])
        assert torch.equal(one.num_bad, ours.num_bad[s]) and one.lrs.shape == (G,)


def test_state_from_jax_carries_a_stacked_state():
    cfg, jcfg, spec, jspec, x, modes, jparams = problem("fourier")
    jstate = jens.init_state(jparams, jcfg, 3, lr_scales=np.array([1.0, 0.5, 2.0], np.float32))
    ours = checkpoint.state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    assert ours.sched.lrs.shape == (3, 5) and ours.sched.best.shape == (3,) and ours.sched.num_bad.shape == (3,)
    assert ours.sched.num_bad.dtype == torch.int32 and ours.count == 0 and ours.epoch == 0
    mine = ensemble.init_state(ours.params, cfg, 3, lr_scales=[1.0, 0.5, 2.0])
    for k in ("lrs", "best", "num_bad"):
        assert torch.equal(getattr(mine.sched, k), getattr(ours.sched, k)), k
    for k, v in jparams.items():
        np.testing.assert_array_equal(ours.params[k].numpy(), np.asarray(v))
        assert torch.equal(mine.mu[k], ours.mu[k])


def run_packed(variant, steps, method, hypers=False):
    """``steps`` epochs of both packages' packed eager chunks from the same
    params."""
    cfg, jcfg, spec, jspec, x, modes, jparams = problem(variant)
    betas = lams = scales = None
    if hypers:
        betas, lams = np.array([1e-3, 5e-3, 1e-2], np.float32), np.array([1e-4, 1e-5, 1e-3], np.float32)
        scales = np.array([1.0, 0.5, 2.0], np.float32)
    batch, jbatch = batches(x, modes)
    model, jmodel = MODELS[variant]
    jgroups = jmodel.param_groups(jparams)
    jchunk = jens.make_ensemble_chunk(jens.build_loss(jspec, jcfg, 3, "factored", betas, lams), jgroups, jcfg, 3)
    jstate, jm = jchunk(jax.tree.map(jnp.array, jens.init_state(jparams, jcfg, 3, lr_scales=scales)), jbatch,
                        num_steps=steps)
    params = checkpoint.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    chunk = ensemble.make_ensemble_chunk(ensemble.build_loss(spec, cfg, 3, method, betas, lams),
                                         model.param_groups(params), cfg, 3)
    state, m = chunk(ensemble.init_state(params, cfg, 3, lr_scales=scales), batch, steps)
    return (state, m), (jax.tree.map(np.asarray, jstate), {k: np.asarray(v) for k, v in jm.items()})


@pytest.mark.parametrize("variant, method, hypers", [
    ("desmo", "factored", False), ("desmo", "fused", True), ("fourier", "factored", False), ("fourier", "fused", True)])
def test_packed_eager_chunk_matches_jax(variant, method, hypers):
    """20 epochs of the packed eager chunk against
    ``desmo_tpu.ensemble.make_ensemble_chunk``: the per-seed trace to 2e-4
    (the JAX suite's bound over 20 steps, ``tests/test_trajectory_parity.py``),
    the final params to 5e-4 and the per-seed LR rows to 1e-6."""
    (state, m), (jstate, jm) = run_packed(variant, 20, method, hypers)
    for k in ("rec", "ortho", "l1", "total_s"):
        assert m[k].shape == (20, 3)
        np.testing.assert_allclose(m[k].numpy(), jm[k], rtol=2e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(m["total"].numpy(), jm["total"], rtol=2e-4)
    for k, v in jstate.params.items():
        np.testing.assert_allclose(state.params[k].numpy(), v, rtol=5e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(state.sched.lrs.numpy(), jstate.sched.lrs, rtol=1e-6)
    assert state.count == int(jstate.opt.count) == 20 and state.epoch == 20


def test_packed_eager_chunk_matches_the_plain_packed_chunk():
    """The eager chunk (autograd) against the kernel's plain packed chunk
    (analytic gradients) from the same state: same arithmetic up to the
    order of fp32 sums, held to 1e-4 over 20 epochs."""
    from desmo_tpu_torch.kernels import train_chunk

    cfg, _, spec, _, x, modes, jparams = problem("desmo")
    batch, _ = batches(x, modes)
    params = checkpoint.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    state = ensemble.init_state(params, cfg, 3)
    chunk = ensemble.make_ensemble_chunk(ensemble.build_loss(spec, cfg, 3), desmo.param_groups(params), cfg, 3)
    se, me = chunk(state, batch, 20)
    sp, mp = train_chunk.train_chunk_plain_packed(state, batch, 20, spec, cfg)
    for k in ("rec", "l1", "total_s"):
        np.testing.assert_allclose(me[k].numpy(), mp[k].numpy(), rtol=1e-4, err_msg=k)
    for k in params:
        np.testing.assert_allclose(se.params[k].numpy(), sp.params[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def _fit(variant="desmo", n_seeds=3, **kw):
    cfg, _, spec, _, x, modes, _ = problem(variant)
    cfg = dataclasses.replace(cfg, checkpoint_every=kw.pop("checkpoint_every", 8))
    batch, _ = batches(x, modes)
    logs = []
    out = ensemble.fit(cfg, spec, batch, n_seeds=n_seeds, num_epochs=kw.pop("num_epochs", 16), log=logs.append, **kw)
    return out, logs, cfg, spec, batch


def test_fit_keeps_the_best_seed_and_checkpoints_every_chunk():
    saved = []
    report = {}
    (result, best, finals), logs, cfg, spec, batch = _fit(
        phi_sigma=0.1, omega_spread=0.2, checkpoint_fn=lambda st, ep: saved.append((st, ep)), report=report)
    assert finals.shape == (3,) and np.isfinite(finals).all()
    assert int(best) == int(np.argmin(finals))
    assert result.state.epoch == 16 and result.history["total"].shape == (16,)
    np.testing.assert_allclose(result.history["total"][-1], finals[best], rtol=0)
    assert [ep for _, ep in saved] == [8, 16]
    assert all(st.params["phi"].shape == (spec.r, spec.n) for st, _ in saved)
    assert report["live_seeds"] == [0, 1, 2] and len(report["seed_params"]) == 3 and report["hypers"] is None
    np.testing.assert_allclose(report["final_recs"], [float(v) for v in report["final_recs"]])
    assert any("best seed" in line for line in logs)
    # the winner resumes on the one-model eager chunk
    loss = desmo.build_loss(spec, cfg.beta, cfg.l1_lambda)
    cont = train.fit(loss, desmo.param_groups(result.state.params), cfg, None, batch, num_epochs=4, log=None,
                     state=result.state)
    assert cont.state.epoch == 20 and np.isfinite(cont.history["total"]).all()


def test_fit_rolls_back_and_freezes_diverged_seeds():
    """Seeds 1 and 2 overflow at init (phi jitter 1e200): they are blamed at
    the first bad step and frozen, seed 0 (the reference init) finishes and
    wins (``test_fit_kernel_path_recovers_from_diverged_seed``)."""
    (result, best, finals), logs, *_ = _fit(phi_sigma=1e200)
    assert best == 0 and np.isfinite(finals[0]) and np.isinf(finals[1:]).all()
    assert any("diverged" in line for line in logs)
    assert result.history["total"].shape == (16,) and np.isfinite(result.history["total"]).all()


def test_fit_raises_when_every_seed_diverged():
    cfg, _, spec, _, x, modes, _ = problem()
    batch, _ = batches(x, modes)
    batch["x"] = batch["x"].clone()
    batch["x"][0, 0] = float("inf")
    with pytest.raises(FloatingPointError, match="every seed diverged"):
        ensemble.fit(cfg, spec, batch, n_seeds=2, num_epochs=4, log=None)


def test_fit_selects_by_rec_under_a_sweep():
    """Under a hyper sweep the totals weight ortho and L1 differently, so the
    winner is the seed of the lowest final rec."""
    cfg, _, spec, _, x, modes, _ = problem()
    cfg = dataclasses.replace(cfg, sweep_lam=(1e-4, 10.0), checkpoint_every=6)
    batch, _ = batches(x, modes)
    report = {}
    result, best, finals = ensemble.fit(cfg, spec, batch, n_seeds=2, num_epochs=12, log=None, report=report)
    np.testing.assert_array_equal(report["hypers"]["lams"], np.array([1e-4, 10.0], np.float32))
    assert best == int(np.argmin(report["final_recs"]))
    assert finals[1] > finals[0]  # the lambda-10 seed's total is large whatever its rec


def test_fit_runs_groups_beyond_the_cap():
    """K=47 (r=4, P=3) packs two seeds: three seeds run as two groups; only
    global seed 0 keeps the reference init."""
    cfg, _, spec, _, x, modes, _ = problem(r=4, P=3)
    assert ensemble.max_seeds_packed(spec) == 2
    batch, _ = batches(x, modes)
    saved, report = [], {}
    result, best, finals = ensemble.fit(cfg, spec, batch, n_seeds=3, num_epochs=6, log=None, report=report,
                                        checkpoint_fn=lambda st, ep: saved.append(ep))
    assert finals.shape == (3,) and report["live_seeds"] == [0, 1, 2] and saved == [6, 6]
    assert not torch.equal(report["seed_params"][2]["phi"], torch.ones_like(report["seed_params"][2]["phi"]))


def test_fit_fourier_period_multistart():
    """The packed period multi-start: the FFT candidates land as per-seed
    period inits, and extra candidates are called out."""
    cfg, _, spec, _, x, modes, _ = problem("fourier")
    cfg = dataclasses.replace(cfg, period_multistart=4)
    batch, _ = batches(x, modes)
    logs, report = [], {}
    result, best, finals = ensemble.fit(cfg, spec, batch, n_seeds=2, num_epochs=6, log=logs.append, report=report)
    assert any("period candidates" in line for line in logs)
    periods = [float(p["period"][0]) for p in report["seed_params"]]
    assert np.isfinite(finals).all() and len(set(periods)) == 2
    assert result.state.params["period"].shape == (spec.num_poly_terms,)


def test_fit_refuses_a_mesh():
    """Over a mesh fit runs the sharded packed chunk alone
    (``tests/test_torch_shard_ensemble.py``): the packed eager loop
    (``chunk_method='scan'``) raises, naming its item."""
    cfg, _, spec, _, x, modes, _ = problem()
    mesh = parallel.make_mesh(1, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 5.2: the eager path over a mesh"):
        ensemble.fit(dataclasses.replace(cfg, chunk_method="scan"), spec, batches(x, modes)[0], n_seeds=2,
                     num_epochs=2, device_mesh=mesh, log=None)


def test_term_stability_matches_jax():
    cfg, jcfg, spec, jspec, x, modes, jparams = problem("desmo", S=3)
    seeds = [jens.extract_seed(jparams, s) for s in range(3)]
    ref = jens.term_stability(seeds, jspec, threshold=1.0)
    ours = ensemble.term_stability([checkpoint.params_from_jax(jax.tree.map(np.asarray, p), "cpu") for p in seeds],
                                   spec, threshold=1.0)
    assert ours["names"] == ref["names"]
    np.testing.assert_allclose(ours["energies"], ref["energies"], rtol=1e-5)
    np.testing.assert_array_equal(ours["frequency"], ref["frequency"])
    np.testing.assert_allclose(ours["mean"], ref["mean"], rtol=1e-5)


@pytest.mark.parametrize("sweep", [False, True])
def test_runner_writes_ensemble_records_matching_jax(tmp_path, sweep):
    """``runner.run`` with n_seeds=2 against ``desmo_tpu.runner.run``, with
    the phi jitter off (so both packages start every seed alike) and omega at
    1: ensemble.json's and term_stability.json's values agree (totals and
    recs to 1e-4), and the kept seed's run is the reference's. With a sweep
    of lambda the records carry the grid."""
    over = dict(sweep_lam=(1e-4, 1e-3)) if sweep else {}
    cfg = dataclasses.replace(
        configs.get("cylinder"), r=2, poly_order=2, num_epochs=30, checkpoint_every=15, n_seeds=2,
        seed_phi_sigma=0.0, omega_init=1.0, lr_omega=1.0, loss_method="factored", **over,
    )
    x = jsynthetic.cylinder_wake(200, 60)
    ref = jrunner.run(jconfigs.RunConfig(**dataclasses.asdict(cfg)), x, out_dir=str(tmp_path / "jax"),
                      make_figures=False, echo=False)
    ours = runner.run(cfg, x, out_dir=str(tmp_path / "torch"), echo=False, device="cpu")
    records = {}
    for name in ("ensemble.json", "term_stability.json"):
        paths = [os.path.join(art.out_dir, name) for art in (ours, ref)]
        # under the sweep each (beta, lambda) has one live seed: no stability record
        assert os.path.exists(paths[0]) == os.path.exists(paths[1]) == (name == "ensemble.json" or not sweep)
        if os.path.exists(paths[0]):
            with open(paths[0]) as fh, open(paths[1]) as gh:
                records[name] = (json.load(fh), json.load(gh))
    got, want = records["ensemble.json"]
    assert set(got) == set(want) and got["best_seed"] == want["best_seed"] and got["n_seeds"] == 2
    np.testing.assert_allclose(got["final_totals"], want["final_totals"], rtol=1e-4)
    np.testing.assert_allclose(got["final_recs"], want["final_recs"], rtol=1e-4)
    assert got["diverged_seeds"] == want["diverged_seeds"] == []
    assert got["hypers"] == want["hypers"] and (got["hypers"] is not None) == sweep
    if not sweep:
        got, want = records["term_stability.json"]
        assert set(got) == set(want) and got["names"] == want["names"] and got["live_seeds"] == want["live_seeds"]
        assert got["frequency"] == want["frequency"] and got["hyper_group"] == want["hyper_group"]
        np.testing.assert_allclose(got["energy_mean"], want["energy_mean"], rtol=1e-3)
    np.testing.assert_allclose(ours.history["total"], ref.history["total"], rtol=1e-4)
    np.testing.assert_allclose(ours.relative_error, ref.relative_error, rtol=1e-4)
    files = set(os.listdir(ours.out_dir))
    assert {"state_epoch15.npz", "state_epoch30.npz", "state_final.npz", "cylinder_r2_final.pt"} <= files


def test_runner_single_seed_sweeps():
    """On one seed a grid of several combos raises and a single combo is an
    override (``desmo_tpu/runner.py:324-349``)."""
    cfg = dataclasses.replace(configs.get("cylinder"), sweep_beta=(1e-3, 1e-2))
    with pytest.raises(ValueError, match="n_seeds > 1"):
        runner.single_seed_sweep(cfg)
    one = runner.single_seed_sweep(dataclasses.replace(cfg, sweep_beta=(5e-4,), sweep_lr_scale=(2.0,)))
    assert one.beta == 5e-4 and one.lr_z == 2.0 * cfg.lr_z and one.sweep_beta == ()


def test_period_multistart_needs_seeds(tmp_path):
    """The period multi-start runs with packed seeds (the candidates as
    per-seed inits) and, since it was ported, with one seed too (the
    sequential probes, ``tests/test_torch_forecast.py``)."""
    cfg = dataclasses.replace(configs.get("fourier_cylinder"), n_fourier=3, period_init=20.0, period_multistart=4)
    runner.check_supported(dataclasses.replace(cfg, n_seeds=2))
    runner.check_supported(cfg)


@pytest.mark.parametrize("argv, want", [
    (["--seeds", "4"], dict(n_seeds=4)),
    (["--seeds", "3", "--seed-phi-sigma", "0.1", "--seed-omega-spread", "0.5"],
     dict(n_seeds=3, seed_phi_sigma=0.1, seed_omega_spread=0.5)),
    (["--sweep-beta", "1e-3,1e-2", "--sweep-lam", "1e-5,1e-4,1e-3"],
     dict(n_seeds=6, sweep_beta=(1e-3, 1e-2), sweep_lam=(1e-5, 1e-4, 1e-3))),
    (["--sweep-lr-scale", "0.5,2", "--seeds", "1"], dict(n_seeds=1, sweep_lr_scale=(0.5, 2.0))),
    (["--sweep-beta", "2e-3"], dict(n_seeds=1, sweep_beta=(2e-3,))),
])
def test_cli_seed_and_sweep_flags(monkeypatch, tmp_path, argv, want):
    """The flags reach the config, and the grid size sets the default
    n_seeds (``desmo_tpu/__main__.py:81-112``)."""
    from desmo_tpu_torch import __main__ as cli

    seen = {}

    def fake_run(cfg, x, **kw):
        seen["cfg"] = cfg
        raise SystemExit(0)

    monkeypatch.setattr(runner, "load_data", lambda cfg, **kw: (np.zeros((4, 3), np.float32), None))
    monkeypatch.setattr(runner, "run", fake_run)
    with pytest.raises(SystemExit):
        cli.main(["run", "--preset", "aneurysm", "--synthetic", "--device", "cpu", "--out-dir", str(tmp_path)] + argv)
    for k, v in want.items():
        assert getattr(seen["cfg"], k) == v, k


def test_cli_rejects_a_malformed_sweep(capsys):
    from desmo_tpu_torch import __main__ as cli

    assert cli.main(["run", "--preset", "cylinder", "--synthetic", "--device", "cpu", "--sweep-beta", "1e-3,x"]) == 2
    assert "comma-separated" in capsys.readouterr().err
