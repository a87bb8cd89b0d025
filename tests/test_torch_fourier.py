"""The port's Fourier variant (``desmo_tpu_torch.models.fourier``) against
``desmo_tpu.models.fourier`` on identical weights: the series, the forward,
the loss and its gradients, the weights' key scheme, the term energies and
sweep, and the eager training loop."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from desmo_tpu import checkpoint as jckpt  # noqa: E402
from desmo_tpu import configs as jconfigs  # noqa: E402
from desmo_tpu import sparsify as jsparsify  # noqa: E402
from desmo_tpu import train as jtrain  # noqa: E402
from desmo_tpu.models import fourier as jfourier  # noqa: E402
from desmo_tpu_torch import checkpoint, configs, sparsify, train  # noqa: E402
from desmo_tpu_torch.models import fourier  # noqa: E402

SPEC = dict(n=90, m=40, r=2, poly_order=2, omega_init=3.0, n_fourier=4, period_init=25.0)


def specs(**over):
    args = {**SPEC, **over}
    return fourier.FourierSpec(**args), jfourier.FourierSpec(**args)


def random_params(spec, seed=0):
    """A trained-looking (non-init) Fourier parameter set, as numpy."""
    rng = np.random.default_rng(seed)
    T, r, n, nc = spec.num_poly_terms, spec.r, spec.n, 2 * spec.n_fourier + 1
    np_params = {
        "phi": 1.0 + 0.3 * rng.standard_normal((r, n)),
        "c": rng.standard_normal(T),
        "z": 0.3 * rng.standard_normal((T, nc)),
        "period": spec.period_init * (1.0 + 0.2 * rng.random(T)),
        "z_trig": 0.3 * rng.standard_normal((3, r, nc)),
        "trig_period": spec.period_init * (1.0 + 0.2 * rng.random((3, r))),
        "c_trig": rng.standard_normal((3, r)),
        "omega": spec.omega_init * (1.0 + 0.1 * rng.standard_normal((3, r))),
    }
    return {k: v.astype(np.float32) for k, v in np_params.items()}


def data(spec, seed=1):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((spec.n, spec.r)))
    return q.astype(np.float32), rng.standard_normal((spec.n, spec.m)).astype(np.float32)


def test_t_points_and_init_match_jax():
    for m in (24, 40, 1001):
        got = fourier.t_points(m)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jfourier.t_points(m))
    spec, jspec = specs(omega_init=1e4)
    ours = fourier.Fourier(spec).params()
    ref = jfourier.init_params(jspec)
    assert list(ours) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].detach().numpy(), np.asarray(v), err_msg=k)
    assert fourier.param_groups(ours) == jfourier.param_groups(ref)


@pytest.mark.parametrize("nf, period", [(4, 25.0), (30, 1000.0)])
def test_series_matches_jax(nf, period):
    """Held to 1e-5 of the series' largest value: the same float32 angles,
    cos and sin of two libraries."""
    spec, _ = specs(n_fourier=nf, period_init=period)
    np_params = random_params(spec, seed=nf)
    params = checkpoint.params_from_jax(np_params, "cpu")
    t = fourier.t_points(spec.m)
    z = fourier.fourier_series_batch(params["z_trig"], params["trig_period"], torch.as_tensor(t))
    ref = np.asarray(jfourier.fourier_series_batch(
        jnp.asarray(np_params["z_trig"]), jnp.asarray(np_params["trig_period"]), jnp.asarray(t)))
    assert z.shape == (3, spec.r, spec.m)
    np.testing.assert_allclose(z.numpy(), ref, atol=1e-5 * np.abs(ref).max())
    zt, ztt = fourier.temporal_values(params, torch.as_tensor(t))
    jz, jzt = jfourier.temporal_values({k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(t))
    np.testing.assert_allclose(zt.numpy(), np.asarray(jz), atol=1e-5 * np.abs(np.asarray(jz)).max())
    np.testing.assert_allclose(ztt.numpy(), np.asarray(jzt), atol=1e-5 * np.abs(np.asarray(jzt)).max())


def test_apply_matches_jax():
    spec, jspec = specs()
    np_params = random_params(spec)
    pod_modes, _ = data(spec)
    recon, lat, z = fourier.apply(checkpoint.params_from_jax(np_params, "cpu"), torch.as_tensor(pod_modes), spec)
    jrecon, jlat, jz = jfourier.apply({k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pod_modes), jspec)
    scale = np.abs(np.asarray(jrecon)).max()
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(jrecon), atol=1e-5 * scale)
    np.testing.assert_allclose(lat.detach().numpy(), np.asarray(jlat), rtol=1e-6)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz), atol=1e-5 * np.abs(np.asarray(jz)).max())


@pytest.mark.parametrize("method", ["factored", "fused", "direct"])
def test_build_loss_value_and_grads_match_jax(method):
    """Value and metrics to 1e-5, every gradient (periods included, through
    jax.grad) to 2e-4 of its largest entry."""
    spec, jspec = specs()
    np_params = random_params(spec, seed=2)
    pod_modes, x = data(spec, seed=3)
    batch = {"x": torch.as_tensor(x), "pod_modes": torch.as_tensor(pod_modes)}
    batch["x_sq"] = torch.sum(batch["x"] ** 2)
    jbatch = {"x": jnp.asarray(x), "pod_modes": jnp.asarray(pod_modes), "x_sq": jnp.sum(jnp.asarray(x) ** 2)}

    params = {k: v.requires_grad_(True) for k, v in checkpoint.params_from_jax(np_params, "cpu").items()}
    total, metrics = fourier.build_loss(spec, 1e-3, 1e-4, method=method)(params, batch)
    grads = torch.autograd.grad(total, list(params.values()))

    jloss = jfourier.build_loss(jspec, 1e-3, 1e-4, method=method)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jbatch
    )
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for key in ("rec", "ortho", "l1"):
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]), rtol=1e-5)
    for key, g in zip(params, grads):
        ref = np.asarray(jgrads[key])
        assert np.abs(g.numpy() - ref).max() < 2e-4 * (np.abs(ref).max() + 1e-30), key


def test_state_dict_matches_jax_key_scheme(tmp_path):
    spec, _ = specs()
    np_params = random_params(spec, seed=4)
    sd = checkpoint.state_dict_from_params(checkpoint.params_from_jax(np_params, "cpu"), "fourier")
    ref = jckpt.state_dict_from_params(np_params, "fourier")
    assert list(sd) == list(ref)
    assert "period_list.0" in sd and "trig_period_list.5" in sd
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(ref[k]), err_msg=k)
    back = checkpoint.params_from_state_dict(sd, "cpu", "fourier")
    assert set(back) == set(np_params)
    for k, v in np_params.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    path = str(tmp_path / "f.pt")
    checkpoint.save_pt(path, sd)
    via_jax = jckpt.params_from_state_dict(jckpt.load_pt(path), "fourier")
    for k, v in np_params.items():
        np.testing.assert_array_equal(np.asarray(via_jax[k]), v, err_msg=k)


def test_term_energies_and_sweep_match_jax():
    """The energies (the reference's column-slice convention included) to
    1e-5, the sweep's errors to 1e-5 and its counts exactly."""
    spec, jspec = specs()
    np_params = random_params(spec, seed=5)
    pod_modes, x = data(spec, seed=6)
    params = checkpoint.params_from_jax(np_params, "cpu")
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    ours = sparsify.term_energies(params, spec)
    ref = jsparsify.term_energies(jparams, spec=jspec)
    np.testing.assert_allclose(ours.poly, ref.poly, rtol=1e-5)
    np.testing.assert_allclose(ours.trig, ref.trig, rtol=1e-5)
    # thresholds between the energies, so that the sweep drops terms one by one
    energies = np.sort(np.concatenate([ref.poly, ref.trig.reshape(-1)]))
    thresholds = list(np.sqrt(energies[:-1] * energies[1:]))
    batch = {"x": torch.as_tensor(x), "pod_modes": torch.as_tensor(pod_modes)}
    got = sparsify.threshold_sweep(params, batch, spec, thresholds=thresholds)
    want = jsparsify.threshold_sweep(
        jparams, {"x": jnp.asarray(x), "pod_modes": jnp.asarray(pod_modes)}, jspec,
        variant="fourier", thresholds=thresholds,
    )
    assert [e.nonzero_terms for e in got] == [e.nonzero_terms for e in want]
    np.testing.assert_allclose([e.error for e in got], [e.error for e in want], rtol=1e-5)


def test_period_candidates_match_jax():
    rng = np.random.default_rng(7)
    t = np.arange(200)
    x = (np.outer(rng.standard_normal(50), np.sin(2 * np.pi * t / 37.0))
         + 0.1 * rng.standard_normal((50, 200))).astype(np.float32)
    for init in (60.0, 0.0, 37.5):
        assert fourier.period_candidates(x, init) == jfourier.period_candidates(x, init)
    modes = np.linalg.qr(rng.standard_normal((50, 2)))[0].astype(np.float32)
    assert fourier.period_candidates(x, 60.0, pod_modes=modes) == jfourier.period_candidates(x, 60.0, pod_modes=modes)
    with pytest.raises(ValueError, match="finite"):
        fourier.period_candidates(x, float("nan"))


def test_eager_loop_trace_matches_jax_train_chunk():
    """The port's eager loop (autograd, all five LR groups) against
    ``desmo_tpu.train.make_train_chunk`` on the Fourier loss, from the same
    init: the trace to 2e-4 over 20 steps
    (``tests/test_trajectory_parity.py:129-134``)."""
    spec, jspec = specs(omega_init=1.0, n_fourier=3, period_init=40.0)
    cfg = dataclasses.replace(
        configs.get("fourier_cylinder"), n=spec.n, m=spec.m, r=spec.r, poly_order=spec.poly_order,
        omega_init=1.0, lr_omega=1.0, n_fourier=3, period_init=40.0, patience=5, sched_every=2,
    )
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    pod_modes, _ = data(spec, seed=8)
    s = np.linspace(0, 2 * np.pi, spec.n)
    tt = fourier.t_points(spec.m)
    x = (np.outer(np.sin(s), np.sin(2 * np.pi * tt / 40.0))
         + 0.5 * np.outer(np.cos(s), np.cos(4 * np.pi * tt / 40.0))).astype(np.float32)
    steps = 20

    jparams = jfourier.init_params(jspec)
    jloss = jfourier.build_loss(jspec, cfg.beta, cfg.l1_lambda, method="factored")
    jchunk = jtrain.make_train_chunk(jloss, jfourier.param_groups(jparams), jcfg)
    jstate = jax.tree.map(jnp.array, jtrain.init_state(jparams, jcfg))
    jstate, jmetrics = jchunk(jstate, {"x": jnp.asarray(x), "pod_modes": jnp.asarray(pod_modes)}, num_steps=steps)

    params = fourier.Fourier(spec).params()
    loss_fn = fourier.build_loss(spec, cfg.beta, cfg.l1_lambda, method="factored")
    batch = {"x": torch.as_tensor(x), "pod_modes": torch.as_tensor(pod_modes)}
    res = train.fit(loss_fn, fourier.param_groups(params), cfg, params, batch, num_epochs=steps, log=None)
    for key in train.METRICS:
        np.testing.assert_allclose(res.history[key], np.asarray(jmetrics[key]), rtol=2e-4, atol=1e-7, err_msg=key)
    # the periods trained, under their own group's LR
    assert not torch.equal(res.state.params["period"], params["period"])
    np.testing.assert_allclose(res.state.params["period"].numpy(), np.asarray(jstate.params["period"]), rtol=1e-5)
    np.testing.assert_allclose(res.state.sched.lrs.numpy(), np.asarray(jstate.sched.lrs), rtol=1e-6)
