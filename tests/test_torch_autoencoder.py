"""The port's AE variant (``desmo_tpu_torch.models.autoencoder``) against
``desmo_tpu.models.autoencoder`` on identical weights, carried across as
numpy arrays: the forward, the loss terms and methods, the recipe's pieces,
the reference's state-dict keys, the sweep and the eager training loop."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from desmo_tpu import configs as jconfigs  # noqa: E402
from desmo_tpu import sparsify as jsparsify  # noqa: E402
from desmo_tpu import train as jtrain  # noqa: E402
from desmo_tpu.models import autoencoder as jae  # noqa: E402
from desmo_tpu_torch import checkpoint, configs, sparsify, train  # noqa: E402
from desmo_tpu_torch.models import autoencoder as ae  # noqa: E402

SIZE = dict(n=40, m=32, r=2, poly_order=2)


def specs(**over):
    args = {**SIZE, **over}
    return ae.AESpec(**args), jae.AESpec(**args)


def live_params(jspec, seed=43):
    """The JAX package's live init as numpy (the reference init's decoder
    is dead: every MLP weight's gradient is 0.0, so it proves nothing about
    the funnel's backward)."""
    return {k: np.asarray(v) for k, v in jae.init_params_live(jspec, seed=seed).items()}


def with_library(np_params, seed=0, omega=(0.5, 2.0)):
    """Random library parameters, so the dictionary's checks are not trivial."""
    rng = np.random.default_rng(seed)
    out = dict(np_params)
    for k in ("c", "z", "z_trig", "c_trig"):
        out[k] = rng.standard_normal(out[k].shape).astype(np.float32)
    out["omega"] = rng.uniform(*omega, (3, 2)).astype(np.float32)
    return out


def snapshots(spec, seed=1):
    return np.random.default_rng(seed).standard_normal((spec.n, spec.m)).astype(np.float32)


def both(np_params, x):
    return checkpoint.params_from_jax(np_params, "cpu"), {k: jnp.asarray(v) for k, v in np_params.items()}, \
        torch.as_tensor(x), jnp.asarray(x)


def test_init_shapes_order_and_omega_match_jax():
    spec, jspec = specs(n=3961, m=1001, omega_init=1e4)
    ours = ae.init_params(spec, seed=43)
    ref = jae.init_params(jspec, seed=43)
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == v.shape, k
    np.testing.assert_array_equal(ours["omega"].numpy(), np.asarray(ref["omega"]))
    # Xavier-uniform within its bound, zero biases (the distribution, not the bits)
    bound = np.sqrt(6.0 / (1001 + 256))
    w0 = ours["ae_enc_w0"]
    assert float(w0.abs().max()) <= bound and float(w0.std()) > 0.5 * bound / np.sqrt(3.0)
    assert all(float(ours[f"ae_{s}_b{i}"].abs().max()) == 0.0 for s in ("enc", "dec") for i in range(7))
    live = ae.init_params_live(spec, seed=43)
    assert list(live) == list(ref)
    assert float(live["ae_enc_b0"][0]) == pytest.approx(0.01) and float(live["ae_enc_b6"].abs().max()) == 0.0
    np.testing.assert_allclose(float(live["ae_enc_w1"].std()), np.sqrt(2.0 / 256), rtol=0.05)
    with pytest.raises(ValueError, match="r=2"):
        ae.init_params(ae.AESpec(10, 8, 3, 2))


def test_forward_matches_jax():
    spec, jspec = specs()
    np_params = with_library(live_params(jspec))
    tp, jp, tx, jx = both(np_params, snapshots(spec))
    recon, latent, z, ae_rec = ae.apply(tp, tx, spec)
    jrecon, jlatent, jz, jae_rec = jae.apply(jp, jx, jspec)
    np.testing.assert_allclose(latent.numpy(), np.asarray(jlatent), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ae_rec.numpy(), np.asarray(jae_rec), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))


def test_ortho_and_l1_match_jax():
    rng = np.random.default_rng(1)
    latent = rng.standard_normal((30, 2)).astype(np.float32)
    np.testing.assert_allclose(float(ae.ae_orthogonality(torch.as_tensor(latent))),
                               float(jae.ae_orthogonality(jnp.asarray(latent))), rtol=1e-6)
    np.testing.assert_allclose(float(ae.ae_orthogonality(torch.as_tensor(latent))),
                               np.mean(np.outer(latent[:, 0], latent[:, 1]) ** 2), rtol=1e-5)
    spec, jspec = specs()
    np_params = with_library(live_params(jspec))
    tp, jp, _, _ = both(np_params, snapshots(spec))
    np.testing.assert_allclose(float(ae.ae_sparsity_l1(tp)), float(jae.ae_sparsity_l1(jp)), rtol=1e-6)


@pytest.mark.parametrize("method", ["factored", "naive", "fused"])
def test_loss_and_gradients_match_jax(method):
    """Every loss method against the JAX package's, value, metrics and
    gradient (autograd against jax.grad). ``fused`` runs the dual
    contraction's plain version on the CPU, as the JAX package runs its
    Pallas kernel in interpret mode."""
    spec, jspec = specs()
    np_params = with_library(live_params(jspec), omega=(0.5, 1.5))
    tp, jp, tx, jx = both(np_params, snapshots(spec))
    batch = {"x": tx, "x_sq": torch.sum(tx * tx), "x_colsum": tx.sum(0)}
    jbatch = {"x": jx, "x_sq": jnp.sum(jx * jx), "x_colsum": jnp.sum(jx, axis=0)}
    loss = ae.build_loss(spec, 1e-3, 1e-6, 0.5, method=method)
    jloss = jae.build_loss(jspec, 1e-3, 1e-6, 0.5, method=method)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    total, mets = loss(leaves, batch)
    grads = torch.autograd.grad(total, list(leaves.values()))
    (jtotal, jmets), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp, jbatch)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=2e-5)
    assert set(mets) == set(jmets) == {"rec", "ortho", "l1", "ae"}
    for k in mets:
        np.testing.assert_allclose(float(mets[k].detach()), float(jmets[k]), rtol=2e-5, atol=1e-9, err_msg=k)
    for k, g in zip(leaves, grads):
        ref = np.asarray(jgrads[k])
        scale = max(np.abs(ref).max(), 1e-8)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-3, atol=1e-4 * scale, err_msg=k)


def test_factored_ae_mse_equals_naive():
    """``factored_ae_mse`` against the materialized decode, value and
    gradients (the port against itself), and without the batch helpers."""
    spec, jspec = specs()
    tp, _, tx, _ = both(live_params(jspec, seed=5), snapshots(spec, seed=7))
    out = []
    for method in ("factored", "naive"):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        total, mets = ae.build_loss(spec, 1e-3, 1e-6, 1.0, method=method)(leaves, {"x": tx})
        out.append((total, mets, torch.autograd.grad(total, list(leaves.values()))))
    (tf, mf, gf), (tn, mn, gn) = out
    np.testing.assert_allclose(float(mf["ae"].detach()), float(mn["ae"].detach()), rtol=1e-5)
    np.testing.assert_allclose(float(tf.detach()), float(tn.detach()), rtol=1e-5)
    for k, a, b in zip(tp, gf, gn):
        scale = max(float(b.abs().max()), 1e-8)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4, atol=5e-5 * scale, err_msg=k)
    with pytest.raises(ValueError, match="loss method"):
        ae.build_loss(spec, 1e-3, 1e-6, 1.0, method="exact")


def test_tanh_receives_no_gradient():
    spec, jspec = specs()
    tp, _, tx, _ = both(with_library(jae_init(jspec)), snapshots(spec, seed=2))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    total, _ = ae.build_loss(spec, 1e-3, 1e-6, 1e-3)(leaves, {"x": tx})
    g = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
    for k in ("z_trig", "c_trig", "omega"):
        assert torch.all(g[k][2] == 0.0), k
    assert torch.any(g["z_trig"][0] != 0.0)


def jae_init(jspec):
    return {k: np.asarray(v) for k, v in jae.init_params(jspec, seed=3).items()}


def test_live_init_has_gradient_flow():
    """The port's own live init: every MLP weight gets a gradient from the
    AE reconstruction and the latents vary over the points; the library
    parameters are the reference init's."""
    spec, _ = specs(n=96, m=64)
    x = torch.as_tensor(snapshots(spec, seed=0))
    params = ae.init_params_live(spec, seed=43)
    ref = ae.init_params(spec, seed=43)
    for k in ("c", "z", "z_trig", "c_trig", "omega"):
        assert torch.equal(params[k], ref[k])
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    _, rec = ae.encode_decode(leaves, x)
    g = dict(zip(leaves, torch.autograd.grad(torch.mean((rec - x) ** 2), list(leaves.values()),
                                             allow_unused=True)))
    for k in leaves:
        if k.startswith("ae_") and "_w" in k:
            assert float(g[k].abs().max()) > 0.0, f"dead gradient at {k}"
    lat, _ = ae.encode_decode(params, x)
    assert bool((lat.std(0) > 1e-3).all())


def test_warmup_loss_matches_jax():
    spec, jspec = specs()
    tp, jp, tx, jx = both(live_params(jspec), snapshots(spec))
    total, mets = ae.build_warmup_loss(spec)(tp, {"x": tx})
    jtotal, jmets = jae.build_warmup_loss(jspec)(jp, {"x": jx})
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    assert set(mets) == set(jmets)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    g = dict(zip(leaves, torch.autograd.grad(ae.build_warmup_loss(spec)(leaves, {"x": tx})[0],
                                             list(leaves.values()), allow_unused=True)))
    assert all(g[k] is None or float(g[k].abs().max()) == 0.0 for k in ("z", "omega", "c"))


def test_data_scaled_omega_matches_jax():
    spec, jspec = specs()
    tp, jp, tx, jx = both(live_params(jspec), snapshots(spec))
    om = ae.data_scaled_omega(tp, tx)
    np.testing.assert_allclose(om.numpy(), np.asarray(jae.data_scaled_omega(jp, jx)), rtol=1e-5)
    np.testing.assert_allclose((om[1] / om[0]).numpy(), 0.1, rtol=1e-6)
    np.testing.assert_allclose((om[2] / om[0]).numpy(), 0.01, rtol=1e-6)


def test_state_dict_round_trip_matches_jax():
    """The export's keys and values equal the JAX package's
    ``state_dict_from_params`` on the same params, through the model module
    and through ``checkpoint`` with ``variant="ae"``, and read back."""
    spec, jspec = specs()
    np_params = with_library(live_params(jspec))
    tp, jp, _, _ = both(np_params, snapshots(spec))
    ref = jae.state_dict_from_params(jp)
    for sd in (ae.state_dict_from_params(tp), checkpoint.state_dict_from_params(tp, "ae")):
        assert list(sd) == list(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    assert ae.is_ae_state_dict(ref) and ae.infer_spec_dims(ref) == (2, 2) == jae.infer_spec_dims(ref)
    back = checkpoint.params_from_state_dict(ref, "cpu", variant="ae")
    assert list(back) == list(tp)
    for k in tp:
        assert torch.equal(back[k], tp[k]), k


def test_sweep_matches_jax():
    """``threshold_sweep`` on the AE variant (energies on the encoder latent,
    reconstructions from X) against the JAX package's."""
    spec, jspec = specs()
    np_params = with_library(live_params(jspec))
    tp, jp, tx, jx = both(np_params, snapshots(spec))
    got = sparsify.threshold_sweep(tp, {"x": tx}, spec)
    want = jsparsify.threshold_sweep(jp, {"x": jx}, jspec, variant="ae")
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        assert g.threshold == w.threshold and g.nonzero_terms == w.nonzero_terms
        np.testing.assert_allclose(g.error, w.error, rtol=1e-4)


def ae_cfg(**over):
    base = dict(n=SIZE["n"], m=SIZE["m"], num_epochs=20, patience=5, sched_every=1, log_every=100,
                checkpoint_every=1000, omega_init=1.0, lr_coef=1e-3, lr_z=1e-3, lr_omega=1e-2)
    return dataclasses.replace(configs.get("ae_cylinder"), **{**base, **over})


def test_eager_chunk_matches_jax():
    """The eager loop on the factored AE loss against
    ``desmo_tpu.train.make_train_chunk`` from the same state, 20 steps at
    omega_init=1 (at the preset's 1e4 a 1-ulp latent difference flips the
    signs of sin): the trace to 2e-4, every metric the loss returns kept."""
    cfg = ae_cfg()
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    spec, jspec = specs(omega_init=1.0)
    np_params = live_params(jspec)
    x = snapshots(spec, seed=4)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    jloss = jae.build_loss(jspec, cfg.beta, cfg.l1_lambda, cfg.ae_beta, method="factored")
    jchunk = jtrain.make_train_chunk(jloss, jae.param_groups(jp), jcfg)
    jstate = jtrain.init_state(jp, jcfg)
    xj = jnp.asarray(x)
    _, jm = jchunk(jax.tree.map(jnp.array, jstate), {"x": xj, "x_sq": jnp.sum(xj * xj)}, num_steps=20)
    state = checkpoint.state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    xt = torch.as_tensor(x)
    loss = ae.build_loss(spec, cfg.beta, cfg.l1_lambda, cfg.ae_beta, method="factored")
    _, mets = train.make_train_chunk(loss, ae.param_groups(state.params), cfg)(
        state, {"x": xt, "x_sq": torch.sum(xt * xt)}, 20)
    assert list(mets) == ["rec", "ortho", "l1", "ae", "total"]
    for k in mets:
        np.testing.assert_allclose(mets[k].numpy(), np.asarray(jm[k]), rtol=2e-4, atol=1e-9, err_msg=k)


def test_fit_history_keeps_ae():
    """``train.fit`` keeps every metric the loss returns, ``ae`` included;
    the desmo keys are unchanged."""
    cfg = ae_cfg()
    spec, _ = specs(omega_init=1.0)
    params = ae.init_params_live(spec)
    xt = torch.as_tensor(snapshots(spec, seed=4))
    loss = ae.build_loss(spec, cfg.beta, cfg.l1_lambda, cfg.ae_beta)
    res = train.fit(loss, ae.param_groups(params), cfg, params, {"x": xt}, num_epochs=12, chunk_size=5, log=None)
    assert set(res.history) == {"rec", "ortho", "l1", "ae", "total"}
    assert all(v.shape == (12,) for v in res.history.values())
    assert res.history["ae"][-1] < res.history["ae"][0]
