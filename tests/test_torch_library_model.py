"""The port's library, losses and DESMO model against the JAX package, on
identical weights (carried over with ``checkpoint.params_from_jax``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from desmo_tpu import library as jlib  # noqa: E402
from desmo_tpu import losses as jlosses  # noqa: E402
from desmo_tpu.models import desmo as jdesmo  # noqa: E402
from desmo_tpu_torch import checkpoint, library, losses  # noqa: E402
from desmo_tpu_torch.models import desmo  # noqa: E402


@pytest.mark.parametrize("r,P", [(2, 2), (4, 3), (8, 2)])
def test_library_tables_equal_jax(r, P):
    assert library.num_poly_terms(r, P) == jlib.num_poly_terms(r, P)
    np.testing.assert_array_equal(library.factor_table(r, P), jlib.factor_table(r, P))
    np.testing.assert_array_equal(library.monomial_exponents(r, P), jlib.monomial_exponents(r, P))
    assert library.poly_term_names(r, P) == jlib.poly_term_names(r, P)
    assert library.trig_term_names(r) == jlib.trig_term_names(r)
    assert library.TRIG_KINDS == jlib.TRIG_KINDS


def _setup(seed=0, n=90, m=40, r=2, P=2, omega_init=3.0):
    """A trained-looking (non-init) parameter set, as numpy, plus a batch."""
    rng = np.random.default_rng(seed)
    spec_args = (n, m, r, P, omega_init)
    T = jlib.num_poly_terms(r, P)
    np_params = {
        "phi": 1.0 + 0.3 * rng.standard_normal((r, n)),
        "c": rng.standard_normal(T),
        "z": 0.3 * rng.standard_normal((T, m)),
        "z_trig": 0.3 * rng.standard_normal((3, r, m)),
        "c_trig": rng.standard_normal((3, r)),
        "omega": omega_init * (1.0 + 0.1 * rng.standard_normal((3, r))),
    }
    np_params = {k: v.astype(np.float32) for k, v in np_params.items()}
    q, _ = np.linalg.qr(rng.standard_normal((n, r)))
    pod_modes = q.astype(np.float32)
    x = rng.standard_normal((n, m)).astype(np.float32)
    return spec_args, np_params, pod_modes, x


def test_model_init_matches_jax():
    spec = desmo.DesmoSpec(30, 20, 3, 2, 10000.0)
    ours = desmo.Desmo(spec).params()
    ref = jdesmo.init_params(jdesmo.DesmoSpec(30, 20, 3, 2, 10000.0))
    assert list(ours) == ["phi", "c", "z", "z_trig", "c_trig", "omega"]
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].detach().numpy(), np.asarray(v))
    assert desmo.param_groups(ours) == jdesmo.param_groups(ref)


def test_eval_library_and_forward_match_jax():
    spec_args, np_params, pod_modes, _ = _setup(r=3, P=3)
    spec, jspec = desmo.DesmoSpec(*spec_args), jdesmo.DesmoSpec(*spec_args)
    params = checkpoint.params_from_jax(np_params, "cpu")
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    pm, jpm = torch.as_tensor(pod_modes), jnp.asarray(pod_modes)
    factors = desmo.factor_tensor(spec, "cpu")

    latent = desmo.effective_modes(params, pm)
    theta = library.eval_library(latent, factors)
    jtheta = jlib.eval_library(jdesmo.effective_modes(jparams, jpm), jspec.factor_table())
    np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta), rtol=1e-5, atol=1e-7)

    A, _ = desmo.spatial_dictionary(params, pm, factors)
    jA, _ = jdesmo.spatial_dictionary(jparams, jpm, jspec.factor_table())
    np.testing.assert_allclose(A.detach().numpy(), np.asarray(jA), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        desmo.temporal_matrix(params).detach().numpy(), np.asarray(jdesmo.temporal_matrix(jparams))
    )
    recon, lat, z = desmo.apply(params, pm, spec)
    jrecon, jlat, _ = jdesmo.apply(jparams, jpm, jspec)
    scale = np.abs(np.asarray(jrecon)).max()
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(jrecon), atol=1e-5 * scale)
    np.testing.assert_allclose(lat.detach().numpy(), np.asarray(jlat), rtol=1e-6)


def test_losses_match_jax():
    _, np_params, pod_modes, x = _setup(seed=1)
    rng = np.random.default_rng(5)
    a = (0.3 * rng.standard_normal((90, 11))).astype(np.float32)
    b = (0.3 * rng.standard_normal((11, 40))).astype(np.float32)
    ta, tb, tx = map(torch.as_tensor, (a, b, x))
    np.testing.assert_allclose(
        float(losses.factored_mse(ta, tb, tx)), float(jlosses.factored_mse(a, b, x)), rtol=1e-5
    )
    np.testing.assert_allclose(float(losses.mse(ta @ tb, tx)), float(jlosses.mse(a @ b, x)), rtol=1e-5)
    np.testing.assert_allclose(
        float(losses.orthogonality(torch.as_tensor(pod_modes * 2 + 0.1))),
        float(jlosses.orthogonality(jnp.asarray(pod_modes * 2 + 0.1))),
        rtol=1e-5,
    )
    params = checkpoint.params_from_jax(np_params, "cpu")
    np.testing.assert_allclose(
        float(losses.sparsity_l1(params)),
        float(jlosses.sparsity_l1({k: jnp.asarray(v) for k, v in np_params.items()})),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(losses.relative_frobenius_error(tx, ta @ tb)),
        float(jlosses.relative_frobenius_error(jnp.asarray(x), jnp.asarray(a @ b))),
        rtol=1e-5,
    )


@pytest.mark.parametrize("method", ["factored", "fused", "direct"])
def test_build_loss_value_and_grads_match_jax(method):
    spec_args, np_params, pod_modes, x = _setup(seed=2)
    spec, jspec = desmo.DesmoSpec(*spec_args), jdesmo.DesmoSpec(*spec_args)
    batch = {"x": torch.as_tensor(x), "pod_modes": torch.as_tensor(pod_modes)}
    batch["x_sq"] = torch.sum(batch["x"] ** 2)
    jbatch = {"x": jnp.asarray(x), "pod_modes": jnp.asarray(pod_modes)}
    jbatch["x_sq"] = jnp.sum(jbatch["x"] ** 2)

    params = {k: v.requires_grad_(True) for k, v in checkpoint.params_from_jax(np_params, "cpu").items()}
    total, metrics = desmo.build_loss(spec, 1e-3, 1e-4, method=method)(params, batch)
    grads = torch.autograd.grad(total, list(params.values()))

    jloss = jdesmo.build_loss(jspec, 1e-3, 1e-4, method=method)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jbatch
    )
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for key in ("rec", "ortho", "l1"):
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]), rtol=1e-5)
    for key, g in zip(params, grads):
        ref = np.asarray(jgrads[key])
        scale = np.abs(ref).max() + 1e-30
        assert np.abs(g.numpy() - ref).max() < 2e-4 * scale, key
