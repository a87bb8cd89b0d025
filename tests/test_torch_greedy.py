"""Greedy pruning (``desmo_tpu_torch.sparsify.greedy_order`` and
``greedy_prune``) against ``desmo_tpu.sparsify`` on the same parameters, and
the channel preset, which turns it on, end to end on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

from desmo_tpu import configs as jconfigs  # noqa: E402
from desmo_tpu import runner as jrunner  # noqa: E402
from desmo_tpu import sparsify as jsparsify  # noqa: E402
from desmo_tpu.models import desmo as jdesmo  # noqa: E402
from desmo_tpu.models import fourier as jfourier  # noqa: E402
from desmo_tpu_torch import checkpoint, configs, runner, sparsify  # noqa: E402
from desmo_tpu_torch.__main__ import main as cli_main  # noqa: E402
from desmo_tpu_torch.io import synthetic  # noqa: E402
from desmo_tpu_torch.models import desmo, fourier  # noqa: E402


def problem(variant, seed=0, n=40, m=23, r=3, P=2, ties=False):
    """Random parameters of one model of ``variant`` (numpy, float32), its
    batch, and both packages' specs. With ``ties`` some coefficients are 0,
    so that their terms' energies tie at 0 across both kinds."""
    rng = np.random.default_rng(seed)
    if variant == "fourier":
        jspec, spec = (mod.FourierSpec(n, m, r, P, 1.0, 2, 9.0) for mod in (jfourier, fourier))
        params = {k: v.detach().numpy() for k, v in fourier.Fourier(spec).params().items()}
    else:
        jspec, spec = jdesmo.DesmoSpec(n, m, r, P, 1.0), desmo.DesmoSpec(n, m, r, P, 1.0)
        params = {k: v.detach().numpy() for k, v in desmo.Desmo(spec).params().items()}
    for k in ("phi", "c", "z", "z_trig", "c_trig"):
        params[k] = rng.standard_normal(params[k].shape).astype(np.float32)
    params["omega"] = rng.uniform(0.5, 2.0, params["omega"].shape).astype(np.float32)
    if ties:
        params["c"][[1, 4]] = 0.0
        params["c_trig"][[0, 2], [1, 0]] = 0.0
    x = rng.standard_normal((n, m)).astype(np.float32)
    modes = rng.standard_normal((n, r)).astype(np.float32)
    jbatch = {"x": jnp.asarray(x), "pod_modes": jnp.asarray(modes)}
    batch = {"x": torch.as_tensor(x), "pod_modes": torch.as_tensor(modes)}
    return spec, checkpoint.params_from_jax(params, "cpu"), batch, jspec, {k: jnp.asarray(v) for k, v in params.items()}, jbatch


@pytest.mark.parametrize("variant, ties", [("desmo", False), ("desmo", True), ("fourier", False)])
def test_greedy_prune_curve_matches_jax(variant, ties):
    """The greedy curve (``tests/test_sparsify.py::test_greedy_prune_curve``):
    T + 3r + 1 steps from every term to none, whose last error is 1; the
    order, the errors (to 1e-5) and the counts equal ``desmo_tpu``'s on the
    same parameters, ties at zero energy included."""
    spec, params, batch, jspec, jparams, jbatch = problem(variant, ties=ties)
    total = spec.num_poly_terms + 3 * spec.r
    energies = sparsify.term_energies(params, spec)
    jenergies = jsparsify.term_energies(jparams, spec=jspec)
    order = sparsify.greedy_order(energies)
    assert [(kind, idx) for _, kind, idx in order] == [(kind, idx) for _, kind, idx in jsparsify.greedy_order(jenergies)]
    if ties:
        assert [(kind, idx) for _, kind, idx in order[:4]] == [("poly", 1), ("poly", 4), ("trig", (2, 0)),
                                                                ("trig", (0, 1))]
    lines = []
    got = sparsify.greedy_prune(params, batch, spec, log=lines.append)
    want = jsparsify.greedy_prune(jparams, jbatch, jspec, variant=variant)
    assert len(got) == total + 1 and len(lines) == total + 1 and lines[0].startswith("Step: 0, Error: ")
    assert [e.threshold for e in got] == list(range(total + 1))
    assert [e.nonzero_terms for e in got] == [e.nonzero_terms for e in want]
    assert got[0].nonzero_terms == total - (4 if ties else 0) and got[-1].nonzero_terms == 0
    np.testing.assert_allclose([e.error for e in got], [e.error for e in want], rtol=1e-5)
    np.testing.assert_allclose(got[-1].error, 1.0, rtol=1e-6)


def test_greedy_order_ties_keep_the_reference_order():
    """Equal energies keep the reference's insertion order: the polynomial
    terms in index order, then per latent its sin, cos and tanh."""
    energies = sparsify.TermEnergies(poly=np.array([2.0, 1.0, 1.0]), trig=np.array([[1.0, 0.5], [1.0, 3.0],
                                                                                    [0.5, 1.0]]))
    order = [(kind, idx) for _, kind, idx in sparsify.greedy_order(energies)]
    assert order == [("trig", (2, 0)), ("trig", (0, 1)), ("poly", 1), ("poly", 2), ("trig", (0, 0)),
                     ("trig", (1, 0)), ("trig", (2, 1)), ("poly", 0), ("trig", (1, 1))]
    assert order == [(kind, idx) for _, kind, idx in jsparsify.greedy_order(jsparsify.TermEnergies(
        poly=energies.poly, trig=energies.trig))]


def art_pod_modes(art, x):
    """The POD modes the run trained on (the host SVD of X)."""
    from desmo_tpu_torch import pod

    return pod.pod_host(x, art.config.r, "cpu").modes.numpy()


def channel_cfg(**override):
    return dataclasses.replace(configs.get("channel"), n=300, m=60, num_epochs=20, checkpoint_every=10,
                               **override)


def test_channel_runs_greedy_pruning_like_jax(tmp_path, capsys):
    """The channel preset (``run_greedy_prune``), which the port refused
    before, runs through ``runner.run``: after the sweep, the greedy curve
    of the trained model. At omega and lr_omega 1 the history and the curve
    are held to ``desmo_tpu.runner.run``'s on the same data."""
    cfg = channel_cfg(omega_init=1.0, lr_omega=1.0)
    jcfg = dataclasses.replace(jconfigs.get("channel"), n=300, m=60, num_epochs=20, checkpoint_every=10,
                               omega_init=1.0, lr_omega=1.0)
    x = synthetic.cylinder_wake(300, 60)
    art = runner.run(cfg, x, out_dir=str(tmp_path / "torch"), device="cpu")
    out = capsys.readouterr().out
    ref = jrunner.run(jcfg, x, out_dir=str(tmp_path / "jax"), make_figures=False, echo=False)
    T = desmo.DesmoSpec(300, 60, cfg.r, cfg.poly_order).num_poly_terms
    assert len(art.greedy) == T + 3 * cfg.r + 1 == 28
    assert out.count("Step: ") == 28 and "Step: 27, Error: " in out
    assert "Summary of Results:" in out and out.index("Summary of Results:") < out.index("Step: 0,")
    for key in ("rec", "total"):
        np.testing.assert_allclose(art.history[key], ref.history[key], rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(art.relative_error, ref.relative_error, rtol=1e-4)
    jgreedy = jsparsify.greedy_prune(ref.state.params, {"x": jnp.asarray(x), "pod_modes": jnp.asarray(
        art_pod_modes(art, x))}, jdesmo.DesmoSpec(300, 60, cfg.r, cfg.poly_order, 1.0))
    assert [e.nonzero_terms for e in art.greedy] == [e.nonzero_terms for e in jgreedy]
    np.testing.assert_allclose([e.error for e in art.greedy], [e.error for e in jgreedy], rtol=1e-3)
    assert {"state_final.npz", "channel_r4_final.pt", "state_epoch10.npz"} <= set(os.listdir(art.out_dir))


def test_cli_runs_the_channel_preset(tmp_path, capsys):
    """``python -m desmo_tpu_torch run --preset channel --synthetic`` at the
    preset's full width (n=16384, m=1000) and a few epochs on the CPU: the
    sweep, then the greedy curve's 28 steps, then the summary."""
    rc = cli_main(["run", "--preset", "channel", "--synthetic", "--epochs", "4", "--device", "cpu", "--out-dir",
                   str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["preset"] == "channel" and summary["preempted"] is False
    assert np.isfinite(summary["relative_error"])
    assert out.count("Step: ") == 28 and "Step: 27, Error: 1.000000, Nonzero Terms: 0" in out
    assert "state_final.npz" in os.listdir(os.path.join(str(tmp_path), "channel"))
