"""Checkpoint inference: ``.pt`` files across both packages,
``checkpoint.infer_spec_dims`` and ``runner.evaluate`` of the port against
``desmo_tpu`` on the same numpy inputs, and the CLI's ``evaluate`` and
``inspect-pt``."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from desmo_tpu import checkpoint as jckpt  # noqa: E402
from desmo_tpu import configs as jconfigs  # noqa: E402
from desmo_tpu import runner as jrunner  # noqa: E402
from desmo_tpu.io import synthetic  # noqa: E402
from desmo_tpu.models import autoencoder as jae  # noqa: E402
from desmo_tpu.models import desmo as jdesmo  # noqa: E402
from desmo_tpu.models import fourier as jfourier  # noqa: E402
from desmo_tpu_torch import checkpoint, configs, runner  # noqa: E402
from desmo_tpu_torch.__main__ import main  # noqa: E402


def _random_params(spec, fourier=False, seed=0):
    """Reference-shaped parameters with coefficients spread over six decades,
    so that the threshold sweep drops terms at several thresholds."""
    rng = np.random.default_rng(seed)
    init = (jfourier if fourier else jdesmo).init_params(spec)
    params = {}
    for k, v in init.items():
        shape = np.shape(v)
        if k in ("period", "trig_period"):
            params[k] = rng.uniform(20.0, 40.0, shape)
        elif k == "omega":
            params[k] = rng.uniform(0.5, 2.0, shape)
        elif k in ("c", "c_trig"):
            params[k] = rng.standard_normal(shape) * 10.0 ** rng.uniform(-4.0, 1.0, shape)
        else:
            params[k] = 0.3 * rng.standard_normal(shape)
    return {k: np.asarray(v, np.float32) for k, v in params.items()}


def _cfg(variant, **over):
    preset = {"desmo": "cylinder", "fourier": "fourier_cylinder", "ae": "ae_cylinder"}[variant]
    return dataclasses.replace(configs.get(preset), **over)


def _jcfg(cfg):
    return jconfigs.RunConfig(**dataclasses.asdict(cfg))


def test_pt_files_cross_both_packages(tmp_path):
    """A ``.pt`` written by either package reads back through the other's
    ``load_pt`` with equal arrays; anything but a dict is refused."""
    spec = jfourier.FourierSpec(40, 20, 2, 2, 1.0, 3, 25.0)
    sd = jckpt.state_dict_from_params(_random_params(spec, fourier=True), "fourier")
    path = str(tmp_path / "jax.pt")
    jckpt.save_pt(path, sd)
    ours = checkpoint.load_pt(path)
    assert sorted(ours) == sorted(sd)
    for k in sd:
        assert isinstance(ours[k], torch.Tensor) and ours[k].device.type == "cpu"
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(sd[k]), err_msg=k)

    port_sd = checkpoint.state_dict_from_params(checkpoint.params_from_state_dict(sd, "cpu", "fourier"), "fourier")
    path2 = str(tmp_path / "torch.pt")
    checkpoint.save_pt(path2, port_sd)
    back = jckpt.load_pt(path2)
    assert sorted(back) == sorted(port_sd)
    for k in port_sd:
        np.testing.assert_array_equal(np.asarray(back[k]), port_sd[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(np.asarray(back[k]).reshape(-1), np.asarray(sd[k]).reshape(-1), err_msg=k)

    torch.save([torch.ones(2)], str(tmp_path / "list.pt"))
    with pytest.raises(ValueError, match="dict"):
        checkpoint.load_pt(str(tmp_path / "list.pt"))


@pytest.mark.parametrize("r, P", [(2, 2), (2, 3), (4, 2), (4, 3)])
def test_infer_spec_dims_matches_jax(r, P):
    spec = jdesmo.DesmoSpec(30, 12, r, P, 1.0)
    sd = jckpt.state_dict_from_params(_random_params(spec), "desmo")
    assert checkpoint.infer_spec_dims(sd) == jckpt.infer_spec_dims(sd) == (r, P)
    ours = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    assert checkpoint.infer_spec_dims(ours) == (r, P)


def test_infer_spec_dims_of_an_ae_dict():
    from desmo_tpu_torch.models import autoencoder

    spec = jae.AESpec(n=30, m=12, r=2, poly_order=3)
    sd = jae.state_dict_from_params(jae.init_params(spec))
    assert autoencoder.infer_spec_dims(sd) == jae.infer_spec_dims(sd) == (2, 3)
    with pytest.raises(ValueError, match="AE checkpoint"):
        checkpoint.infer_spec_dims(sd)


def _evaluate_both(cfg, x, pt, **kw):
    ref = jrunner.evaluate(_jcfg(cfg), x, pt, echo=False, **kw)
    ours = runner.evaluate(cfg, x, pt, echo=False, device="cpu", **kw)
    return ours, ref


def _assert_same_report(ours, ref):
    for key in ("relative_error", "pod_error_r", "pod_error_2r"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5, err_msg=key)
    assert [e[0] for e in ours["sweep"]] == [e[0] for e in ref["sweep"]]
    assert [e[2] for e in ours["sweep"]] == [e[2] for e in ref["sweep"]]
    np.testing.assert_allclose([e[1] for e in ours["sweep"]], [e[1] for e in ref["sweep"]], rtol=1e-5)


@pytest.mark.parametrize("variant", ["desmo", "fourier", "ae"])
def test_evaluate_matches_jax_at_non_preset_dims(tmp_path, capsys, variant):
    """A checkpoint whose dims differ from the preset's (desmo r=2, P=2
    under cylinder's r=4, P=3; Fourier nF=3 under nF=10, P=3 under P=2; AE
    P=3 under P=2) is sized from the checkpoint, and its report equals
    ``desmo_tpu.runner.evaluate``'s (``tests/test_checkpoint.py:151``,
    ``tests/test_runner.py:947``)."""
    n, m = 200, 60
    if variant == "ae":
        spec = jae.AESpec(n=n, m=m, r=2, poly_order=3)
        sd = jae.state_dict_from_params(jae.init_params(spec))
    elif variant == "fourier":
        spec = jfourier.FourierSpec(n, m, 2, 3, 1.0, 3, 30.0)
        sd = jckpt.state_dict_from_params(_random_params(spec, fourier=True), "fourier")
    else:
        spec = jdesmo.DesmoSpec(n, m, 2, 2, 1.0)
        sd = jckpt.state_dict_from_params(_random_params(spec), "desmo")
    pt = str(tmp_path / "ckpt.pt")
    jckpt.save_pt(pt, sd)
    x = synthetic.cylinder_wake(n, m, seed=1)
    ours, ref = _evaluate_both(_cfg(variant), x, pt)
    _assert_same_report(ours, ref)
    assert np.isfinite(ours["relative_error"]) and set(ours) == set(ref)
    ours = runner.evaluate(_cfg(variant), x, pt, echo=True, device="cpu")
    out = capsys.readouterr().out
    assert "DESMO error with 2 modes:" in out and "Summary of Results:" in out
    if variant != "ae":
        assert "using checkpoint dims" in out


def test_evaluate_fourier_forecast_after_matches_jax(tmp_path):
    """``forecast_after`` on a Fourier checkpoint: the split, the recentring
    and the held-out times as ``desmo_tpu``'s; the scalars within 1e-5
    relative, the per-snapshot vectors within 1e-5."""
    n, m, m_train = 200, 60, 45
    spec = jfourier.FourierSpec(n, m_train, 2, 2, 1.0, 4, 30.0)
    pt = str(tmp_path / "f.pt")
    jckpt.save_pt(pt, jckpt.state_dict_from_params(_random_params(spec, fourier=True, seed=3), "fourier"))
    x = synthetic.cylinder_wake(n, m, seed=2, period_steps=30.0)
    ours, ref = _evaluate_both(_cfg("fourier"), x, pt, forecast_after=m_train)
    _assert_same_report(ours, ref)
    got, want = ours["forecast"], ref["forecast"]
    assert set(got) == set(want)
    assert got["m_train"] == want["m_train"] == m_train and got["m_holdout"] == want["m_holdout"] == m - m_train
    for key in ("train_error", "holdout_error", "baseline_zero_error", "baseline_last_error"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    assert got["baseline_zero_error"] == 1.0
    for key in ("per_snapshot_train_error", "per_snapshot_holdout_error"):
        assert all(isinstance(v, float) for v in got[key])
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("kw, item", [
    (dict(device_mesh=object()), "item 5"),
    (dict(figures_dir="figs"), "item 6"),
    (dict(forecast_after=30), "item 6"),
])
def test_evaluate_refuses_what_is_not_ported(tmp_path, kw, item):
    """A mesh (queue 1 item 5), figures and a desmo checkpoint's forecast
    (the chained SR leg, item 6) raise ``NotImplementedError``."""
    spec = jdesmo.DesmoSpec(40, 40, 2, 2, 1.0)
    pt = str(tmp_path / "d.pt")
    jckpt.save_pt(pt, jckpt.state_dict_from_params(_random_params(spec), "desmo"))
    with pytest.raises(NotImplementedError, match=f"queue 1, {item}"):
        runner.evaluate(_cfg("desmo"), synthetic.cylinder_wake(40, 40), pt, echo=False, device="cpu", **kw)


def test_cli_evaluate_and_inspect_pt(tmp_path, capsys):
    """``evaluate`` prints the report as one JSON line (the sweep left out),
    with the forecast's scalars; ``inspect-pt`` lists each array as
    ``desmo_tpu``'s does."""
    n, m = 3961, 1001
    spec = jfourier.FourierSpec(n, 801, 2, 2, 1.0, 10, 100.0)
    pt = str(tmp_path / "f.pt")
    jckpt.save_pt(pt, jckpt.state_dict_from_params(_random_params(spec, fourier=True), "fourier"))
    assert main(["evaluate", "--preset", "fourier_cylinder", "--synthetic", "--checkpoint", pt,
                 "--forecast-after", "801", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"relative_error", "pod_error_r", "pod_error_2r", "forecast"}
    assert summary["forecast"]["m_train"] == 801 and summary["forecast"]["m_holdout"] == m - 801
    assert not any(k.startswith("per_snapshot") for k in summary["forecast"])

    assert main(["inspect-pt", pt, "--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    from desmo_tpu.__main__ import main as jmain

    jmain(["inspect-pt", pt])
    assert ours == capsys.readouterr().out
    assert "period_list.0" in ours and "(21,)" in ours
    with pytest.raises(NotImplementedError, match="item 5"):
        main(["evaluate", "--preset", "fourier_cylinder", "--synthetic", "--checkpoint", pt, "--mesh", "space=1",
              "--device", "cpu"])
