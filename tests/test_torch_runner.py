"""The port's slice end to end: ``desmo_tpu_torch.runner.run`` against
``desmo_tpu.runner.run``, checkpoints in the reference's key scheme, and what
the port refuses to run."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from desmo_tpu import checkpoint as jckpt  # noqa: E402
from desmo_tpu import configs  # noqa: E402
from desmo_tpu import runner as jrunner  # noqa: E402
from desmo_tpu.io import synthetic  # noqa: E402
from desmo_tpu_torch import checkpoint, device, runner  # noqa: E402


def _slice_cfg(**override):
    return dataclasses.replace(
        configs.get("cylinder"), r=2, poly_order=2, num_epochs=60,
        loss_method="factored", chunk_method="scan", **override,
    )


@pytest.mark.parametrize("omega", ["preset", "unit"])
def test_run_matches_jax_runner(tmp_path, capsys, omega):
    """The preset starts omega at 1e4 with lr_omega 1e3. There the trig
    arguments reach ~1e3 rad, so fp32 rounding of sin/cos is amplified about
    10x per epoch: the JAX package against itself, with X scaled by
    (1 + 2^-22), separates by 5e-2 in the total loss by epoch 6 and ends 60
    epochs 6% apart in relative error, with a different sweep count at one
    threshold. So at the preset the first 4 epochs are held to 2e-4 and the
    end state to 15%; with omega and lr_omega at 1 (``unit``) the whole run,
    the sweep counts included, is held tightly."""
    cfg = _slice_cfg() if omega == "preset" else _slice_cfg(omega_init=1.0, lr_omega=1.0)
    x = synthetic.cylinder_wake(300, 120)
    ref = jrunner.run(cfg, x, out_dir=str(tmp_path / "jax"), make_figures=False, echo=False)
    ours = runner.run(cfg, x, out_dir=str(tmp_path / "torch"), echo=True, device="cpu")
    out = capsys.readouterr().out
    assert "Epoch [1/60], Rec Loss: " in out and "DESMO error with 2 modes: " in out
    assert "Summary of Results:" in out

    np.testing.assert_allclose(ours.pod_error_r, ref.pod_error_r, rtol=1e-5)
    np.testing.assert_allclose(ours.pod_error_2r, ref.pod_error_2r, rtol=1e-5)
    assert [e.threshold for e in ours.sweep] == [e.threshold for e in ref.sweep]
    if omega == "preset":
        for key in ("rec", "ortho", "l1", "total"):
            np.testing.assert_allclose(ours.history[key][:4], ref.history[key][:4], rtol=2e-4, err_msg=key)
        np.testing.assert_allclose(ours.relative_error, ref.relative_error, rtol=0.15)
    else:
        for key in ("rec", "ortho", "l1", "total"):
            np.testing.assert_allclose(ours.history[key], ref.history[key], rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(ours.relative_error, ref.relative_error, rtol=1e-4)
        assert [e.nonzero_terms for e in ours.sweep] == [e.nonzero_terms for e in ref.sweep]
        np.testing.assert_allclose(
            [e.error for e in ours.sweep], [e.error for e in ref.sweep], rtol=1e-4
        )

    pt = jckpt.load_pt(os.path.join(ours.out_dir, "cylinder_r2_final.pt"))
    ref_pt = jckpt.load_pt(os.path.join(ref.out_dir, "cylinder_r2_final.pt"))
    assert sorted(pt) == sorted(ref_pt)
    for k in ref_pt:
        assert pt[k].shape == ref_pt[k].shape, k
    files = set(os.listdir(ours.out_dir))
    assert {"state_final.npz", "cylinder.csv", "cylinder.jsonl"} <= files


def test_fourier_run_matches_jax_runner(tmp_path):
    """fourier_cylinder at a small size through the eager loop with omega
    and lr_omega at 1: the whole trace, the relative error and the sweep
    against ``desmo_tpu.runner.run``, and the export's keys."""
    cfg = dataclasses.replace(
        configs.get("fourier_cylinder"), num_epochs=60, loss_method="factored", chunk_method="scan",
        omega_init=1.0, lr_omega=1.0, period_init=40.0,
    )
    x = synthetic.cylinder_wake(300, 120, period_steps=40.0)
    ref = jrunner.run(cfg, x, out_dir=str(tmp_path / "jax"), make_figures=False, echo=False)
    ours = runner.run(cfg, x, out_dir=str(tmp_path / "torch"), echo=False, device="cpu")
    for key in ("rec", "ortho", "l1", "total"):
        np.testing.assert_allclose(ours.history[key], ref.history[key], rtol=1e-4, atol=1e-8, err_msg=key)
    np.testing.assert_allclose(ours.relative_error, ref.relative_error, rtol=1e-4)
    assert [e.nonzero_terms for e in ours.sweep] == [e.nonzero_terms for e in ref.sweep]
    np.testing.assert_allclose([e.error for e in ours.sweep], [e.error for e in ref.sweep], rtol=1e-4)
    pt = jckpt.load_pt(os.path.join(ours.out_dir, "fourier_cylinder_r2_final.pt"))
    ref_pt = jckpt.load_pt(os.path.join(ref.out_dir, "fourier_cylinder_r2_final.pt"))
    assert sorted(pt) == sorted(ref_pt) and "period_list.0" in pt
    for k in ref_pt:
        assert pt[k].shape == ref_pt[k].shape, k


def test_state_dict_matches_jax_key_scheme(tmp_path):
    rng = np.random.default_rng(0)
    np_params = {
        "phi": rng.standard_normal((3, 20)),
        "c": rng.standard_normal(10),
        "z": rng.standard_normal((10, 8)),
        "z_trig": rng.standard_normal((3, 3, 8)),
        "c_trig": rng.standard_normal((3, 3)),
        "omega": rng.standard_normal((3, 3)),
    }
    np_params = {k: v.astype(np.float32) for k, v in np_params.items()}
    sd = checkpoint.state_dict_from_params(checkpoint.params_from_jax(np_params, "cpu"))
    ref = jckpt.state_dict_from_params(np_params)
    assert list(sd) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(ref[k]))
    back = checkpoint.params_from_state_dict(sd, "cpu")
    for k, v in np_params.items():
        np.testing.assert_array_equal(back[k].numpy(), v)

    path = str(tmp_path / "m.pt")
    checkpoint.save_pt(path, sd)
    via_jax = jckpt.load_pt(path)
    via_torch = torch.load(path, weights_only=True)
    for k in ref:
        np.testing.assert_array_equal(via_jax[k], np.asarray(ref[k]))
        assert torch.equal(via_torch[k], sd[k])


@pytest.mark.parametrize(
    "override, item",
    [
        ({"variant": "desmo"}, "queue 1, item 6"),
        ({"variant": "ae", "poly_order": 2}, "queue 1, item 6"),
    ],
)
def test_unsupported_configs_raise(tmp_path, override, item):
    """The one-seed period multi-start and the device POD run since they
    were ported (``tests/test_torch_forecast.py``,
    ``tests/test_torch_pod.py``); what the port still refuses on a run is
    the desmo and AE variants' holdout forecast, the chained SR leg."""
    cfg = dataclasses.replace(_slice_cfg(), **override)
    x = synthetic.cylinder_wake(40, 20)
    with pytest.raises(NotImplementedError, match=item):
        runner.run(cfg, x, out_dir=str(tmp_path), device="cpu", holdout=0.2)


@pytest.mark.parametrize("n_seeds", [1, 2])
def test_ae_variant_runs_one_seed_and_refuses_several(tmp_path, n_seeds):
    """The AE variant, which the port refused before it had the model, runs
    with one seed; several seeds raise ``ValueError``, as
    ``desmo_tpu/runner.py:510-514`` does."""
    cfg = dataclasses.replace(configs.get("ae_cylinder"), num_epochs=2, checkpoint_every=2, n_seeds=n_seeds)
    x = synthetic.cylinder_wake(40, 20)
    if n_seeds > 1:
        with pytest.raises(ValueError, match="n_seeds > 1"):
            runner.run(cfg, x, out_dir=str(tmp_path), echo=False, device="cpu")
        return
    art = runner.run(cfg, x, out_dir=str(tmp_path), echo=False, device="cpu")
    assert set(art.history) == {"rec", "ortho", "l1", "ae", "total"} and len(art.history["ae"]) == 2


def test_n_seeds_runs_the_packed_ensemble(tmp_path):
    """``n_seeds=2``, which the port refused before it had the ensemble, now
    trains two packed seeds and writes ``ensemble.json`` beside the best
    seed's exports."""
    import json

    cfg = dataclasses.replace(_slice_cfg(), n_seeds=2, num_epochs=4, checkpoint_every=2)
    art = runner.run(cfg, synthetic.cylinder_wake(40, 20), out_dir=str(tmp_path), echo=False, device="cpu")
    with open(os.path.join(art.out_dir, "ensemble.json")) as fh:
        record = json.load(fh)
    assert record["n_seeds"] == 2 and len(record["final_totals"]) == 2 and record["best_seed"] in (0, 1)
    assert art.state.params["phi"].shape == (2, 40) and len(art.history["total"]) == 4
    assert {"state_epoch2.npz", "state_final.npz", "cylinder_r2_final.pt"} <= set(os.listdir(art.out_dir))


def test_holdout_raises(tmp_path):
    """The desmo variant's holdout forecast chains the SR leg, not ported
    yet; a holdout outside (0, 0.5) is refused as ``desmo_tpu`` refuses it.
    The Fourier variant's runs (``tests/test_torch_forecast.py``)."""
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        runner.run(_slice_cfg(), synthetic.cylinder_wake(40, 20), out_dir=str(tmp_path), device="cpu", holdout=0.2)
    with pytest.raises(ValueError, match="holdout must be in"):
        runner.run(_slice_cfg(), synthetic.cylinder_wake(40, 20), out_dir=str(tmp_path), device="cpu", holdout=0.6)


def test_cli_refuses_a_mesh(tmp_path):
    """A mesh of four ranks needs four processes (``torchrun``): one process
    alone refuses it. ``tests/test_torch_shard_step.py`` runs the mesh."""
    from desmo_tpu_torch.__main__ import main

    argv = ["run", "--preset", "cylinder", "--synthetic", "--device", "cpu", "--out-dir", str(tmp_path)]
    with pytest.raises(ValueError, match="space=4"):
        main(argv + ["--mesh", "space=4"])


def test_cuda_without_a_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        device.resolve("cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        runner.run(_slice_cfg(), synthetic.cylinder_wake(40, 20), out_dir=str(tmp_path))
    assert device.resolve("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
