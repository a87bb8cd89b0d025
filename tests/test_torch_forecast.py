"""The Fourier run's extras: the period multi-start
(``runner.fourier_period_multistart``) and the holdout forecast
(``runner.run(holdout=...)``) of the port against ``desmo_tpu`` on the same
numpy inputs, their failure and preemption branches, and the multi-start
over a 2-rank gloo mesh against one rank."""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from desmo_tpu import configs as jconfigs  # noqa: E402
from desmo_tpu import pod as jpod  # noqa: E402
from desmo_tpu import runner as jrunner  # noqa: E402
from desmo_tpu.io import synthetic  # noqa: E402
from desmo_tpu.models import fourier as jfourier  # noqa: E402
from desmo_tpu_torch import configs, parallel, runner, train  # noqa: E402
from desmo_tpu_torch.kernels import train_chunk  # noqa: E402
from desmo_tpu_torch.models import fourier  # noqa: E402

HERE = Path(__file__).resolve().parent
WORKER = HERE / "test_torch_shard_worker.py"
PROBE = re.compile(r"candidate (\S+) -> rec (\S+)")
KEEP = re.compile(r"keeping period (\S+) \(rec (\S+)\)")


def _kept(lines):
    """The kept period (as printed, 4 decimals) and its rec."""
    period, rec = KEEP.search(lines[-1]).groups()
    return period, float(rec)


def _periodic_problem(period_data, period_init, **over):
    """The small Fourier problem of ``tests/test_fourier.py:141``: n=64,
    m=48, two harmonics of a known period (snapshot-index units)."""
    n, m, r = 64, 48, 2
    t = fourier.t_points(m)
    s = np.linspace(0, 2 * np.pi, n)
    x = np.outer(np.sin(s), np.sin(2 * np.pi * 2 * t / period_data)) + 0.5 * np.outer(
        np.cos(s), np.cos(2 * np.pi * 3 * t / period_data))
    x = (x - x.mean(axis=1, keepdims=True)).astype(np.float32)
    modes = np.asarray(jpod.pod(x, r).modes)
    cfg = dataclasses.replace(
        configs.RunConfig(name="t", variant="fourier", n=n, m=m, r=r, poly_order=2, period_init=period_init,
                          lr_omega=1.0, num_epochs=1500, patience=400, sched_every=10, log_every=10_000,
                          checkpoint_every=100_000, omega_init=1.0, n_fourier=4), **over)
    spec = fourier.FourierSpec(n, m, r, 2, 1.0, 4, period_init)
    return spec, cfg, x, modes


def _port_problem(spec, cfg, x, modes):
    xd = torch.as_tensor(x)
    batch = {"x": xd, "x_sq": torch.sum(xd * xd), "pod_modes": torch.as_tensor(np.array(modes))}
    params = fourier.Fourier(spec).params()
    loss_fn = fourier.build_loss(spec, cfg.beta, cfg.l1_lambda, method="factored")
    return params, batch, loss_fn, fourier.param_groups(params)


def _probes(lines):
    return [(float(c), float(r)) for c, r in (PROBE.search(ln).groups() for ln in lines if PROBE.search(ln))]


@pytest.mark.parametrize("route", ["eager", "megakernel"])
def test_multistart_probes_match_jax(route):
    """The same candidates in the same order, each probe's final rec within
    2e-4 of ``desmo_tpu``'s after 20 epochs, and the same pick, through the
    eager loop and through the mega-kernel's chunk (its plain version on
    the CPU)."""
    spec, cfg, x, modes = _periodic_problem(48 / 2.5, 48.0, period_multistart=4, period_probe_epochs=20)
    jspec = jfourier.FourierSpec(**dataclasses.asdict(spec))
    jparams = jfourier.init_params(jspec)
    import jax.numpy as jnp

    ref_lines = []
    ref = jrunner.fourier_period_multistart(
        jconfigs.RunConfig(**dataclasses.asdict(cfg)), jparams, {"x": jnp.asarray(x), "pod_modes": jnp.asarray(modes)},
        jfourier.build_loss(jspec, cfg.beta, cfg.l1_lambda, method="factored"), jfourier.param_groups(jparams),
        log=ref_lines.append)
    params, batch, loss_fn, groups = _port_problem(spec, cfg, x, modes)
    chunk = train_chunk.make_chunk(spec, cfg) if route == "megakernel" else None
    lines = []
    ours = runner.fourier_period_multistart(cfg, params, batch, loss_fn, groups, chunk=chunk, log=lines.append)
    got, want = _probes(lines), _probes(ref_lines)
    cands = jfourier.period_candidates(x, cfg.period_init, n_candidates=4, pod_modes=modes)
    assert [c for c, _ in got] == [c for c, _ in want] == [round(c, 4) for c in cands] and len(got) == 4
    np.testing.assert_allclose([r for _, r in got], [r for _, r in want], rtol=2e-4)
    assert _kept(lines)[0] == _kept(ref_lines)[0]
    np.testing.assert_allclose(_kept(lines)[1], _kept(ref_lines)[1], rtol=2e-4)
    assert ours.epoch == 20 and int(np.asarray(ref.epoch)) == 20
    np.testing.assert_allclose(ours.params["period"].numpy(), np.asarray(ref.params["period"]), rtol=2e-4)


def test_period_multistart_rescues_mismatch():
    """``tests/test_fourier.py:198`` with the port: from a period_init in the
    no-gradient basin (48 against the data's 19.2) the multi-start keeps a
    candidate near 19.2, and the fit resumed from it ends within twice the
    rec of a run started at the matched period."""
    spec, cfg, x, modes = _periodic_problem(48 / 2.5, 48.0, period_multistart=4, period_probe_epochs=200)
    params, batch, loss_fn, groups = _port_problem(spec, cfg, x, modes)
    state = runner.fourier_period_multistart(cfg, params, batch, loss_fn, groups)
    chosen = float(state.params["period"][0])
    assert abs(chosen - 19.2) / 19.2 < 0.07, chosen
    res = train.fit(loss_fn, groups, cfg, params, batch, log=None, chunk_size=500, state=state)
    spec_m, cfg_m, x_m, modes_m = _periodic_problem(48 / 2.5, 48 / 2.5)
    params_m, batch_m, loss_m, groups_m = _port_problem(spec_m, cfg_m, x_m, modes_m)
    oracle = train.fit(loss_m, groups_m, cfg_m, params_m, batch_m, log=None, chunk_size=500)
    assert res.history["rec"][-1] < 2.0 * oracle.history["rec"][-1], (res.history["rec"][-1],
                                                                        oracle.history["rec"][-1])


def _holdout_cfg(**over):
    """``tests/test_runner.py``'s ``tiny_cfg("fourier")`` at the data's
    period of 16 snapshots, 20 epochs in chunks of 10."""
    cfg = configs.RunConfig(
        name="tiny_fourier", variant="fourier", n=60, m=40, r=2, poly_order=2, omega_init=1.0, lr_omega=1.0,
        n_fourier=3, period_init=16.0, num_epochs=20, patience=100, sched_every=10, log_every=100,
        checkpoint_every=10,
    )
    return dataclasses.replace(cfg, **over)


def test_run_holdout_matches_jax(tmp_path):
    """``runner.run(holdout=0.25)`` with a 3-candidate multi-start of 10
    epochs, then 20 epochs, against ``desmo_tpu.runner.run`` on the same
    data: the same pick, the trace, the errors and the forecast record
    within 2e-4 (the per-snapshot vectors within 2e-4 of their largest)."""
    cfg = _holdout_cfg(period_multistart=3, period_probe_epochs=10)
    x = synthetic.cylinder_wake(60, 48, n_harmonics=2, seed=0, period_steps=16.0)
    ref = jrunner.run(jconfigs.RunConfig(**dataclasses.asdict(cfg)), x, out_dir=str(tmp_path / "jax"),
                      make_figures=False, echo=False, holdout=0.25)
    ours = runner.run(cfg, x, out_dir=str(tmp_path / "torch"), echo=False, device="cpu", holdout=0.25)
    assert ours.state.epoch == int(np.asarray(ref.state.epoch)) == 30
    for key in train.METRICS:
        np.testing.assert_allclose(ours.history[key], ref.history[key], rtol=2e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(ours.relative_error, ref.relative_error, rtol=2e-4)
    np.testing.assert_allclose(ours.pod_error_r, ref.pod_error_r, rtol=1e-5)
    got, want = ours.forecast, ref.forecast
    assert set(got) == set(want) and got["m_train"] == want["m_train"] == 36 and got["m_holdout"] == 12
    for key in ("train_error", "holdout_error", "baseline_zero_error", "baseline_last_error"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, err_msg=key)
    for key in ("per_snapshot_train_error", "per_snapshot_holdout_error"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-4 * max(want[key]), err_msg=key)
    with open(os.path.join(ours.out_dir, "forecast.json")) as fh:
        assert json.load(fh) == got
    assert got["train_error"] == ours.relative_error


def test_run_fourier_holdout_forecast(tmp_path):
    """The quality bar of ``tests/test_runner.py:705-758`` at the port's own
    full length: 8,000 epochs (the mega-kernel's chunk, its plain version
    on the CPU) on the first 75% of a periodic series, the
    held-out error under a tenth of both baselines; ``forecast.json`` holds
    the record; ``evaluate(forecast_after=36)`` of the final checkpoint
    reproduces the held-out error within 1e-5; a holdout outside (0, 0.5)
    raises, and the desmo variant's holdout (the chained SR leg) is not
    ported yet."""
    m = 48
    x = synthetic.cylinder_wake(60, m, n_harmonics=2, seed=0, period_steps=16.0)
    cfg = _holdout_cfg(num_epochs=8000, checkpoint_every=300, chunk_method="megakernel")
    art = runner.run(cfg, x, out_dir=str(tmp_path), echo=False, device="cpu", holdout=0.25)
    f = art.forecast
    assert f["m_train"] == 36 and f["m_holdout"] == 12 and np.isfinite(f["holdout_error"])
    assert f["baseline_zero_error"] == pytest.approx(1.0, abs=1e-6)
    assert f["holdout_error"] < 0.1 * f["baseline_zero_error"], f
    assert f["holdout_error"] < 0.1 * f["baseline_last_error"], f
    assert f["train_error"] == art.relative_error
    assert len(f["per_snapshot_train_error"]) == 36 and len(f["per_snapshot_holdout_error"]) == 12
    with open(os.path.join(art.out_dir, "forecast.json")) as fh:
        assert json.load(fh) == f
    rep = runner.evaluate(cfg, x, os.path.join(art.out_dir, "tiny_fourier_r2_final.pt"), echo=False, device="cpu",
                          forecast_after=36)
    assert np.isclose(rep["forecast"]["holdout_error"], f["holdout_error"], rtol=1e-5)
    assert rep["forecast"]["m_train"] == 36
    with pytest.raises(ValueError, match="holdout"):
        runner.run(cfg, x, out_dir=str(tmp_path / "e"), echo=False, device="cpu", holdout=0.9)
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        runner.run(dataclasses.replace(configs.get("cylinder"), r=2, poly_order=2), x, out_dir=str(tmp_path / "d"),
                   echo=False, device="cpu", holdout=0.25)


def test_failed_forecast_still_writes_the_final_artifacts(tmp_path, monkeypatch):
    """A forecast that raises leaves a record with its error in
    ``forecast.json``; the sweep, the final ``.pt`` and ``state_final.npz``
    are still written (``desmo_tpu/runner.py:760-769``)."""
    def broken(*args, **kw):
        raise RuntimeError("integration failed")

    monkeypatch.setattr(runner, "_fourier_forecast_record", broken)
    x = synthetic.cylinder_wake(60, 48, n_harmonics=2, seed=0, period_steps=16.0)
    art = runner.run(_holdout_cfg(), x, out_dir=str(tmp_path), echo=False, device="cpu", holdout=0.25)
    assert art.forecast["error"] == "RuntimeError: integration failed"
    assert art.forecast["m_train"] == 36 and art.forecast["train_error"] == art.relative_error
    files = set(os.listdir(art.out_dir))
    assert {"tiny_fourier_r2_final.pt", "state_final.npz", "forecast.json"} <= files and art.sweep
    with open(os.path.join(art.out_dir, "forecast.json")) as fh:
        assert json.load(fh) == art.forecast


def _requesting_select(monkeypatch, on_calls):
    """``train_chunk.select_chunk`` whose chunk raises a preemption request
    after its ``on_calls``-th call; returns the list of calls' epochs."""
    select = train_chunk.select_chunk
    calls = []

    def selecting(spec, cfg, device):
        chunk = select(spec, cfg, device)

        def run_chunk(state, batch, num_steps):
            calls.append(num_steps)
            out = chunk(state, batch, num_steps)
            if len(calls) in on_calls:
                train.request_preemption()
            return out

        return run_chunk

    monkeypatch.setattr(train_chunk, "select_chunk", selecting)
    return calls


def test_preempted_run_skips_the_forecast(tmp_path, monkeypatch):
    """A run stopped by a preemption request writes ``state_final.npz`` and
    the final ``.pt`` and skips the holdout scoring: no record, no
    ``forecast.json`` (``desmo_tpu/runner.py:723-743``)."""
    calls = _requesting_select(monkeypatch, {1})
    x = synthetic.cylinder_wake(60, 48, n_harmonics=2, seed=0, period_steps=16.0)
    art = runner.run(_holdout_cfg(chunk_method="megakernel"), x, out_dir=str(tmp_path), echo=False, device="cpu",
                     holdout=0.25)
    assert calls == [10] and art.preempted and art.state.epoch == 10 and art.forecast is None and art.sweep == []
    files = set(os.listdir(art.out_dir))
    assert {"tiny_fourier_r2_final.pt", "state_final.npz"} <= files and "forecast.json" not in files
    assert not train.preemption_requested()


def test_preemption_during_a_probe_stops_the_multistart(tmp_path, monkeypatch):
    """A request raised during the first probe (one chunk: its last) stops
    the probe loop and is raised again, so that the main fit checkpoints the
    kept probe's state before its first chunk; resumed from that state the
    run ends as a run whose multi-start was not interrupted would continue
    from the same probe."""
    calls = _requesting_select(monkeypatch, {1})
    x = synthetic.cylinder_wake(60, 48, n_harmonics=2, seed=0, period_steps=16.0)
    cfg = _holdout_cfg(chunk_method="megakernel", period_multistart=3, period_probe_epochs=10)
    art = runner.run(cfg, x, out_dir=str(tmp_path), echo=False, device="cpu", holdout=0.25)
    assert calls == [10] and art.preempted and art.state.epoch == 10 and art.forecast is None
    assert not train.preemption_requested()
    saved = np.load(os.path.join(art.out_dir, "state_final.npz"))
    assert int(saved["epoch"]) == 10
    cands = fourier.period_candidates(runner.split_holdout(x, 36)[0], cfg.period_init, n_candidates=3,
                                      pod_modes=runner.compute_pod(dataclasses.replace(cfg, m=36), runner.split_holdout(
                                          x, 36)[0], torch.device("cpu"))[0].modes.numpy())
    assert len(cands) > 1  # the later candidates were skipped
    monkeypatch.undo()
    resumed = runner.run(cfg, x, out_dir=str(tmp_path / "r"), echo=False, device="cpu", holdout=0.25,
                         resume_from=os.path.join(art.out_dir, "state_final.npz"))
    assert not resumed.preempted and resumed.state.epoch == 30 and resumed.forecast is not None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multistart_over_a_two_rank_mesh_equals_one_rank(tmp_path):
    """``runner.run`` with the multi-start and a holdout over a 2-rank gloo
    mesh (the worker's ``multistart`` task: probes and fit through the
    sharded chunk, n=201 uneven) against one rank: the same candidates and
    pick, each probe's rec within 5e-4, the trace within 5e-4 (ortho 1e-5
    absolute), the held-out error within 1e-3; one rank equals the
    mega-kernel's plain chunk run without a mesh to rounding. Rank 0 alone
    writes ``forecast.json``."""
    cfg = dataclasses.replace(
        configs.get("fourier_cylinder"), omega_init=1.0, lr_omega=1.0, num_epochs=20, checkpoint_every=10,
        period_multistart=3, period_probe_epochs=10, period_init=40.0)
    x = synthetic.cylinder_wake(201, 60, period_steps=20.0)
    src = tmp_path / "in.npz"
    np.savez(src, **{"multistart/cfg": np.array(json.dumps(dataclasses.asdict(cfg))), "multistart/x": x,
                     "multistart/holdout": np.array(0.2)})
    out = tmp_path / "d2"
    out.mkdir()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([str(HERE.parent), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(src), str(out), "multistart"],
                              env=dict(env, RANK=str(k), LOCAL_RANK=str(k)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for k in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [dict(np.load(out / f"rank{k}.npz")) for k in range(2)]

    def traced(run_cfg, **kw):
        lines = []
        probe = runner.fourier_period_multistart

        def logged(*args, **kws):
            return probe(*args, **{**kws, "log": lines.append})

        runner.fourier_period_multistart = logged
        try:
            art = runner.run(run_cfg, x, echo=False, device="cpu", holdout=0.2, **kw)
        finally:
            runner.fourier_period_multistart = probe
        return art, lines

    one, one_lines = traced(cfg, out_dir=str(tmp_path / "d1"), device_mesh=parallel.make_mesh(1, device="cpu"))
    plain, plain_lines = traced(dataclasses.replace(cfg, chunk_method="megakernel"), out_dir=str(tmp_path / "k"))
    assert one.state.epoch == 30 and len(_probes(one_lines)) == 3
    for rank in ranks:
        got = _probes(list(rank["multistart/log"]))
        assert [c for c, _ in got] == [c for c, _ in _probes(one_lines)]
        np.testing.assert_allclose([r for _, r in got], [r for _, r in _probes(one_lines)], rtol=5e-4)
        assert _kept([str(rank["multistart/log"][-1])])[0] == _kept(one_lines)[0]
        for key in train.METRICS:
            np.testing.assert_allclose(rank[f"multistart/history/{key}"], one.history[key], rtol=5e-4,
                                       atol=1e-5 if key == "ortho" else 1e-7, err_msg=key)
        assert rank["multistart/params/phi"].shape == (2, 201) and int(rank["multistart/epoch"]) == 30
    np.testing.assert_allclose(float(ranks[0]["multistart/holdout_error"]), one.forecast["holdout_error"], rtol=1e-3)
    assert np.isnan(ranks[1]["multistart/holdout_error"])
    assert "forecast.json" in os.listdir(out / "runs_multistart" / cfg.name)
    # one rank against the plain chunk without a mesh
    assert [c for c, _ in _probes(plain_lines)] == [c for c, _ in _probes(one_lines)]
    for key in train.METRICS:
        np.testing.assert_allclose(one.history[key], plain.history[key], rtol=1e-5, atol=1e-8, err_msg=key)
