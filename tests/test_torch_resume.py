"""Resume, graceful preemption and asynchronous checkpoints in the port
(``checkpoint.load_state``, ``train.fit``, ``ensemble.fit``,
``runner.run(resume_from=...)``, ``run --resume``), after the JAX package's
``tests/test_train.py``, ``tests/test_runner.py`` and
``tests/test_ensemble.py``.

A run stopped at a chunk boundary and resumed from the state it wrote gives
the uninterrupted run's bits through every route of ``train.fit``: the eager
loop and the plain versions of the mega-kernel's and the AE kernel's chunks
(the kernels' own chunks on the card: ``chip_smoke.py``); the sharded chunk
over a gloo mesh is held in ``tests/test_torch_shard_step.py``."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

from desmo_tpu import checkpoint as jckpt  # noqa: E402
from desmo_tpu import configs as jconfigs  # noqa: E402
from desmo_tpu import train as jtrain  # noqa: E402
from desmo_tpu.models import desmo as jdesmo  # noqa: E402
from desmo_tpu_torch import checkpoint, configs, ensemble, runner, train  # noqa: E402
from desmo_tpu_torch.__main__ import main as cli_main  # noqa: E402
from desmo_tpu_torch.io import synthetic  # noqa: E402
from desmo_tpu_torch.kernels import train_chunk  # noqa: E402
from desmo_tpu_torch.models import desmo  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# route: (preset, chunk_method, epochs a chunk); every route at omega and
# lr_omega 1, the scheduler stepped every epoch; the AE variant's MLP funnel
# makes its epochs the dearest, so its chunks are shorter
ROUTES = {
    "eager": ("cylinder", "scan", 20),
    "megakernel": ("cylinder", "megakernel", 20),
    "fourier_megakernel": ("fourier_cylinder", "megakernel", 20),
    "ae_eager": ("ae_cylinder", "scan", 4),
    "ae_kernel": ("ae_cylinder", "megakernel", 4),
}


@pytest.fixture(autouse=True)
def no_request_left():
    """No test leaves a preemption request for the next."""
    train.clear_preemption()
    yield
    train.clear_preemption()


def route(name, **override):
    """``(cfg, loss_fn, groups, params, batch, chunk)`` of a small problem
    (n=64, m=24, r=2, P=2) through ``name``'s chunk on the CPU."""
    preset, method, _ = ROUTES[name]
    base = dict(n=64, m=24, r=2, poly_order=2, omega_init=1.0, lr_omega=1.0, sched_every=1, patience=5,
                chunk_method=method, checkpoint_every=20, log_every=1000)
    if preset == "fourier_cylinder":
        base["n_fourier"] = 3
    cfg = dataclasses.replace(configs.get(preset), **{**base, **override})
    x = synthetic.cylinder_wake(cfg.n, cfg.m)
    spec, params, loss_fn, groups = runner.build_model(cfg, torch.device("cpu"))
    p, _ = runner.compute_pod(cfg, x, torch.device("cpu"))
    batch = runner.prepare_batch(x, None if cfg.variant == "ae" else p.modes, torch.device("cpu"))
    return cfg, loss_fn, groups, params, batch, train_chunk.select_chunk(spec, cfg, torch.device("cpu"))


def assert_same_state(got: train.TrainState, want: train.TrainState):
    for tree in ("params", "mu", "nu"):
        a, b = getattr(got, tree), getattr(want, tree)
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(a[k], b[k]), f"{tree}/{k}"
    for f in ("lrs", "best", "num_bad"):
        assert torch.equal(getattr(got.sched, f), getattr(want.sched, f)), f
    assert (got.count, got.epoch) == (want.count, want.epoch)


def test_load_state_reads_the_jax_package_files(tmp_path):
    """A state written by ``desmo_tpu.checkpoint.save_state`` (after a few
    JAX epochs, so the moments and scheduler are under way) loads into the
    port's ``TrainState`` with the template's dtypes, the same values and
    counters; the port's own file round-trips bit for bit."""
    jcfg = dataclasses.replace(jconfigs.get("cylinder"), n=30, m=12, r=2, poly_order=2, omega_init=1.0,
                               lr_omega=1.0)
    jspec = jdesmo.DesmoSpec(30, 12, 2, 2, 1.0)
    rng = np.random.default_rng(0)
    jbatch = {"x": jnp.asarray(rng.standard_normal((30, 12)), jnp.float32),
              "pod_modes": jnp.asarray(rng.standard_normal((30, 2)), jnp.float32)}
    jbatch["x_sq"] = jnp.sum(jbatch["x"] ** 2)
    jparams = jdesmo.init_params(jspec)
    jres = jtrain.fit(jdesmo.build_loss(jspec, jcfg.beta, jcfg.l1_lambda, method="factored"),
                      jdesmo.param_groups(jparams), jcfg, jparams, jbatch, num_epochs=7, log=None)
    path = str(tmp_path / "jax_state.npz")
    jckpt.save_state(path, jres.state)

    params = desmo.Desmo(desmo.DesmoSpec(30, 12, 2, 2, 1.0)).params()
    cfg = dataclasses.replace(configs.get("cylinder"), n=30, m=12, r=2, poly_order=2)
    got = checkpoint.load_state(path, train.init_state(params, cfg))
    assert (got.count, got.epoch) == (7, 7)
    for k, v in jres.state.params.items():
        np.testing.assert_array_equal(got.params[k].numpy(), np.asarray(v))
        np.testing.assert_array_equal(got.mu[k].numpy(), np.asarray(jres.state.opt.mu[k]))
        np.testing.assert_array_equal(got.nu[k].numpy(), np.asarray(jres.state.opt.nu[k]))
    np.testing.assert_array_equal(got.sched.lrs.numpy(), np.asarray(jres.state.sched.lrs))
    assert got.sched.num_bad.dtype == torch.int32 and got.params["phi"].dtype == torch.float32
    assert int(got.sched.num_bad) == int(jres.state.sched.num_bad)

    mine = str(tmp_path / "port_state.npz")
    checkpoint.save_state(mine, got)
    assert_same_state(checkpoint.load_state(mine, train.init_state(params, cfg)), got)


def test_load_state_refuses_a_file_missing_keys(tmp_path):
    cfg, _, _, params, _, _ = route("eager")
    path = str(tmp_path / "partial.npz")
    np.savez(path, **{"params/phi": params["phi"].detach().numpy(), "epoch": np.int32(3)})
    with pytest.raises(KeyError, match="opt/count"):
        checkpoint.load_state(path, train.init_state(params, cfg))


@pytest.mark.parametrize("name", list(ROUTES))
def test_fit_resume_matches_uninterrupted(tmp_path, name):
    """Three chunks against one, written by the checkpoint worker to a file,
    read back by ``load_state`` and resumed for two: the same state and
    metrics, bit for bit."""
    c = ROUTES[name][2]
    cfg, loss_fn, groups, params, batch, chunk = route(name, checkpoint_every=c)
    full = train.fit(loss_fn, groups, cfg, params, batch, num_epochs=3 * c, chunk_size=c, log=None, chunk=chunk)
    path = str(tmp_path / "state.npz")
    first = train.fit(loss_fn, groups, cfg, params, batch, num_epochs=c, chunk_size=c, log=None, chunk=chunk,
                      checkpoint_fn=lambda st, epoch: checkpoint.save_state(path, st))
    assert not first.preempted
    state = checkpoint.load_state(path, train.init_state(params, cfg))
    assert_same_state(state, first.state)
    rest = train.fit(loss_fn, groups, cfg, None, batch, num_epochs=2 * c, chunk_size=c, log=None, chunk=chunk,
                     state=state)
    assert_same_state(rest.state, full.state)
    assert rest.state.epoch == 3 * c
    for k, v in full.history.items():
        np.testing.assert_array_equal(np.concatenate([first.history[k], rest.history[k]]), v, err_msg=k)


@pytest.mark.parametrize("name", ["eager", "megakernel", "ae_kernel"])
def test_graceful_preemption_checkpoints_and_resumes_bit_exact(tmp_path, name):
    """A request raised while the first chunk's lines are logged stops fit at
    that chunk's boundary with an off-cadence checkpoint (the cadence is
    10,000) and ``preempted``, and clears the request; resumed from the file,
    the remaining two chunks give the uninterrupted run's bits."""
    c = ROUTES[name][2]
    cfg, loss_fn, groups, params, batch, chunk = route(name, checkpoint_every=10_000, log_every=1)
    full = train.fit(loss_fn, groups, cfg, params, batch, num_epochs=3 * c, chunk_size=c, log=None, chunk=chunk)
    saved = []
    path = str(tmp_path / "state.npz")

    def ckpt(st, epoch):
        saved.append((epoch, threading.current_thread().name))
        checkpoint.save_state(path, st)

    stopped = train.fit(loss_fn, groups, cfg, params, batch, num_epochs=3 * c, chunk_size=c, chunk=chunk,
                        checkpoint_fn=ckpt, log=lambda line: train.request_preemption())
    assert stopped.preempted and stopped.state.epoch == c and len(stopped.history["total"]) == c
    assert [epoch for epoch, _ in saved] == [c] and saved[0][1].startswith("ckpt")
    assert not train.preemption_requested()
    rest = train.fit(loss_fn, groups, cfg, None, batch, num_epochs=2 * c, chunk_size=c, log=None, chunk=chunk,
                     state=checkpoint.load_state(path, train.init_state(params, cfg)))
    assert not rest.preempted
    assert_same_state(rest.state, full.state)


def test_a_request_before_fit_stops_it_before_the_first_chunk():
    """A request already raised when fit starts (e.g. during an earlier
    warmup): no chunk runs, the incoming state is checkpointed, and the
    request is cleared."""
    cfg, loss_fn, groups, params, batch, chunk = route("eager")
    calls, saved = [], []
    train.request_preemption()
    res = train.fit(loss_fn, groups, cfg, params, batch, num_epochs=40, log=None,
                    chunk=lambda st, b, n: calls.append(n), checkpoint_fn=lambda st, ep: saved.append((ep, st)))
    assert res.preempted and res.history == {} and calls == [] and res.state.epoch == 0
    assert [ep for ep, _ in saved] == [0] and torch.equal(saved[0][1].params["phi"], params["phi"])
    assert not train.preemption_requested()


def test_checkpoints_are_written_in_order_and_a_failure_surfaces():
    """The worker writes host copies in the order of the boundaries, while
    the loop goes on; a write that fails raises in fit at a later boundary
    or at its end, not silently."""
    cfg, loss_fn, groups, params, batch, chunk = route("eager", checkpoint_every=10)
    seen = []

    def written(st, epoch):
        assert st.params["phi"].device.type == "cpu"
        seen.append((epoch, st.epoch))

    train.fit(loss_fn, groups, cfg, params, batch, num_epochs=40, log=None, checkpoint_fn=written)
    assert seen == [(10, 10), (20, 20), (30, 30), (40, 40)]

    def failing(st, epoch):
        raise OSError(f"disk full at {epoch}")

    with pytest.raises(OSError, match="disk full at 10"):
        train.fit(loss_fn, groups, cfg, params, batch, num_epochs=40, log=None, checkpoint_fn=failing)


def test_host_snapshot_is_a_copy():
    cfg, _, _, params, _, _ = route("eager")
    state = train.init_state(params, cfg)
    snap, event = train.host_snapshot(state)
    assert event is None
    state.params["phi"].add_(1.0)
    assert not torch.equal(snap.params["phi"], state.params["phi"])


def test_sigterm_installs_and_requests_preemption():
    """``install_preemption_handler``: SIGTERM raises the request (and
    chains the handler installed before) instead of ending the process."""
    seen = []
    prev = signal.getsignal(signal.SIGTERM)
    try:
        signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
        train.install_preemption_handler()
        os.kill(os.getpid(), signal.SIGTERM)  # a signal to oneself arrives at once on the main thread
        assert train.preemption_requested() and seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


def runner_cfg(**override):
    return dataclasses.replace(configs.get("cylinder"), r=2, poly_order=2, num_epochs=40, checkpoint_every=20,
                               omega_init=1.0, lr_omega=1.0, chunk_method="megakernel", **override)


def test_runner_resume_matches_uninterrupted(tmp_path):
    """``runner.run`` through the mega-kernel's chunk for 40 epochs, against
    20 and then ``resume_from`` its ``state_epoch20.npz`` for 20 more: the
    same ``state_final.npz`` bit for bit, and the resumed run's metrics file
    takes up at epoch 20."""
    x = synthetic.cylinder_wake(80, 30)
    straight = runner.run(runner_cfg(), x, out_dir=str(tmp_path / "straight"), echo=False, device="cpu")
    runner.run(runner_cfg(), x, out_dir=str(tmp_path / "first"), num_epochs=20, echo=False, device="cpu")
    resumed = runner.run(runner_cfg(), x, out_dir=str(tmp_path / "resumed"), num_epochs=20, echo=False,
                         device="cpu", resume_from=str(tmp_path / "first" / "cylinder" / "state_epoch20.npz"))
    assert not resumed.preempted and resumed.state.epoch == 40 and resumed.sweep
    a = np.load(os.path.join(straight.out_dir, "state_final.npz"))
    b = np.load(os.path.join(resumed.out_dir, "state_final.npz"))
    assert set(a.files) == set(b.files)
    for key in a.files:
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    np.testing.assert_array_equal(resumed.history["total"], straight.history["total"][20:])
    assert resumed.relative_error == straight.relative_error
    with open(os.path.join(resumed.out_dir, "cylinder.csv")) as fh:
        epochs = [int(line.split(",")[0]) for line in fh.read().splitlines()[1:]]
    assert epochs == list(range(20, 40, runner_cfg().log_every))


def test_resume_with_seeds_raises(tmp_path):
    with pytest.raises(ValueError, match="no --resume"):
        runner.run(runner_cfg(n_seeds=2), synthetic.cylinder_wake(40, 20), out_dir=str(tmp_path), device="cpu",
                   resume_from=str(tmp_path / "state_final.npz"))


def test_runner_preempted_mid_run_writes_the_final_state(tmp_path, monkeypatch):
    """A request raised during the first of two chunks: ``runner.run``
    stops at epoch 20, writes ``state_final.npz`` and the final ``.pt``,
    skips the sweep and reports ``preempted``; resumed from that state for
    the 20 epochs left, it ends on the uninterrupted run's bits."""
    x = synthetic.cylinder_wake(80, 30)
    straight = runner.run(runner_cfg(), x, out_dir=str(tmp_path / "straight"), echo=False, device="cpu")
    select = train_chunk.select_chunk

    def raising(spec, cfg, device):
        chunk = select(spec, cfg, device)

        def run_chunk(state, batch, n):
            train.request_preemption()
            return chunk(state, batch, n)

        return run_chunk

    monkeypatch.setattr(train_chunk, "select_chunk", raising)
    art = runner.run(runner_cfg(), x, out_dir=str(tmp_path / "stopped"), echo=False, device="cpu")
    monkeypatch.setattr(train_chunk, "select_chunk", select)
    assert art.preempted and art.state.epoch == 20 and art.sweep == [] and art.greedy == []
    assert {"state_final.npz", "cylinder_r2_final.pt", "state_epoch20.npz"} <= set(os.listdir(art.out_dir))
    resumed = runner.run(runner_cfg(), x, out_dir=str(tmp_path / "resumed"), num_epochs=20, echo=False, device="cpu",
                         resume_from=os.path.join(art.out_dir, "state_final.npz"))
    for k, v in straight.state.params.items():
        assert torch.equal(resumed.state.params[k], v), k


def test_ae_warmup_passes_a_request_on(tmp_path):
    """A request taken by the AE recipe's warmup is raised again, so that
    the main fit saves the warmed state and stops before its first chunk;
    resumed, the run applies the recipe's clamped config again."""
    cfg = dataclasses.replace(configs.get("ae_cylinder"), ae_recipe=True, ae_warmup_epochs=8, num_epochs=4,
                              checkpoint_every=4, log_every=1)
    x = synthetic.cylinder_wake(48, 20)
    fit = train.fit
    calls = []

    def first_fit_raises(*args, **kw):
        calls.append(kw.get("num_epochs"))
        if len(calls) == 1:
            kw["log"] = lambda line: train.request_preemption()
        return fit(*args, **kw)

    try:
        train.fit = first_fit_raises
        art = runner.run(cfg, x, out_dir=str(tmp_path), echo=False, device="cpu")
    finally:
        train.fit = fit
    assert calls == [8, 4] and art.preempted and art.state.epoch == 0
    warmed = np.load(os.path.join(art.out_dir, "state_final.npz"))
    assert int(warmed["epoch"]) == 0 and not np.array_equal(warmed["params/ae_enc_w0"], np.asarray(
        runner.ae_model.init_params_live(runner.ae_model.AESpec(48, 20, 2, 2, cfg.omega_init), seed=cfg.seed)[
            "ae_enc_w0"]))
    resumed = runner.run(cfg, x, out_dir=str(tmp_path / "resumed"), echo=False, device="cpu",
                         resume_from=os.path.join(art.out_dir, "state_final.npz"))
    assert not resumed.preempted and resumed.state.epoch == 4 and resumed.config.ae_beta >= 10.0


def test_ensemble_fit_honors_graceful_preemption():
    """``ensemble.fit`` stops at the chunk boundary (one chunk runs), the
    per-chunk checkpoint having saved the best live seed, skips the later
    groups, and reports ``preempted``; the request is cleared."""
    cfg = dataclasses.replace(configs.get("cylinder"), n=40, m=16, r=2, poly_order=2, checkpoint_every=10,
                              num_epochs=40, omega_init=1.0, lr_omega=1.0)
    spec = desmo.DesmoSpec(40, 16, 2, 2, 1.0)
    x = synthetic.cylinder_wake(40, 16)
    p, _ = runner.compute_pod(cfg, x, torch.device("cpu"))
    batch = runner.prepare_batch(x, p.modes, torch.device("cpu"))
    saved = []
    train.request_preemption()
    result, best, finals = ensemble.fit(cfg, spec, batch, n_seeds=3, num_epochs=40, log=None,
                                        checkpoint_fn=lambda st, ep: saved.append(ep))
    assert result.preempted and result.state.epoch == 10 and saved == [10]
    assert len(finals) == 3 and np.isfinite(finals).all() and not train.preemption_requested()


def small_npz(tmp_path):
    """A snapshot file for the CLI's ``--npz``: 3 components of 200 points
    over 60 snapshots, as the VTK readers interleave them."""
    path = tmp_path / "snapshots.npz"
    np.savez(path, X=np.random.default_rng(0).standard_normal((600, 60)).astype(np.float32))
    return str(path)


def test_cli_resume_continues_a_run(tmp_path, capsys):
    """``run --resume`` continues a CLI run's ``state_final.npz`` for
    ``--epochs`` more; 4 + 4 epochs of the eager loop give the bits of 8,
    and the summary says ``preempted``."""
    argv = ["run", "--preset", "cylinder", "--npz", small_npz(tmp_path), "--device", "cpu"]
    assert cli_main(argv + ["--epochs", "8", "--out-dir", str(tmp_path / "straight")]) == 0
    assert cli_main(argv + ["--epochs", "4", "--out-dir", str(tmp_path / "first")]) == 0
    assert cli_main(argv + ["--epochs", "4", "--out-dir", str(tmp_path / "resumed"), "--resume",
                            str(tmp_path / "first" / "cylinder" / "state_final.npz")]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["preempted"] is False
    a = np.load(tmp_path / "straight" / "cylinder" / "state_final.npz")
    b = np.load(tmp_path / "resumed" / "cylinder" / "state_final.npz")
    for key in a.files:
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    assert int(b["epoch"]) == 8


def test_sigterm_stops_a_cli_run_and_it_resumes(tmp_path):
    """A real SIGTERM to a ``run`` process, sent before training starts
    (the CLI has installed the handler): the run stops before its first
    chunk, writes ``state_final.npz`` and reports ``"preempted": true``;
    ``--resume`` from that file completes the run."""
    script = (
        "import os, signal, sys\n"
        "from desmo_tpu_torch import runner, train\n"
        "from desmo_tpu_torch.__main__ import main\n"
        "run = runner.run\n"
        "def signalled(*a, **kw):\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "    return run(*a, **kw)\n"
        "runner.run = signalled\n"
        "sys.exit(main(sys.argv[1:]))\n"
    )
    argv = ["run", "--preset", "cylinder", "--npz", small_npz(tmp_path), "--device", "cpu", "--epochs", "6"]
    out = subprocess.run([sys.executable, "-c", script, *argv, "--out-dir", str(tmp_path / "a")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["preempted"] is True
    state_file = tmp_path / "a" / "cylinder" / "state_final.npz"
    assert int(np.load(state_file)["epoch"]) == 0
    assert cli_main(argv + ["--out-dir", str(tmp_path / "b"), "--resume", str(state_file)]) == 0
    assert int(np.load(tmp_path / "b" / "cylinder" / "state_final.npz")["epoch"]) == 6
