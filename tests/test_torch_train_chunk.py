"""The port's mega-kernel module (``desmo_tpu_torch.kernels.train_chunk``).

- Its plain chunk against ``desmo_tpu``'s mega-kernel
  (``make_fused_train_chunk`` in interpret mode, as
  ``tests/test_train_chunk_kernel.py`` runs it) at that suite's sizes and
  tolerances, both packages starting from the same state
  (``checkpoint.state_from_jax``).
- Its plain chunk against the port's own eager loop (autograd).
- The chunk policy and ``runner.run`` through the chunk on the CPU.
- The CUDA source (``csrc/train_chunk.cu``), compiled by the host compiler and
  run on an emulated cooperative grid, against the plain chunk.

The CUDA kernel itself is held against the plain chunk on the card by
``tests/test_torch_gpu.py``.
"""

import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from desmo_tpu import configs as jconfigs  # noqa: E402
from desmo_tpu import pod as jpod  # noqa: E402
from desmo_tpu import train as jtrain  # noqa: E402
from desmo_tpu.io import synthetic as jsynthetic  # noqa: E402
from desmo_tpu.models import desmo as jdesmo  # noqa: E402
from desmo_tpu.models import fourier as jfourier  # noqa: E402
from desmo_tpu.pallas import train_chunk as jtc  # noqa: E402
from desmo_tpu_torch import checkpoint, configs, runner, train  # noqa: E402
from desmo_tpu_torch.io import synthetic  # noqa: E402
from desmo_tpu_torch.kernels import _build, train_chunk  # noqa: E402
from desmo_tpu_torch.models import desmo, fourier  # noqa: E402


def problem(n=96, m=40, r=2, P=2, patience=300, sched_every=1, omega_init=1.0):
    """``tests/test_train_chunk_kernel.py::problem``: the same configuration,
    data and POD modes."""
    cfg = configs.RunConfig(
        name="mk", variant="desmo", n=n, m=m, r=r, poly_order=P, omega_init=omega_init,
        lr_omega=1.0, num_epochs=40, patience=patience, sched_every=sched_every,
        log_every=100, checkpoint_every=1000,
    )
    x = jsynthetic.separable_rank_k(n, m, k=r, seed=0)
    x -= x.mean(axis=1, keepdims=True)
    return cfg, x, np.array(jpod.pod(x, r).modes, np.float32)


def jax_start(cfg):
    """The JAX package's spec and fresh state for ``cfg`` (desmo or Fourier)."""
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    if cfg.variant == "fourier":
        spec = jfourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier,
                                    cfg.period_init)
        params = jfourier.init_params(spec)
    else:
        spec = jdesmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
        params = jdesmo.init_params(spec)
    return jcfg, spec, jtrain.init_state(params, jcfg)


def run_jax(cfg, x, modes, steps):
    """``steps`` epochs of ``desmo_tpu``'s mega-kernel (interpret mode)."""
    jcfg, spec, state = jax_start(cfg)
    fused = jtc.make_fused_train_chunk(spec, jcfg, bt=32, interpret=True)
    state, mets = fused(jax.tree.map(jnp.array, state), jtc.prepare_batch(x, modes, bt=32), num_steps=steps)
    return jax.tree.map(np.asarray, state), {k: np.asarray(v) for k, v in mets.items()}


def port_start(cfg, x, modes):
    """The port's spec, batch and the JAX package's fresh state, carried over."""
    _, _, jstate = jax_start(cfg)
    if cfg.variant == "fourier":
        spec = fourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier,
                                   cfg.period_init)
    else:
        spec = desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
    xt = torch.as_tensor(x)
    batch = {"x": xt, "x_sq": torch.sum(xt * xt), "pod_modes": torch.as_tensor(modes)}
    return spec, batch, checkpoint.state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")


def run_plain(cfg, x, modes, chunks):
    spec, batch, state = port_start(cfg, x, modes)
    mets = []
    for steps in chunks:
        state, m = train_chunk.train_chunk_plain(state, batch, steps, spec, cfg)
        mets.append({k: v.numpy() for k, v in m.items()})
    return state, {k: np.concatenate([m[k] for m in mets]) for k in mets[0]}


def assert_state_close(ours, ref, mu_rtol=5e-3):
    """The JAX suite's final-state bounds (``test_train_chunk_kernel.py:78``,
    ``:86``): params rtol 5e-4, first moments 5e-3 (their relative size
    amplifies the fp32 differences of the gradients), LRs 1e-6."""
    for key, ref_v in ref.params.items():
        np.testing.assert_allclose(ours.params[key].numpy(), ref_v, rtol=5e-4, atol=1e-5, err_msg=key)
    for key, ref_v in ref.opt.mu.items():
        np.testing.assert_allclose(ours.mu[key].numpy(), ref_v, rtol=mu_rtol, atol=1e-5, err_msg=f"mu.{key}")
    assert ours.count == int(ref.opt.count) and ours.epoch == int(ref.epoch)
    np.testing.assert_allclose(ours.sched.lrs.numpy(), ref.sched.lrs, rtol=1e-6)


@pytest.mark.parametrize(
    "size, steps, ortho_atol",
    # the JAX suite's problem, and its cylinder regime r=4, P=3 (T=35, K=47).
    # There ortho starts at the fp32 rounding of an orthonormal Gram (4e-6),
    # and the sign that rounding takes steers phi's ortho gradient, so ortho
    # is held to 1e-5 absolute (measured: 3.7e-6).
    [(dict(), 30, 1e-6), (dict(n=64, m=24, r=4, P=3), 12, 1e-5)],
    ids=["n96_r2_p2", "n64_r4_p3"],
)
def test_plain_chunk_matches_jax_mega_kernel(size, steps, ortho_atol):
    cfg, x, modes = problem(**size)
    ref_state, ref_m = run_jax(cfg, x, modes, steps)
    state, mets = run_plain(cfg, x, modes, [steps])
    # the JAX suite's trace bound (test_train_chunk_kernel.py:64); the TPU
    # kernel's products are 3-pass bf16 and its sin/cos a polynomial, the
    # port's plain fp32
    for key in ("rec", "ortho", "l1", "total", "max_arg"):
        atol = ortho_atol if key == "ortho" else 1e-6
        np.testing.assert_allclose(mets[key], ref_m[key], rtol=2e-4, atol=atol, err_msg=key)
    assert_state_close(state, ref_state)


def test_plateau_lr_drops_match_jax_mega_kernel():
    """Tiny patience: the scheduler drops the LRs inside the chunk on the same
    epochs as the JAX kernel (``test_plateau_lr_drops_match``)."""
    cfg, x, modes = problem(patience=3, sched_every=2)
    ref_state, ref_m = run_jax(cfg, x, modes, 40)
    state, mets = run_plain(cfg, x, modes, [40])
    assert float(state.sched.lrs[0]) < cfg.lr_coef  # a drop happened
    np.testing.assert_allclose(state.sched.lrs.numpy(), ref_state.sched.lrs, rtol=1e-6)
    assert int(state.sched.num_bad) == int(ref_state.sched.num_bad)
    np.testing.assert_allclose(mets["total"], ref_m["total"], rtol=5e-4, atol=1e-6)


def test_resume_mid_chunk():
    """chunk(10) then chunk(10) equals chunk(20): the state round-trips
    through the kernel layout (``test_resume_from_mid_chunk_state``). The
    bias b1^count restarts from a fresh power at each chunk, as the JAX
    kernel's does, so the split run agrees to fp32 rounding, not bit for
    bit."""
    cfg, x, modes = problem()
    ref_state, _ = run_jax(cfg, x, modes, 20)
    split, split_m = run_plain(cfg, x, modes, [10, 10])
    whole, whole_m = run_plain(cfg, x, modes, [20])
    assert split.epoch == whole.epoch == 20 and split.count == 20
    np.testing.assert_allclose(split_m["total"], whole_m["total"], rtol=1e-5)
    for key in whole.params:
        np.testing.assert_allclose(split.params[key].numpy(), whole.params[key].numpy(), rtol=1e-5, atol=1e-7)
    assert_state_close(split, ref_state)


def test_plain_chunk_matches_eager_fit():
    """``train.fit`` through the plain chunk against the eager autograd loop,
    40 epochs in chunks of 16, both starting from the same params. Same
    arithmetic up to the order of fp32 sums: held to 1e-4 end to end."""
    cfg, x, modes = problem(patience=5, sched_every=3)
    spec, batch, _ = port_start(cfg, x, modes)
    params = desmo.Desmo(spec).params()
    loss_fn = desmo.build_loss(spec, cfg.beta, cfg.l1_lambda, method="factored")
    groups = desmo.param_groups(params)
    eager = train.fit(loss_fn, groups, cfg, params, batch, chunk_size=16, log=None)
    fused = train.fit(
        loss_fn, groups, cfg, params, batch, chunk_size=16, log=None,
        chunk=train_chunk.make_chunk(spec, cfg),
    )
    assert set(fused.history) == set(eager.history) == set(train.METRICS)
    for key in train.METRICS:
        np.testing.assert_allclose(fused.history[key], eager.history[key], rtol=1e-4, atol=1e-7, err_msg=key)
    for key in params:
        np.testing.assert_allclose(
            fused.state.params[key].numpy(), eager.state.params[key].numpy(), rtol=1e-4, atol=1e-6, err_msg=key
        )
    np.testing.assert_array_equal(fused.state.sched.lrs.numpy(), eager.state.sched.lrs.numpy())
    assert fused.state.epoch == eager.state.epoch == 40
    assert 0.0 < fused.max_abs_trig_arg and eager.max_abs_trig_arg == 0.0


def test_fit_resumes_from_a_state():
    cfg, x, modes = problem()
    spec, batch, state = port_start(cfg, x, modes)
    chunk = train_chunk.make_chunk(spec, cfg)
    first = train.fit(None, {}, cfg, None, batch, num_epochs=12, log=None, state=state, chunk=chunk)
    lines = []
    second = train.fit(None, {}, cfg, None, batch, num_epochs=8, log=lines.append, state=first.state, chunk=chunk)
    whole = train.fit(None, {}, cfg, None, batch, num_epochs=20, log=None, state=state, chunk=chunk)
    assert second.state.epoch == 20 and len(second.history["total"]) == 8
    assert len(lines) == 1 and lines[0].startswith("Epoch [20/20]")  # log_every=100: the last epoch
    np.testing.assert_allclose(
        np.concatenate([first.history["total"], second.history["total"]]), whole.history["total"], rtol=1e-5
    )


def fourier_problem(n=96, m=40, r=2, P=2, nf=3, patience=300, sched_every=1):
    """``tests/test_train_chunk_kernel.py::fourier_problem``: the same
    configuration, data and POD modes."""
    cfg, x, modes = problem(n=n, m=m, r=r, P=P, patience=patience, sched_every=sched_every)
    cfg = dataclasses.replace(cfg, name="mkf", variant="fourier", n_fourier=nf, period_init=float(m))
    return cfg, x, modes


def test_fourier_plain_chunk_matches_jax_mega_kernel():
    """The JAX suite's Fourier problem (nF=3) over 30 epochs: the trace to
    2e-4 (``test_fourier_metrics_trace_matches_reference_chunk``) and the
    final state, periods included, to its bounds
    (``test_fourier_final_state_matches_reference_chunk``)."""
    cfg, x, modes = fourier_problem()
    ref_state, ref_m = run_jax(cfg, x, modes, 30)
    state, mets = run_plain(cfg, x, modes, [30])
    for key in ("rec", "ortho", "l1", "total", "max_arg"):
        np.testing.assert_allclose(mets[key], ref_m[key], rtol=2e-4, atol=1e-6, err_msg=key)
    assert set(state.params) == set(ref_state.params) >= {"period", "trig_period"}
    assert_state_close(state, ref_state)


def test_fourier_aneurysm_coefficient_regime_matches_jax():
    """fourier_aneurysm's series length (nF=30, 61 coefficients) at n=64,
    m=24, 10 epochs (``test_fourier_aneurysm_shape_regime``): both build the
    harmonics by the same recurrence, so the first total agrees to 1e-6 and
    the trace to 2e-4 (the JAX suite allows its scan 2e-3). The
    coefficients are not compared: at this length many of their gradients
    are near zero, and Adamax steps such an entry by +-lr on rounding alone."""
    cfg, x, modes = fourier_problem(n=64, m=24, nf=30)
    _, ref_m = run_jax(cfg, x, modes, 10)
    _, mets = run_plain(cfg, x, modes, [10])
    np.testing.assert_allclose(mets["total"][0], ref_m["total"][0], rtol=1e-6)
    for key in ("rec", "l1", "total", "max_arg"):
        np.testing.assert_allclose(mets[key], ref_m[key], rtol=2e-4, atol=1e-6, err_msg=key)


def test_fourier_resume_mid_chunk():
    """chunk(15) then chunk(15) against the JAX kernel's 30
    (``test_fourier_resume_from_mid_chunk_state``)."""
    cfg, x, modes = fourier_problem()
    ref_state, _ = run_jax(cfg, x, modes, 30)
    split, _ = run_plain(cfg, x, modes, [15, 15])
    assert split.epoch == 30 and split.count == 30
    assert_state_close(split, ref_state)


def test_fourier_plateau_lr_drops_match_jax_mega_kernel():
    """The scheduler steps the period group's LR with the others, on the
    same epochs as the JAX kernel."""
    cfg, x, modes = fourier_problem(patience=3, sched_every=2)
    ref_state, ref_m = run_jax(cfg, x, modes, 40)
    state, mets = run_plain(cfg, x, modes, [40])
    assert float(state.sched.lrs[4]) < cfg.lr_period  # a drop happened, the period LR's too
    np.testing.assert_allclose(state.sched.lrs.numpy(), ref_state.sched.lrs, rtol=1e-6)
    assert int(state.sched.num_bad) == int(ref_state.sched.num_bad)
    np.testing.assert_allclose(mets["total"], ref_m["total"], rtol=5e-4, atol=1e-6)


def test_fourier_plain_chunk_matches_eager_fit():
    """``train.fit`` through the plain Fourier chunk against the eager
    autograd loop from the same params: the chunk builds the harmonics by the
    recurrence, the eager loop evaluates cos(h th) directly, so they agree to
    1e-4 over 20 epochs."""
    cfg, x, modes = fourier_problem(patience=5, sched_every=3)
    spec, batch, _ = port_start(cfg, x, modes)
    params = fourier.Fourier(spec).params()
    loss_fn = fourier.build_loss(spec, cfg.beta, cfg.l1_lambda, method="factored")
    groups = fourier.param_groups(params)
    eager = train.fit(loss_fn, groups, cfg, params, batch, num_epochs=20, chunk_size=8, log=None)
    fused = train.fit(loss_fn, groups, cfg, params, batch, num_epochs=20, chunk_size=8, log=None,
                      chunk=train_chunk.make_chunk(spec, cfg))
    for key in train.METRICS:
        np.testing.assert_allclose(fused.history[key], eager.history[key], rtol=1e-4, atol=1e-7, err_msg=key)
    for key in params:
        np.testing.assert_allclose(
            fused.state.params[key].numpy(), eager.state.params[key].numpy(), rtol=1e-4, atol=1e-5, err_msg=key
        )


@pytest.mark.parametrize("r, P", [(2, 2), (4, 3), (4, 4), (8, 2), (8, 3), (9, 1)])
def test_supports_matches_jax(r, P):
    cfg = dataclasses.replace(configs.get("cylinder"), r=r, poly_order=P)
    spec = desmo.DesmoSpec(cfg.n, cfg.m, r, P)
    jspec = jdesmo.DesmoSpec(cfg.n, cfg.m, r, P)
    assert train_chunk.supports(spec, cfg) == jtc.supports(jspec, jconfigs.RunConfig(**dataclasses.asdict(cfg)))


@pytest.mark.parametrize("nf", [0, 1, 10, 63, 64])
def test_fourier_supports_matches_jax(nf):
    cfg = dataclasses.replace(configs.get("fourier_cylinder"), n_fourier=nf)
    spec = fourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, nf, cfg.period_init)
    jspec = jfourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, nf, cfg.period_init)
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    assert train_chunk.supports(spec, cfg) == jtc.supports(jspec, jcfg) == (1 <= nf <= 63)
    cuda = torch.device("cuda")
    assert (train_chunk.select_chunk(spec, cfg, cuda) is not None) == (jtc.supports(jspec, jcfg))
    assert train_chunk.select_chunk(spec, cfg, torch.device("cpu")) is None


def test_select_chunk_policy():
    cfg, _, _ = problem()
    spec = desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for dev in (cpu, cuda):
        assert train_chunk.select_chunk(spec, dataclasses.replace(cfg, chunk_method="scan"), dev) is None
        assert train_chunk.select_chunk(spec, dataclasses.replace(cfg, chunk_method="megakernel"), dev) is not None
    assert train_chunk.select_chunk(spec, cfg, cpu) is None  # auto on the CPU: the eager loop
    assert train_chunk.select_chunk(spec, cfg, cuda) is not None
    assert train_chunk.select_chunk(spec, dataclasses.replace(cfg, loss_method="fused"), cuda) is not None
    assert train_chunk.select_chunk(spec, dataclasses.replace(cfg, loss_method="factored"), cuda) is None
    big = desmo.DesmoSpec(cfg.n, cfg.m, 8, 3)  # K = 165 + 24 > 128
    assert train_chunk.select_chunk(big, cfg, cuda) is None
    for bad_spec, bad_cfg in ((big, cfg), (spec, dataclasses.replace(cfg, variant="fourier"))):
        with pytest.raises(ValueError, match="megakernel"):
            train_chunk.select_chunk(bad_spec, dataclasses.replace(bad_cfg, chunk_method="megakernel"), cpu)


def test_cpu_takes_the_plain_chunk_and_counts_no_launch():
    cfg, x, modes = problem()
    spec, batch, state = port_start(cfg, x, modes)
    before = train_chunk.fused_train_chunk.launches
    s1, m1 = train_chunk.fused_train_chunk(state, batch, 3, spec, cfg)
    s2, m2 = train_chunk.train_chunk_plain(state, batch, 3, spec, cfg)
    assert train_chunk.fused_train_chunk.launches == before == 0
    for key in m1:
        assert torch.equal(m1[key], m2[key])
    for key in s1.params:
        assert torch.equal(s1.params[key], s2.params[key])
    # the input state is not trained in place
    assert torch.equal(state.params["phi"], torch.ones_like(state.params["phi"]))


def test_cpu_takes_the_plain_fourier_chunk_and_counts_no_launch():
    cfg, x, modes = fourier_problem()
    spec, batch, state = port_start(cfg, x, modes)
    before = train_chunk.fused_train_chunk.launches
    s1, m1 = train_chunk.fused_train_chunk(state, batch, 3, spec, cfg)
    s2, m2 = train_chunk.train_chunk_plain(state, batch, 3, spec, cfg)
    assert train_chunk.fused_train_chunk.launches == before == 0
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert list(s1.params) == list(state.params) and all(torch.equal(s1.params[k], s2.params[k]) for k in s1.params)
    assert not torch.equal(s1.params["period"], state.params["period"])
    # a state whose series length is not the spec's is refused
    short = dataclasses.replace(spec, n_fourier=2)
    with pytest.raises(ValueError, match="series length"):
        train_chunk.fused_train_chunk(state, batch, 1, short, dataclasses.replace(cfg, n_fourier=2))


@pytest.mark.parametrize(
    "bad",
    [
        lambda b: {**b, "x": b["x"].double()},
        lambda b: {**b, "pod_modes": b["pod_modes"][:, :1].contiguous()},
        lambda b: {**b, "x": b["x"].T.contiguous().T},
        lambda b: {**b, "x_sq": b["x_sq"].reshape(1)},
    ],
)
def test_wrapper_rejects_malformed_inputs(bad):
    cfg, x, modes = problem()
    spec, batch, state = port_start(cfg, x, modes)
    with pytest.raises(ValueError):
        train_chunk.fused_train_chunk(state, bad(batch), 2, spec, cfg)


@pytest.mark.parametrize("omega", ["unit", "preset"])
def test_runner_runs_the_mega_kernel_chunk(tmp_path, omega):
    """``runner.run`` with ``chunk_method='megakernel'`` on the CPU (the
    plain chunk) against the same run through the eager loop. At
    omega_init=1 the whole run is held to 1e-4; at the preset's 1e4 the
    dynamics amplify rounding about tenfold an epoch (``PERF.md``, Findings), so
    the first 3 epochs are held to 1e-4 and the rest only to finiteness."""
    over = dict(omega_init=1.0, lr_omega=1.0) if omega == "unit" else {}
    base = dataclasses.replace(
        configs.get("cylinder"), r=2, poly_order=2, num_epochs=30, checkpoint_every=10, **over
    )
    x = synthetic.cylinder_wake(200, 60)
    kern = runner.run(dataclasses.replace(base, chunk_method="megakernel"), x,
                      out_dir=str(tmp_path / "k"), echo=False, device="cpu")
    eager = runner.run(dataclasses.replace(base, chunk_method="scan"), x,
                       out_dir=str(tmp_path / "e"), echo=False, device="cpu")
    n_close = 30 if omega == "unit" else 3
    for key in train.METRICS:
        assert np.isfinite(kern.history[key]).all()
        np.testing.assert_allclose(kern.history[key][:n_close], eager.history[key][:n_close], rtol=1e-4, err_msg=key)
    assert {"state_epoch10.npz", "state_final.npz", "cylinder_r2_final.pt"} <= set(
        p.name for p in Path(kern.out_dir).iterdir()
    )
    assert len(kern.sweep) == len(eager.sweep)


def test_runner_runs_the_fourier_preset(tmp_path):
    """``runner.run`` of fourier_cylinder on the CPU at a small size through
    the mega-kernel's plain chunk and through the eager loop, at
    omega_init=1: the two agree to 1e-4 in the first 10 epochs (the chunk's
    recurrence against the eager loop's direct cos(h th)) and both export the
    reference's Fourier keys."""
    base = dataclasses.replace(
        configs.get("fourier_cylinder"), num_epochs=30, checkpoint_every=10, omega_init=1.0, lr_omega=1.0
    )
    x = synthetic.cylinder_wake(200, 60)
    kern = runner.run(dataclasses.replace(base, chunk_method="megakernel"), x,
                      out_dir=str(tmp_path / "k"), echo=False, device="cpu")
    eager = runner.run(dataclasses.replace(base, chunk_method="scan"), x,
                       out_dir=str(tmp_path / "e"), echo=False, device="cpu")
    for key in train.METRICS:
        assert np.isfinite(kern.history[key]).all()
        np.testing.assert_allclose(kern.history[key][:10], eager.history[key][:10], rtol=1e-4, err_msg=key)
    for art in (kern, eager):
        files = {p.name for p in Path(art.out_dir).iterdir()}
        assert {"state_epoch10.npz", "state_final.npz", "fourier_cylinder_r2_final.pt"} <= files
        sd = torch.load(Path(art.out_dir) / "fourier_cylinder_r2_final.pt", weights_only=True)
        assert sd["z_list.0"].shape == (2 * base.n_fourier + 1,)
        assert {"period_list.0", "trig_period_list.5"} <= set(sd)
        assert 0.0 < art.relative_error < 10.0 and len(art.sweep) == 14


EMULATION = Path(__file__).parent / "cuda_emulation" / "cooperative"


@pytest.fixture(scope="module")
def emulated_train_chunk(tmp_path_factory):
    """``csrc/train_chunk.cu`` compiled by the host C++ compiler against
    ``tests/cuda_emulation/cooperative``: every block's threads run at once,
    ``this_grid().sync()`` is a barrier over all of them."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA source for the emulated grid")
    out = tmp_path_factory.mktemp("train_chunk_emulated")
    cpp = out / "train_chunk_emulated.cpp"
    cpp.write_text((_build.CSRC / "train_chunk.cu").read_text() + '\n#include "harness.inc"\n')
    exe = out / "train_chunk_emulated"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-I", str(EMULATION), "-I", str(_build.CSRC), str(cpp), "-o", str(exe)],
        check=True, capture_output=True, timeout=240,
    )
    return exe


def kernel_arrays(cs):
    """The state arrays of the kernel layout in the harness's order, by name."""
    temporal = {"b": cs.b} if cs.series is None else {"series": cs.series, "periods": cs.periods}
    return {"phi": cs.phi, **temporal, "coef": cs.coef, "omega": cs.omega, "svec": cs.svec}


def run_emulated(exe, tmp_path, state, batch, steps, spec, cfg, grid, betas=None, lams=None, sums=False):
    """One chunk of the CUDA source on an emulated grid of ``grid`` blocks,
    from a stacked state of S seeds; returns the state arrays in the kernel
    layout and the metrics rows (steps, S, 5), by name, and with ``sums``
    the last epoch's summed partials (``gcoef`` (S Ks,) and ``gomega``
    (3 S r,))."""
    S = state.params["phi"].shape[0]
    cs = train_chunk.pack_seeds(state, *train_chunk.seed_hypers(cfg, S, betas, lams))
    x = batch["x"].numpy()
    n, m = x.shape
    r, P, K = spec.r, spec.poly_order, spec.num_poly_terms + 3 * spec.r
    nf = train_chunk.n_fourier(spec, cfg)
    header = np.array([n, m, r, P, K, S, nf, steps, cfg.sched_every, grid], np.int32)
    floats = np.array([cfg.patience, cfg.sched_factor, cfg.sched_min_lr, float(batch["x_sq"])], np.float32)
    state_arrays = {k: v.numpy() for k, v in kernel_arrays(cs).items()}
    arrays = [batch["pod_modes"].numpy(), x, train_chunk.column_table(spec, S), state_arrays["phi"]]
    if nf:
        arrays.append(fourier.t_points(m))
    arrays += [v for k, v in state_arrays.items() if k != "phi"]
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(header.tobytes() + floats.tobytes() + b"".join(np.ascontiguousarray(a).tobytes() for a in arrays))
    proc = subprocess.run([str(exe), str(src), str(dst)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = np.fromfile(dst, np.float32)
    shapes = {k: v.shape for k, v in state_arrays.items()}
    shapes["metrics"] = (steps, S, len(train_chunk.METRICS))
    shapes.update(ga=(S, K, K), latg=(S, r, r), gcoef=(S * K,), gomega=(3 * S * r,))
    sizes = [int(np.prod(s)) for s in shapes.values()]
    assert out.size == sum(sizes)
    parts = np.split(out, np.cumsum(sizes)[:-1])
    got = {k: p.reshape(s) for (k, s), p in zip(shapes.items(), parts)}
    for k in ("ga", "latg") + (() if sums else ("gcoef", "gomega")):
        del got[k]
    return got


def assert_emulated_matches_plain(got, state, batch, steps, spec, cfg, betas=None, lams=None):
    """The emulated grid's arrays against the plain packed chunk's from the
    same stacked state: the same fp32 arithmetic in another summation order,
    held to 2e-6 of each array's largest entry (each metric of each seed on
    its own scale)."""
    S = state.params["phi"].shape[0]
    hypers = train_chunk.seed_hypers(cfg, S, betas, lams)
    ref_state, ref_m = train_chunk.train_chunk_plain_packed(state, batch, steps, spec, cfg, *hypers)
    want = {k: v.numpy() for k, v in kernel_arrays(train_chunk.pack_seeds(ref_state, *hypers)).items()}
    per_seed = [ref_m[k] for k in train_chunk.SEED_METRICS] + [ref_m["max_arg"][:, None].expand(steps, S)]
    want["metrics"] = torch.stack(per_seed, dim=2).numpy()
    assert list(got) == list(want)
    for name, g in got.items():
        assert np.isfinite(g).all(), name
        axis = 0 if name == "metrics" else None
        err, scale = np.abs(g - want[name]).max(axis=axis), np.abs(want[name]).max(axis=axis)
        assert np.all(err <= 2e-6 * scale), (name, err, scale)


@pytest.mark.parametrize(
    "n, m, r, P, steps, patience, sched_every",
    [
        (96, 40, 2, 2, 6, 300, 1),  # the JAX suite's size; two column sub-slabs per block
        (64, 24, 4, 3, 4, 300, 1),  # the cylinder regime, K=47
        (37, 9, 2, 2, 8, 1, 2),  # ragged rows, a block with no columns, LR drops
        (40, 17, 5, 2, 3, 300, 1),  # K=36: the kernel built for K <= 64
        (33, 12, 4, 4, 2, 300, 1),  # K=82: the kernel built for K <= 128
    ],
)
def test_cuda_source_on_emulated_grid(emulated_train_chunk, tmp_path, n, m, r, P, steps, patience, sched_every):
    """Four emulated blocks against the plain chunk, from a state with
    random phi and POD-like modes that are not orthonormal, so no sign of a
    near-zero Gram entry decides the phi update. Same fp32 arithmetic in
    another summation order: held to 2e-6 of each array's largest entry."""
    rng = np.random.default_rng(n)
    cfg = configs.RunConfig(
        name="emu", variant="desmo", n=n, m=m, r=r, poly_order=P, omega_init=1.0, lr_omega=1.0,
        patience=patience, sched_every=sched_every,
    )
    spec = desmo.DesmoSpec(n, m, r, P, 1.0)
    xt = torch.as_tensor(rng.standard_normal((n, m)).astype(np.float32))
    batch = {"x": xt, "x_sq": torch.sum(xt * xt),
             "pod_modes": torch.as_tensor((0.3 * rng.standard_normal((n, r))).astype(np.float32))}
    params = desmo.Desmo(spec).params()
    params["phi"] = torch.as_tensor((1.0 + 0.1 * rng.standard_normal((r, n))).astype(np.float32))
    state = train.init_state(params, cfg)
    if patience == 1:  # a best no epoch beats: the scheduler drops the LRs within the chunk
        state.sched = dataclasses.replace(state.sched, best=torch.tensor(0.0))
    state = train_chunk.stack_seed(state)
    got = run_emulated(emulated_train_chunk, tmp_path, state, batch, steps, spec, cfg, grid=4)
    assert_emulated_matches_plain(got, state, batch, steps, spec, cfg)
    if patience == 1:
        assert got["svec"][0, 0] < cfg.lr_coef  # the scheduler dropped the LRs


@pytest.mark.parametrize(
    "n, m, r, P, nf, steps, patience, sched_every",
    [
        (96, 40, 2, 2, 3, 6, 300, 1),  # the JAX suite's Fourier problem; two sub-slabs per block
        (64, 24, 2, 2, 30, 3, 300, 1),  # fourier_aneurysm's 61 coefficients: the series table in two groups
        (37, 9, 2, 2, 2, 8, 1, 2),  # ragged rows, a block with no columns, LR drops
        (40, 17, 4, 3, 5, 3, 300, 1),  # K=47: the kernel built for K <= 48
    ],
)
def test_fourier_cuda_source_on_emulated_grid(
    emulated_train_chunk, tmp_path, n, m, r, P, nf, steps, patience, sched_every
):
    """The Fourier form on four emulated blocks against the plain chunk,
    from random phi, series and periods and POD-like modes that are not
    orthonormal; 2e-6 of each array's largest entry, as the desmo form."""
    rng = np.random.default_rng(n + nf)
    cfg = configs.RunConfig(
        name="emuf", variant="fourier", n=n, m=m, r=r, poly_order=P, omega_init=1.0, lr_omega=1.0,
        n_fourier=nf, period_init=float(m), patience=patience, sched_every=sched_every,
    )
    spec = fourier.FourierSpec(n, m, r, P, 1.0, nf, float(m))
    xt = torch.as_tensor(rng.standard_normal((n, m)).astype(np.float32))
    batch = {"x": xt, "x_sq": torch.sum(xt * xt),
             "pod_modes": torch.as_tensor((0.3 * rng.standard_normal((n, r))).astype(np.float32))}
    params = fourier.Fourier(spec).params()
    params["phi"] = torch.as_tensor((1.0 + 0.1 * rng.standard_normal((r, n))).astype(np.float32))
    for key in ("z", "z_trig"):
        params[key] = torch.as_tensor((0.5 * rng.standard_normal(params[key].shape)).astype(np.float32))
    for key in ("period", "trig_period"):
        params[key] = torch.as_tensor((m * (0.7 + 0.6 * rng.random(params[key].shape))).astype(np.float32))
    state = train.init_state(params, cfg)
    if patience == 1:  # a best no epoch beats: the scheduler drops the LRs within the chunk
        state.sched = dataclasses.replace(state.sched, best=torch.tensor(0.0))
    state = train_chunk.stack_seed(state)
    got = run_emulated(emulated_train_chunk, tmp_path, state, batch, steps, spec, cfg, grid=4)
    assert_emulated_matches_plain(got, state, batch, steps, spec, cfg)
    if patience == 1:
        assert got["svec"][0, 4] < cfg.lr_period  # the period LR dropped with the others


@pytest.mark.parametrize(
    "n, m, r, P, grid",
    [
        (17, 9, 2, 2, 5),  # slabs of 8 and 1 column (narrower than an n8 tile), row groups 9 and 8, a block idle
        (70, 50, 4, 3, 6),  # K=47 (KP=48): slabs of 32 and 18 columns, row groups 24, 24, 22
        (40, 33, 7, 2, 3),  # K=57 (KP=64): slabs of 24 and 9 columns over one row group, a block idle
        (33, 20, 4, 4, 7),  # K=82 (KP=128): 3 row groups x 2 slabs of 16 and 4, a block idle
        (24, 300, 2, 2, 2),  # K=12: three 104-column slabs over two blocks, block 0 takes two
    ],
)
def test_cuda_source_ax_split_on_emulated_grid(emulated_train_chunk, tmp_path, n, m, r, P, grid):
    """The columns phase's 2-D AᵀX split at its edges (the comments give the
    split ``ax_split`` makes of each grid): the chunk on the emulated grid
    against the plain chunk, 2e-6 of each array's largest entry, as above."""
    rng = np.random.default_rng(n + m)
    cfg = configs.RunConfig(
        name="emu", variant="desmo", n=n, m=m, r=r, poly_order=P, omega_init=1.0, lr_omega=1.0,
    )
    spec = desmo.DesmoSpec(n, m, r, P, 1.0)
    xt = torch.as_tensor(rng.standard_normal((n, m)).astype(np.float32))
    batch = {"x": xt, "x_sq": torch.sum(xt * xt),
             "pod_modes": torch.as_tensor((0.3 * rng.standard_normal((n, r))).astype(np.float32))}
    params = desmo.Desmo(spec).params()
    params["phi"] = torch.as_tensor((1.0 + 0.1 * rng.standard_normal((r, n))).astype(np.float32))
    state = train_chunk.stack_seed(train.init_state(params, cfg))
    got = run_emulated(emulated_train_chunk, tmp_path, state, batch, 3, spec, cfg, grid=grid)
    assert_emulated_matches_plain(got, state, batch, 3, spec, cfg)


# aneurysm's rows per block on the H100 (27,000 over 132 blocks: 205), at a
# width the emulated grid runs in seconds
INIT_N, INIT_M, INIT_GRID = 1640, 100, 8


def reference_init(n=INIT_N, m=INIT_M, r=4, P=2):
    """The reference init (phi, the coefficients and B all ones) at
    omega 1 on the synthetic wake and its r POD modes:
    ``(spec, cfg, state, batch)``. B all ones makes X·Bᵀ X's row sums, so
    dA is the same for every column of a row, and each trig column's
    gradient terms keep their sign over long runs of rows."""
    from desmo_tpu_torch import pod

    x = synthetic.cylinder_wake(n, m, seed=0)
    xt = torch.as_tensor(x)
    spec = desmo.DesmoSpec(n, m, r, P, 1.0)
    cfg = configs.RunConfig(name="reference_init", variant="desmo", n=n, m=m, r=r, poly_order=P, omega_init=1.0)
    batch = {"x": xt, "x_sq": torch.sum(xt * xt), "pod_modes": pod.pod_host(x, r, "cpu").modes.contiguous()}
    return spec, cfg, train.init_state(desmo.Desmo(spec).params(), cfg), batch


def reference_init_sums(spec, cfg, state, batch):
    """``step_plain``'s partials of ``state`` in float64: gcoef, gomega."""
    from desmo_tpu_torch.kernels import shard_step

    cs = train_chunk.pack_seeds(train_chunk.stack_seed(state), *train_chunk.seed_hypers(cfg, 1))
    ref = shard_step.make_buffers(cs, batch, 1, spec, cfg, spec.n).to("cpu", torch.float64)
    shard_step.step_plain(ref, spec)
    K = spec.num_poly_terms + 3 * spec.r
    return shard_step.split_seed_sums(ref.sums, K, spec.m, spec.r, 1)[3:]


def test_tile_sums_meet_the_contract_at_the_reference_init(emulated_train_chunk, tmp_path):
    """At the reference init with 205 rows a block, the first epoch's
    gcoef and gomega within 5e-6 of their largest entry in float64, the
    contract of the kernel's contractions. Each column sums a row tile's
    terms as a pairwise tree, then the tiles; one fmaf chain over the
    block's rows reached 6.3e-6 on gomega here (1.7e-5 at aneurysm with 4
    seeds on the card)."""
    spec, cfg, state, batch = reference_init()
    got = run_emulated(emulated_train_chunk, tmp_path, train_chunk.stack_seed(state), batch, 1, spec, cfg,
                       grid=INIT_GRID, sums=True)
    for name, ref in zip(("gcoef", "gomega"), reference_init_sums(spec, cfg, state, batch)):
        ref = ref.numpy()
        assert np.abs(got[name] - ref).max() <= 5e-6 * np.abs(ref).max(), name


def run_emulated_probe(exe, tmp_path, a, b, x, grid):
    """``desmo_chunk_contract_probe``'s kernel on an emulated grid: (xb, ax)."""
    n, k = a.shape
    m = x.shape[1]
    src, dst = tmp_path / "probe_in.bin", tmp_path / "probe_out.bin"
    src.write_bytes(np.array([n, m, k, grid], np.int32).tobytes() + b"".join(
        np.ascontiguousarray(v, np.float32).tobytes() for v in (a, b, x)))
    proc = subprocess.run([str(exe), "probe", str(src), str(dst)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = np.fromfile(dst, np.float32)
    assert out.size == n * k + k * m
    return out[:n * k].reshape(n, k), out[n * k:].reshape(k, m)


@pytest.mark.parametrize(
    "n, m, k, grid",
    [
        (70, 50, 20, 4),  # KP=32
        (70, 50, 47, 4),  # KP=48, the cylinder's K
        (17, 9, 60, 5),  # KP=64: one row tile, a slab narrower than an n8 tile
        (96, 40, 108, 6),  # KP=128, aneurysm S=4's K'
        (100, 130, 128, 3),  # K=128: every m16 tile, more slabs than blocks
        (45, 7, 1, 2),  # K=1: A's rows padded from 1 to 4 floats
    ],
)
def test_contract_probe_on_emulated_grid(emulated_train_chunk, tmp_path, n, m, k, grid):
    """The kernel's own X·Bᵀ and AᵀX routines (3xTF32 tiles, the emulated
    mma.sync rounding its operands to TF32 per lane) against the products in
    float64, to the 5e-6 of max|ref| the card holds them to, with X centred
    over its rows and (K > 1) a constant column in A, whose sums cancel; at
    K = 1 that column alone would make max|ref| the centring's own rounding."""
    rng = np.random.default_rng(n * k + m)
    a = rng.standard_normal((n, k)).astype(np.float32)
    if k > 1:
        a[:, 0] = 1.0
    b = rng.standard_normal((k, m)).astype(np.float32)
    x = rng.standard_normal((n, m)).astype(np.float32)
    x = (x - x.mean(axis=0, keepdims=True)).astype(np.float32)
    xb, ax = run_emulated_probe(emulated_train_chunk, tmp_path, a, b, x, grid)
    for got, ref in ((xb, x.astype(np.float64) @ b.astype(np.float64).T),
                     (ax, a.astype(np.float64).T @ x.astype(np.float64))):
        assert np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 5e-6 * np.abs(ref).max()


def test_contract_probe_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the probe is its plain version and counts no launch;
    it refuses what the kernel does not take."""
    rng = np.random.default_rng(0)
    a, b, x = (torch.as_tensor(rng.standard_normal(s).astype(np.float32)) for s in ((30, 12), (12, 20), (30, 20)))
    launches = train_chunk.contract_probe.launches
    xb, ax = train_chunk.contract_probe(a, b, x)
    assert train_chunk.contract_probe.launches == launches
    torch.testing.assert_close(xb, x @ b.T, rtol=0, atol=0)
    torch.testing.assert_close(ax, a.T @ x, rtol=0, atol=0)
    with pytest.raises(ValueError):
        train_chunk.contract_probe(a.double(), b, x)
    with pytest.raises(ValueError):
        train_chunk.contract_probe(torch.zeros((30, 129)), torch.zeros((129, 20)), x)


def test_epoch_sums_and_phase_split_need_the_card():
    """The kernel's summed partials and its clock live in the card's
    scratch: on CPU tensors ``epoch_sums`` and ``phase_split`` raise and
    count no launch."""
    spec, cfg, state, batch = reference_init(n=40, m=12)
    launches = train_chunk.fused_train_chunk.launches
    with pytest.raises(ValueError, match="CUDA"):
        train_chunk.epoch_sums(state, batch, spec, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        train_chunk.phase_split(state, batch, 2, spec, cfg)
    assert train_chunk.fused_train_chunk.launches == launches
