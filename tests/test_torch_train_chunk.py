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
from desmo_tpu.pallas import train_chunk as jtc  # noqa: E402
from desmo_tpu_torch import checkpoint, configs, runner, train  # noqa: E402
from desmo_tpu_torch.io import synthetic  # noqa: E402
from desmo_tpu_torch.kernels import _build, train_chunk  # noqa: E402
from desmo_tpu_torch.models import desmo  # noqa: E402


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
    """The JAX package's spec, init params and fresh state for ``cfg``."""
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
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


@pytest.mark.parametrize("r, P", [(2, 2), (4, 3), (4, 4), (8, 2), (8, 3), (9, 1)])
def test_supports_matches_jax(r, P):
    cfg = dataclasses.replace(configs.get("cylinder"), r=r, poly_order=P)
    spec = desmo.DesmoSpec(cfg.n, cfg.m, r, P)
    jspec = jdesmo.DesmoSpec(cfg.n, cfg.m, r, P)
    assert train_chunk.supports(spec, cfg) == jtc.supports(jspec, jconfigs.RunConfig(**dataclasses.asdict(cfg)))


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
        [gxx, "-std=c++20", "-O1", "-pthread", "-I", str(EMULATION), str(cpp), "-o", str(exe)],
        check=True, capture_output=True, timeout=240,
    )
    return exe


def run_emulated(exe, tmp_path, state, batch, steps, spec, cfg, grid):
    """One chunk of the CUDA source on an emulated grid of ``grid`` blocks;
    returns the state in the kernel layout and the metrics rows."""
    cs = train_chunk.pack(state)
    x = batch["x"].numpy()
    n, m = x.shape
    r, P, T = spec.r, spec.poly_order, spec.num_poly_terms
    header = np.array([n, m, r, P, T, steps, cfg.sched_every, grid], np.int32)
    floats = np.array(
        [cfg.beta, cfg.l1_lambda, cfg.patience, cfg.sched_factor, cfg.sched_min_lr, float(batch["x_sq"])],
        np.float32,
    )
    arrays = [batch["pod_modes"].numpy(), x, spec.factor_table().astype(np.int32),
              cs.phi.numpy(), cs.b.numpy(), cs.coef.numpy(), cs.omega.numpy(), cs.svec.numpy()]
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(header.tobytes() + floats.tobytes() + b"".join(np.ascontiguousarray(a).tobytes() for a in arrays))
    proc = subprocess.run([str(exe), str(src), str(dst)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = np.fromfile(dst, np.float32)
    shapes = [cs.phi.shape, cs.b.shape, cs.coef.shape, cs.omega.shape, cs.svec.shape, (steps, len(train_chunk.METRICS))]
    sizes = [int(np.prod(s)) for s in shapes]
    assert out.size == sum(sizes)
    parts = np.split(out, np.cumsum(sizes)[:-1])
    return [p.reshape(s) for p, s in zip(parts, shapes)]


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
    got = run_emulated(emulated_train_chunk, tmp_path, state, batch, steps, spec, cfg, grid=4)
    ref_state, ref_m = train_chunk.train_chunk_plain(state, batch, steps, spec, cfg)
    ref = train_chunk.pack(ref_state)
    ref_met = torch.stack([ref_m[k] for k in train_chunk.METRICS], dim=1)
    for name, g, want in zip(("phi", "b", "coef", "omega", "svec", "metrics"), got,
                             (ref.phi, ref.b, ref.coef, ref.omega, ref.svec, ref_met)):
        want = want.numpy()
        assert np.isfinite(g).all(), name
        axis = 0 if name == "metrics" else None  # each metric on its own scale
        err, scale = np.abs(g - want).max(axis=axis), np.abs(want).max(axis=axis)
        assert np.all(err <= 2e-6 * scale), (name, err, scale)
    if patience == 1:
        assert got[4][0] < cfg.lr_coef  # the scheduler dropped the LRs
