"""The port's AE kernel module (``desmo_tpu_torch.kernels.ae_chunk``).

- Its plain chunk against ``desmo_tpu``'s AE kernel
  (``make_ae_fused_chunk`` in interpret mode, as ``tests/test_ae_chunk.py``
  runs it) at that suite's size and tolerances, one row block and four,
  both packages starting from the same state (``checkpoint.state_from_jax``):
  the metrics trace, the params on two tiers, the optimizer and scheduler
  state, a plateau drop and a mid-chunk resume.
- Its plain chunk against the port's own eager loop (autograd).
- The kernel's gate and the chunk policy.
- ``runner.run`` and the CLI on the AE preset against ``desmo_tpu.runner.run``.
- The CUDA source (``csrc/ae_chunk.cu``), compiled by the host compiler and
  run on an emulated cooperative grid, against the plain chunk.

The CUDA kernel itself is held against the plain chunk on the card by
``tests/test_torch_gpu.py``.
"""

import dataclasses
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from desmo_tpu import checkpoint as jckpt  # noqa: E402
from desmo_tpu import configs as jconfigs  # noqa: E402
from desmo_tpu import runner as jrunner  # noqa: E402
from desmo_tpu import train as jtrain  # noqa: E402
from desmo_tpu.io import synthetic as jsynthetic  # noqa: E402
from desmo_tpu.models import autoencoder as jae  # noqa: E402
from desmo_tpu.pallas import ae_chunk as jac  # noqa: E402
from desmo_tpu.pallas import train_chunk as jtc  # noqa: E402
from desmo_tpu_torch import __main__ as cli  # noqa: E402
from desmo_tpu_torch import checkpoint, configs, runner, train  # noqa: E402
from desmo_tpu_torch.kernels import _build, ae_chunk, train_chunk  # noqa: E402
from desmo_tpu_torch.kernels._chunk_optim import B1  # noqa: E402
from desmo_tpu_torch.models import autoencoder as ae  # noqa: E402
from desmo_tpu_torch.models import desmo  # noqa: E402

STEPS = 25


def tiny_cfg(**over):
    """``tests/test_ae_chunk.py::_tiny_cfg``: omega_init=1 and tame LRs, since
    at the preset's 1e4 a 1-ulp latent difference flips the signs of sin."""
    base = dict(n=64, m=40, num_epochs=STEPS, patience=5, sched_every=1, log_every=100, checkpoint_every=1000,
                omega_init=1.0, lr_coef=1e-3, lr_z=1e-3, lr_omega=1e-2)
    return dataclasses.replace(configs.get("ae_cylinder"), **{**base, **over})


def jax_start(cfg, best=None):
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    jspec = jae.AESpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
    state = jtrain.init_state(jae.init_params_live(jspec), jcfg)
    if best is not None:  # a best no epoch beats: the scheduler drops the LRs within the chunk
        state = state._replace(sched=state.sched._replace(best=jnp.asarray(best, jnp.float32)))
    return jcfg, jspec, state


def snapshots(cfg):
    return np.asarray(jsynthetic.cylinder_wake(cfg.n, cfg.m, seed=0), np.float32)


def run_jax(cfg, steps=STEPS, bs=None, best=None):
    """``steps`` epochs of ``desmo_tpu``'s AE kernel in interpret mode."""
    jcfg, jspec, state = jax_start(cfg, best)
    x = jnp.asarray(snapshots(cfg))
    chunk = jac.make_ae_fused_chunk(jspec, jcfg, bt=16, interpret=True, bs=bs)
    batch = jtc.prepare_batch(x, np.zeros((cfg.r, cfg.n)), bt=16)
    state, mets = chunk(jax.tree.map(jnp.array, state), batch, num_steps=steps)
    return jax.tree.map(np.asarray, state), {k: np.asarray(v) for k, v in mets.items()}


def port_start(cfg, best=None):
    _, _, jstate = jax_start(cfg, best)
    spec = ae.AESpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
    xt = torch.as_tensor(snapshots(cfg))
    batch = {"x": xt, "x_sq": torch.sum(xt * xt), "x_colsum": xt.sum(0)}
    return spec, batch, checkpoint.state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")


def run_plain(cfg, chunks, best=None):
    spec, batch, state = port_start(cfg, best)
    mets = []
    for steps in chunks:
        state, m = ae_chunk.ae_chunk_plain(state, batch, steps, spec, cfg)
        mets.append({k: v.numpy() for k, v in m.items()})
    return state, {k: np.concatenate([m[k] for m in mets]) for k in mets[0]}


@pytest.fixture(scope="module")
def jax_runs():
    """The interpret-mode JAX runs, the slow part, once per module: one row
    block (n_pad == bs == 64), four (bs=16), and a run whose scheduler drops
    the LRs."""
    cfg = tiny_cfg()
    return {
        "one_block": run_jax(cfg),
        "four_blocks": run_jax(cfg, bs=16),
        "plateau": run_jax(tiny_cfg(patience=2, sched_every=2), best=0.0),
    }


def assert_params_two_tiers(ours, ref):
    """``tests/test_ae_chunk.py::test_params_track_scan``'s bound: a 1-ulp
    pre-activation difference flips a ReLU unit's gradient for one step,
    so each tensor is held to 2e-2 of its largest entry everywhere and
    5e-3 on 95% of its entries."""
    for key, ref_v in ref.items():
        d = np.abs(ours[key].numpy() - ref_v) / (np.max(np.abs(ref_v)) + 1e-12)
        assert d.max() < 2e-2, (key, d.max())
        assert (d < 5e-3).mean() >= 0.95, (key, (d >= 5e-3).mean())


def assert_opt_state(ours, ref):
    assert ours.count == int(ref.opt.count) and ours.epoch == int(ref.epoch)
    np.testing.assert_allclose(ours.sched.lrs.numpy(), ref.sched.lrs, rtol=1e-6)
    assert int(ours.sched.num_bad) == int(ref.sched.num_bad)


@pytest.mark.parametrize("run", ["one_block", "four_blocks"])
def test_plain_chunk_matches_jax_kernel(jax_runs, run):
    """25 epochs against the JAX kernel with one row block and with four
    (the cross-block sums of the ae_cylinder shape): the trace to
    ``test_ae_chunk.py``'s 5e-4 / 1e-7, the params on its two tiers, and
    count, epoch, LRs and num_bad equal."""
    ref_state, ref_m = jax_runs[run]
    state, mets = run_plain(tiny_cfg(), [STEPS])
    assert list(mets) == list(ae_chunk.METRICS)
    for key in ae_chunk.METRICS:
        np.testing.assert_allclose(mets[key], ref_m[key], rtol=5e-4, atol=1e-7, err_msg=key)
    assert list(state.params) == list(ref_state.params)
    assert_params_two_tiers(state.params, ref_state.params)
    assert_opt_state(state, ref_state)


def test_plateau_drop_matches_jax_kernel(jax_runs):
    ref_state, ref_m = jax_runs["plateau"]
    cfg = tiny_cfg(patience=2, sched_every=2)
    state, mets = run_plain(cfg, [STEPS], best=0.0)
    assert float(state.sched.lrs[0]) < cfg.lr_coef  # a drop happened
    assert_opt_state(state, ref_state)
    np.testing.assert_allclose(mets["total"], ref_m["total"], rtol=5e-4, atol=1e-7)


def test_resume_mid_chunk(jax_runs):
    """chunk(10) then chunk(15) against the JAX kernel's 25 and against the
    plain chunk's 25: the state round-trips through the kernel layout."""
    ref_state, ref_m = jax_runs["one_block"]
    split, split_m = run_plain(tiny_cfg(), [10, 15])
    whole, whole_m = run_plain(tiny_cfg(), [STEPS])
    assert split.epoch == whole.epoch == STEPS and split.count == STEPS
    np.testing.assert_allclose(split_m["total"], whole_m["total"], rtol=1e-5)
    np.testing.assert_allclose(split_m["ae"], ref_m["ae"], rtol=5e-4, atol=1e-7)
    assert_params_two_tiers(split.params, ref_state.params)
    assert_opt_state(split, ref_state)


def test_plain_chunk_matches_eager_loop():
    """``train.fit`` through the plain chunk against the eager autograd loop
    on the factored AE loss, 30 epochs in chunks of 12 from the same live
    params: the same arithmetic up to the order of fp32 sums, the trace to
    1e-4 and the params on the two tiers."""
    cfg = tiny_cfg(patience=3, sched_every=2)
    spec, batch, state = port_start(cfg)
    params = state.params
    loss_fn = ae.build_loss(spec, cfg.beta, cfg.l1_lambda, cfg.ae_beta, method="factored")
    groups = ae.param_groups(params)
    eager = train.fit(loss_fn, groups, cfg, params, batch, num_epochs=30, chunk_size=12, log=None)
    fused = train.fit(loss_fn, groups, cfg, params, batch, num_epochs=30, chunk_size=12, log=None,
                      chunk=ae_chunk.make_chunk(spec, cfg))
    assert set(fused.history) == set(eager.history) == {"rec", "ortho", "l1", "ae", "total"}
    for key in eager.history:
        np.testing.assert_allclose(fused.history[key], eager.history[key], rtol=1e-4, atol=1e-9, err_msg=key)
    assert_params_two_tiers(fused.state.params, {k: v.numpy() for k, v in eager.state.params.items()})
    np.testing.assert_array_equal(fused.state.sched.lrs.numpy(), eager.state.sched.lrs.numpy())
    assert 0.0 < fused.max_abs_trig_arg < 100.0


def test_zero_latent_rows_take_the_autograd_polynomial_gradient():
    """At a latent with exact-zero rows the plain AE chunk's first-epoch
    gradients equal torch autograd of the port's factored AE loss. With the
    encoder's biases zeroed, every row of X that is zero has every
    pre-activation 0.0 and so a latent of exactly 0.0, as 2,048 of 3,961
    rows have at ae_cylinder's Xavier/zero-bias init. The port's polynomial
    backward is the product rule over the P factors, autodiff's value. The
    reference AE kernel differs here: it divides the polynomial sum by the
    latent and takes 0 where the latent is 0
    (``desmo_tpu/pallas/ae_chunk.py:630-631``), which drops the degree-1
    terms' gradient at those rows and moves the last encoder bias's
    gradient. Each gradient is read from the first Adamax step's moment
    (``mu = (1 - b1) g`` from zero) and held to 1e-5 of its largest
    entry."""
    cfg = tiny_cfg()
    spec, batch, state = port_start(cfg)
    params = {k: torch.zeros_like(v) if k.startswith("ae_enc_b") else v for k, v in state.params.items()}
    x = batch["x"].clone()
    x[::2] = 0.0
    batch = {"x": x, "x_sq": torch.sum(x * x), "x_colsum": x.sum(0)}
    lat = ae.encode_decode(params, x)[0]
    assert bool((lat[::2] == 0.0).all()) and bool((lat[1::2] != 0.0).all())
    after, _ = ae_chunk.ae_chunk_plain(train.init_state(params, cfg), batch, 1, spec, cfg)
    loss_fn = ae.build_loss(spec, cfg.beta, cfg.l1_lambda, cfg.ae_beta, method="factored")
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    grads = dict(zip(leaves, torch.autograd.grad(loss_fn(leaves, batch)[0], list(leaves.values()))))
    for key, want in grads.items():
        got = after.mu[key] / (1.0 - B1)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), key
    assert float(grads[f"ae_enc_b{ae.N_LAYERS - 1}"].abs().max()) > 0.0


@pytest.mark.parametrize(
    "preset, over",
    [("ae_cylinder", {}), ("ae_cylinder", dict(poly_order=3)), ("ae_cylinder", dict(poly_order=4)),
     ("ae_cylinder", dict(r=3)), ("cylinder", {}), ("fourier_cylinder", {})],
)
def test_ae_supports_matches_jax(preset, over):
    """The gate agrees with ``desmo_tpu``'s where its VMEM budget does not
    decide: r == 2, K = T + 3r <= 16 (P=3 gives 16, P=4 21), the AE variant only."""
    cfg = dataclasses.replace(configs.get(preset), **over)
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    spec = desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order)
    want = jac.ae_supports(jae.AESpec(cfg.n, cfg.m, cfg.r, cfg.poly_order), jcfg)
    assert ae_chunk.ae_supports(spec, cfg) == want
    assert want == (preset == "ae_cylinder" and cfg.poly_order <= 3 and cfg.r == 2)


def test_select_chunk_policy():
    """'auto' keeps the eager loop for AE on every device, as the JAX
    package does; 'megakernel' takes the AE chunk or raises."""
    cfg = tiny_cfg()
    spec = ae.AESpec(cfg.n, cfg.m, cfg.r, cfg.poly_order)
    for dev in (torch.device("cpu"), torch.device("cuda")):
        assert train_chunk.select_chunk(spec, cfg, dev) is None
        assert train_chunk.select_chunk(spec, dataclasses.replace(cfg, chunk_method="scan"), dev) is None
        assert train_chunk.select_chunk(spec, dataclasses.replace(cfg, chunk_method="megakernel"), dev) is not None
    big = ae.AESpec(cfg.n, cfg.m, 2, 4)
    with pytest.raises(ValueError, match="megakernel"):
        train_chunk.select_chunk(big, dataclasses.replace(cfg, poly_order=4, chunk_method="megakernel"), "cpu")
    with pytest.raises(ValueError, match="chunk_method"):
        train_chunk.select_chunk(spec, dataclasses.replace(cfg, chunk_method="fast"), "cpu")


def test_cpu_takes_the_plain_chunk_and_counts_no_launch():
    cfg = tiny_cfg()
    spec, batch, state = port_start(cfg)
    before = ae_chunk.fused_ae_chunk.launches
    s1, m1 = ae_chunk.fused_ae_chunk(state, batch, 3, spec, cfg)
    s2, m2 = ae_chunk.ae_chunk_plain(state, batch, 3, spec, cfg)
    assert ae_chunk.fused_ae_chunk.launches == before == 0
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert list(s1.params) == list(state.params) and all(torch.equal(s1.params[k], s2.params[k]) for k in s1.params)
    # the input state is not trained in place
    assert not torch.equal(s1.params["ae_enc_w0"], state.params["ae_enc_w0"])


@pytest.mark.parametrize(
    "bad",
    [
        lambda b: {**b, "x": b["x"].double()},
        lambda b: {**b, "x": b["x"].T.contiguous().T},
        lambda b: {**b, "x_sq": b["x_sq"].reshape(1)},
        lambda b: {**b, "x_colsum": b["x_colsum"][:-1]},
        lambda b: {k: v for k, v in b.items() if k != "x_colsum"},
        lambda b: {**b, "x": b["x"][:, :-1].contiguous()},
    ],
)
def test_wrapper_rejects_malformed_inputs(bad):
    cfg = tiny_cfg()
    spec, batch, state = port_start(cfg)
    with pytest.raises(ValueError):
        ae_chunk.fused_ae_chunk(state, bad(batch), 2, spec, cfg)


def test_unit_omega_runs_match_jax_runner(tmp_path):
    """``runner.run`` on the AE preset at a small size, both packages from
    the same init (the JAX package's, carried across), through the eager
    loop and the kernel's plain chunk, omega_init=1 and lr_omega=1: the
    trace of the eager path to 1e-4 over 20 epochs and the plain chunk's
    to 2e-4 over the first 5; the relative error, the POD errors and the
    ``.pt`` keys."""
    base = dataclasses.replace(configs.get("ae_cylinder"), num_epochs=20, checkpoint_every=10,
                               omega_init=1.0, lr_omega=1.0, loss_method="factored")
    x = jsynthetic.cylinder_wake(120, 48)
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(base))
    ref = jrunner.run(jcfg, x, out_dir=str(tmp_path / "jax"), make_figures=False, echo=False)
    jinit = jae.init_params(jae.AESpec(120, 48, 2, 2, 1.0), seed=base.seed)
    carried = {k: np.asarray(v) for k, v in jinit.items()}
    orig = ae.init_params
    try:
        ae.init_params = lambda spec, seed=43, device="cpu": checkpoint.params_from_jax(carried, device)
        eager = runner.run(base, x, out_dir=str(tmp_path / "e"), echo=False, device="cpu")
        kern = runner.run(dataclasses.replace(base, chunk_method="megakernel"), x,
                          out_dir=str(tmp_path / "k"), echo=False, device="cpu")
    finally:
        ae.init_params = orig
    assert set(eager.history) == set(ref.history) == {"rec", "ortho", "l1", "ae", "total"}
    for key in ref.history:
        np.testing.assert_allclose(eager.history[key], ref.history[key], rtol=1e-4, atol=1e-9, err_msg=key)
        np.testing.assert_allclose(kern.history[key][:5], ref.history[key][:5], rtol=2e-4, atol=1e-9, err_msg=key)
    np.testing.assert_allclose(eager.relative_error, ref.relative_error, rtol=1e-4)
    np.testing.assert_allclose(eager.pod_error_2r, ref.pod_error_2r, rtol=1e-5)
    assert len(eager.sweep) == len(kern.sweep) == len(ref.sweep) == 14
    ref_pt = jckpt.load_pt(os.path.join(ref.out_dir, "ae_cylinder_r2_final.pt"))
    for art in (eager, kern):
        pt = jckpt.load_pt(os.path.join(art.out_dir, "ae_cylinder_r2_final.pt"))
        assert sorted(pt) == sorted(ref_pt)
        assert all(np.asarray(pt[k]).shape == np.asarray(ref_pt[k]).shape for k in ref_pt)


def test_recipe_matches_jax_runner(tmp_path):
    """``ae_recipe`` with a short warmup against the JAX runner's, both from
    the same live init: the warmup is the eager loop on the pure AE-MSE, so
    the data-scaled omega, the rescaled lr_omega and the first epochs of the
    joint fit agree."""
    base = dataclasses.replace(configs.get("ae_cylinder"), num_epochs=6, checkpoint_every=6, ae_recipe=True,
                               ae_warmup_epochs=5, loss_method="factored")
    x = jsynthetic.cylinder_wake(120, 48)
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(base))
    ref = jrunner.run(jcfg, x, out_dir=str(tmp_path / "jax"), make_figures=False, echo=False)
    jlive = jae.init_params_live(jae.AESpec(120, 48, 2, 2, base.omega_init), seed=base.seed)
    carried = {k: np.asarray(v) for k, v in jlive.items()}
    orig = ae.init_params_live
    try:
        ae.init_params_live = lambda spec, seed=43, bias=0.01, device="cpu": checkpoint.params_from_jax(carried, device)
        ours = runner.run(base, x, out_dir=str(tmp_path / "torch"), echo=False, device="cpu")
    finally:
        ae.init_params_live = orig
    assert ours.config.ae_beta == ref.config.ae_beta == 10.0 and ours.config.lr_z == 1e-3
    np.testing.assert_allclose(ours.config.lr_omega, ref.config.lr_omega, rtol=1e-4)
    for key in ref.history:
        np.testing.assert_allclose(ours.history[key][:3], ref.history[key][:3], rtol=2e-4, atol=1e-9, err_msg=key)


def test_cli_runs_the_ae_preset(tmp_path, capsys):
    """``run --preset ae_cylinder --synthetic --device cpu``, the eager loop
    and the kernel's plain chunk, each writing the reference's AE keys and an
    ``ae`` column; several seeds of the AE variant are refused, as the JAX
    package refuses them."""
    for method in ("auto", "megakernel"):
        out = tmp_path / method
        rc = cli.main(["run", "--preset", "ae_cylinder", "--synthetic", "--epochs", "3", "--device", "cpu",
                       "--chunk-method", method, "--out-dir", str(out)])
        assert rc == 0
        run_dir = out / "ae_cylinder"
        sd = torch.load(run_dir / "ae_cylinder_r2_final.pt", weights_only=True)
        assert ae.is_ae_state_dict(sd) and tuple(sd["temporal_ae.encoder.0.weight"].shape) == (256, 1001)
        assert "ae" in (run_dir / "ae_cylinder.csv").read_text().splitlines()[0].split(",")
    capsys.readouterr()
    with pytest.raises(ValueError, match="n_seeds"):
        runner.run(dataclasses.replace(configs.get("ae_cylinder"), n_seeds=2), np.zeros((8, 6), np.float32),
                   out_dir=str(tmp_path / "s"), echo=False, device="cpu")


EMULATION = Path(__file__).parent / "cuda_emulation" / "cooperative"


@pytest.fixture(scope="module")
def emulated_ae_chunk(tmp_path_factory):
    """``csrc/ae_chunk.cu`` compiled by the host C++ compiler against
    ``tests/cuda_emulation/cooperative`` with ``ae_harness.inc``: every
    block's threads run at once, ``this_grid().sync()`` is a barrier over
    all of them."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA source for the emulated grid")
    out = tmp_path_factory.mktemp("ae_chunk_emulated")
    cpp = out / "ae_chunk_emulated.cpp"
    cpp.write_text((_build.CSRC / "ae_chunk.cu").read_text() + '\n#include "ae_harness.inc"\n')
    exe = out / "ae_chunk_emulated"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-I", str(EMULATION), "-I", str(_build.CSRC), str(cpp), "-o",
         str(exe)],
        check=True, capture_output=True, timeout=240,
    )
    return exe


STATE_ARRAYS = ("mlp", "b", "coef", "omega", "svec")


def run_emulated(exe, tmp_path, state, batch, steps, spec, cfg, grid):
    """One chunk of the CUDA source on an emulated grid of ``grid`` blocks;
    returns the state arrays in the kernel layout and the metrics rows
    (steps, 6), by name."""
    cs = ae_chunk.pack(state)
    x = batch["x"].numpy()
    n, m = x.shape
    header = np.array([n, m, spec.poly_order, spec.num_poly_terms, steps, cfg.sched_every, grid], np.int32)
    floats = np.array([cfg.patience, cfg.sched_factor, cfg.sched_min_lr, cfg.beta, cfg.l1_lambda, cfg.ae_beta,
                       float(batch["x_sq"])], np.float32)
    arrays = [x, batch["x_colsum"].numpy(), spec.factor_table().astype(np.int32)]
    arrays += [getattr(cs, k).numpy() for k in STATE_ARRAYS]
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(header.tobytes() + floats.tobytes() + b"".join(np.ascontiguousarray(a).tobytes() for a in arrays))
    proc = subprocess.run([str(exe), str(src), str(dst)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = np.fromfile(dst, np.float32)
    shapes = {k: tuple(getattr(cs, k).shape) for k in STATE_ARRAYS}
    shapes["metrics"] = (steps, len(ae_chunk.METRICS))
    sizes = [int(np.prod(s)) for s in shapes.values()]
    assert out.size == sum(sizes)
    parts = np.split(out, np.cumsum(sizes)[:-1])
    return {k: p.reshape(s) for (k, s), p in zip(shapes.items(), parts)}


@pytest.mark.parametrize(
    "n, m, P, steps, patience, sched_every, grid",
    [
        # ten rows a block, a column slab per block; more column tasks than blocks
        pytest.param(40, 24, 2, 4, 300, 1, 4, id="40-24-2-4-300-1"),
        # K=16; 38 rows a block, two row tiles; ragged columns; LR drops
        pytest.param(150, 37, 3, 3, 1, 2, 4, id="150-37-3-3-1-2"),
        # the column jobs' row split: ragged row groups (phase 1: 3 of the
        # heavy jobs, 4 of the light; phase 2: 2 and 1), m = 2 mod 4 (X
        # padded to 72 floats a row), K=12, and blocks without rows (n = 300
        # over 56)
        (300, 70, 2, 2, 300, 1, 56),
    ],
)
def test_cuda_source_on_emulated_grid(emulated_ae_chunk, tmp_path, n, m, P, steps, patience, sched_every, grid):
    """Emulated blocks against the plain chunk from the live init with
    random library parameters and omega near 1. The same fp32 arithmetic in
    another summation order: each state array held to 2e-6 of its largest
    entry, each metric to 2e-6 of its own scale."""
    rng = np.random.default_rng(n)
    cfg = dataclasses.replace(configs.get("ae_cylinder"), n=n, m=m, poly_order=P, omega_init=1.0, lr_omega=1e-2,
                              lr_z=1e-3, lr_coef=1e-3, ae_beta=0.5, patience=patience, sched_every=sched_every)
    spec = ae.AESpec(n, m, 2, P, 1.0)
    xt = torch.as_tensor(rng.standard_normal((n, m)).astype(np.float32))
    batch = {"x": xt, "x_sq": torch.sum(xt * xt), "x_colsum": xt.sum(0)}
    params = ae.init_params_live(spec, seed=n)
    for k in ("c", "z", "z_trig", "c_trig"):
        params[k] = torch.as_tensor(rng.standard_normal(params[k].shape).astype(np.float32))
    params["omega"] = torch.as_tensor(rng.uniform(0.5, 1.5, (3, 2)).astype(np.float32))
    state = train.init_state(params, cfg)
    if patience == 1:
        state.sched = dataclasses.replace(state.sched, best=torch.tensor(0.0))
    got = run_emulated(emulated_ae_chunk, tmp_path, state, batch, steps, spec, cfg, grid=grid)
    ref_state, ref_m = ae_chunk.ae_chunk_plain(state, batch, steps, spec, cfg)
    want = {k: getattr(ae_chunk.pack(ref_state), k).numpy() for k in STATE_ARRAYS}
    want["metrics"] = torch.stack([ref_m[k] for k in ae_chunk.METRICS], dim=1).numpy()
    for name, g in got.items():
        assert np.isfinite(g).all(), name
        axis = 0 if name == "metrics" else None
        err, scale = np.abs(g - want[name]).max(axis=axis), np.abs(want[name]).max(axis=axis)
        assert np.all(err <= 2e-6 * scale), (name, err, scale)
    if patience == 1:
        assert got["svec"][0] < cfg.lr_coef  # the scheduler dropped the LRs
