"""The port's sharded training step: ``desmo_tpu_torch.kernels.shard_step``,
``desmo_tpu_torch.parallel``, ``runner.run(device_mesh=...)`` and
``run --mesh``.

- The sharded chunk at d=1 (in this process, a one-rank gloo group) and at
  d=2 and d=4 (gloo processes, ``tests/test_torch_shard_worker.py``, importing no
  jax) against ``desmo_tpu.pallas.shard_step.make_sharded_fused_chunk`` on
  the conftest's CPU mesh at the same d (interpret mode, as
  ``tests/test_shard_step.py`` runs it), desmo and Fourier, 25 steps, at that
  suite's problem and tolerances; a 10+10-step resume; phi stays row-local;
  the replicated state is bit-equal on every rank.
- ``step_partials_plain`` on uneven shards against the whole rows and a
  float64 reference, and the traps of the row split: ``dA`` normalised by
  the global n m, ``max_arg`` reduced with MAX before the SUM of the rest,
  the ortho term's sign from the summed latent Gram.
- ``supports_sharded`` against the reference's.
- ``runner.run`` and the CLI over a mesh, and what they refuse.
- The CUDA source (``csrc/shard_step.cu``) compiled by the host compiler and
  run on an emulated cooperative grid, whole and in uneven shards, against
  ``step_partials_plain``.

The CUDA kernel itself is held against its plain version on the card by
``tests/test_torch_gpu.py``.
"""

import dataclasses
import functools
import json
import os
import shutil
import socket
import subprocess
import sys
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
from desmo_tpu.pallas import shard_step as jshard  # noqa: E402
from desmo_tpu.pallas import train_chunk as jtc  # noqa: E402
from desmo_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from desmo_tpu_torch import checkpoint, configs, parallel, runner, train  # noqa: E402
from desmo_tpu_torch.__main__ import main as cli_main  # noqa: E402
from desmo_tpu_torch.io import synthetic  # noqa: E402
from desmo_tpu_torch.kernels import _build, shard_step, train_chunk  # noqa: E402
from desmo_tpu_torch.models import desmo, fourier  # noqa: E402

HERE = Path(__file__).resolve().parent
WORKER = HERE / "test_torch_shard_worker.py"
STEPS = 25


def problem(variant):
    """``tests/test_shard_step.py::problem`` (``fourier_problem`` for the
    Fourier form, nF=3): n=256, m=40, r=2, P=2, omega_init=1; the config,
    the data, the JAX package's POD modes and initial parameters (numpy)."""
    n, m, r, P = 256, 40, 2, 2
    cfg = configs.RunConfig(
        name="shard", variant="desmo", n=n, m=m, r=r, poly_order=P, omega_init=1.0, lr_omega=1.0,
        num_epochs=40, patience=300, sched_every=1, log_every=100, checkpoint_every=1000,
    )
    if variant == "fourier":
        cfg = dataclasses.replace(cfg, name="shard_f", variant="fourier", n_fourier=3, period_init=float(m))
    x = jsynthetic.separable_rank_k(n, m, k=r, seed=0)
    x -= x.mean(axis=1, keepdims=True)
    modes = np.asarray(jpod.pod(x, r).modes, np.float32)
    return cfg, x, modes, {k: np.asarray(v) for k, v in jax_spec_params(cfg)[1].items()}


def jax_spec_params(cfg):
    if cfg.variant == "fourier":
        spec = jfourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier,
                                    cfg.period_init)
        return spec, jfourier.init_params(spec)
    spec = jdesmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
    return spec, jdesmo.init_params(spec)


def port_spec(cfg):
    if cfg.variant == "fourier":
        return fourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier,
                                   cfg.period_init)
    return desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)


@functools.cache
def jax_sharded(variant, d, steps):
    """``steps`` steps of ``desmo_tpu``'s sharded chunk on a d-device CPU
    mesh (its megastep in interpret mode); state and metrics as numpy."""
    cfg, x, modes, _ = problem(variant)
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    spec, params = jax_spec_params(cfg)
    mesh = jmake_mesh(n_space=d, n_time=1, devices=jax.devices()[:d])
    chunk = jshard.make_sharded_fused_chunk(spec, jcfg, mesh, bt=16)
    state = jax.tree.map(jnp.array, jtrain.init_state(params, jcfg))
    with jax.sharding.set_mesh(mesh):
        state, mets = chunk(state, jtc.prepare_batch(x, modes, bt=16, n_mult=16 * d), num_steps=steps)
    return jax.tree.map(np.asarray, state), {k: np.asarray(v) for k, v in mets.items()}


def port_batch(x, modes):
    xt = torch.tensor(x)
    return {"x": xt, "x_sq": torch.sum(xt * xt), "pod_modes": torch.tensor(modes)}


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo mesh of this process."""
    return parallel.make_mesh(1, device="cpu")


def run_port_d1(variant, mesh, chunks):
    """The port's sharded chunk on the one-rank mesh from the JAX package's
    initial state (``checkpoint.state_from_jax``)."""
    cfg, x, modes, params = problem(variant)
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    state = checkpoint.state_from_jax(jax.tree.map(np.asarray, jtrain.init_state(params, jcfg)), "cpu")
    chunk = shard_step.make_sharded_fused_chunk(port_spec(cfg), cfg, mesh)
    batch = parallel.shard_batch(port_batch(x, modes), mesh)
    mets = []
    for steps in chunks:
        state, m = chunk(state, batch, steps)
        mets.append(m)
    return state, {k: torch.cat([m[k] for m in mets]).numpy() for k in mets[0]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ortho_problem():
    """One step whose ranks' latent Grams have the other sign than the
    summed one: at d=2 rank 0's rows have lat1 lat2 > 0, rank 1's a larger
    lat1 lat2 < 0. With c = 0 the rows' dl is 0, so phi's first Adamax step
    is lr_phi times the sign of its ortho term alone."""
    n, m, r = 64, 24, 2
    rng = np.random.default_rng(7)
    cfg = configs.RunConfig(name="ortho", variant="desmo", n=n, m=m, r=r, poly_order=2, omega_init=1.0,
                            lr_omega=1.0, patience=300, sched_every=1)
    a = 0.05 + 0.1 * rng.random((n, 1))
    modes = np.concatenate([a, np.where(np.arange(n)[:, None] < n // 2, 0.5 * a, -2.0 * a)], axis=1)
    params = {k: v.detach().numpy() for k, v in desmo.Desmo(port_spec(cfg)).params().items()}
    params["c"] = np.zeros_like(params["c"])
    params["c_trig"] = np.zeros_like(params["c_trig"])
    return cfg, rng.standard_normal((n, m)).astype(np.float32), modes.astype(np.float32), params


RUNNER_CFG = dict(r=2, poly_order=2, num_epochs=20, checkpoint_every=10, omega_init=1.0, lr_omega=1.0)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """``launch(d)``: the per-rank results of the worker tasks at d gloo
    processes (d=2: every task; d=4: the desmo and Fourier chunks), each d
    launched once."""
    tmp = tmp_path_factory.mktemp("shard_cluster")
    arrays = {}
    problems = {"desmo": problem("desmo"), "fourier": problem("fourier"), "ortho": ortho_problem()}
    for key, (cfg, x, modes, params) in problems.items():
        arrays[f"{key}/cfg"] = np.array(json.dumps(dataclasses.asdict(cfg)))
        arrays[f"{key}/x"], arrays[f"{key}/modes"] = x, modes
        arrays.update({f"{key}/params/{k}": v for k, v in params.items()})
    arrays["runner/cfg"] = np.array(json.dumps(dataclasses.asdict(
        dataclasses.replace(configs.get("cylinder"), **RUNNER_CFG))))
    arrays["runner/x"] = synthetic.cylinder_wake(201, 60)
    src = tmp / "in.npz"
    np.savez(src, **arrays)
    done = {}

    def launch(d):
        if d not in done:
            tasks = "desmo,fourier,resume,ortho,runner" if d == 2 else "desmo,fourier"
            out = tmp / f"d{d}"
            out.mkdir()
            env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(d),
                       OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join([str(HERE.parent)] + [os.environ.get("PYTHONPATH", "")]))
            procs = [subprocess.Popen([sys.executable, str(WORKER), str(src), str(out), tasks],
                                      env=dict(env, RANK=str(k), LOCAL_RANK=str(k)),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                     for k in range(d)]
            logs = []
            try:
                for p in procs:
                    logs.append(p.communicate(timeout=240)[0].decode(errors="replace"))
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            for p, log in zip(procs, logs):
                assert p.returncode == 0, log[-3000:]
            done[d] = [dict(np.load(out / f"rank{k}.npz")) for k in range(d)]
            done[(d, "dir")] = out
        return done[d]

    launch.dir = lambda d: done[(d, "dir")]
    return launch


def whole(ranks, key):
    """A row-sharded array from every rank, its rows joined in rank order."""
    return np.concatenate([r[key] for r in ranks], axis=-1)


def assert_matches_jax(params_of, mets, ref_state, ref_m, count_epoch):
    """The tolerances of ``tests/test_shard_step.py``: total and max_arg
    rtol 5e-4 atol 1e-6, params rtol 5e-4 atol 1e-5, LRs rtol 1e-6."""
    for key in ("total", "max_arg"):
        np.testing.assert_allclose(mets[key], ref_m[key], rtol=5e-4, atol=1e-6, err_msg=key)
    assert np.isfinite(mets["max_arg"]).all()
    for key, ref_v in ref_state.params.items():
        np.testing.assert_allclose(params_of(key), ref_v, rtol=5e-4, atol=1e-5, err_msg=key)
    assert tuple(count_epoch) == (STEPS, STEPS)


@pytest.mark.parametrize("variant", ["desmo", "fourier"])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_chunk_matches_jax_sharded_chunk(mesh1, clusters, variant, d):
    ref_state, ref_m = jax_sharded(variant, d, STEPS)
    if d == 1:
        state, mets = run_port_d1(variant, mesh1, [STEPS])
        assert_matches_jax(lambda k: state.params[k].numpy(), mets, ref_state, ref_m, (state.count, state.epoch))
        np.testing.assert_allclose(state.sched.lrs.numpy(), ref_state.sched.lrs, rtol=1e-6)
        return
    ranks = clusters(d)
    mets = {k: ranks[0][f"{variant}/metrics/{k}"] for k in train_chunk.METRICS}

    def params_of(key):
        return whole(ranks, f"{variant}/params/phi") if key == "phi" else ranks[0][f"{variant}/params/{key}"]

    assert_matches_jax(params_of, mets, ref_state, ref_m, ranks[0][f"{variant}/count_epoch"])
    np.testing.assert_allclose(ranks[0][f"{variant}/lrs"], ref_state.sched.lrs, rtol=1e-6)


@pytest.mark.parametrize("d", [2, 4])
def test_replicated_state_is_bit_equal_on_every_rank(clusters, d):
    """Everything but phi's rows comes from all-reduced sums and rank 0's
    broadcast only, so after 25 steps B, c, omega (and the series and
    periods), the LRs and the metrics are the same bits on every rank."""
    ranks = clusters(d)
    keys = [k for k in ranks[0] if k.split("/")[0] in ("desmo", "fourier") and "/phi" not in k]
    assert any(k.endswith("/params/z") for k in keys) and any(k.endswith("/params/period") for k in keys)
    for k in keys:
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("d", [2, 4])
def test_phi_stays_row_local(clusters, d):
    """Phi and its moments come out of the chunk as each rank's (r, n_loc) rows."""
    ranks = clusters(d)
    cfg = problem("desmo")[0]
    for k, rank in enumerate(ranks):
        lo, hi = parallel.row_range(cfg.n, d, k)
        for tree in ("params", "mu", "nu"):
            assert rank[f"desmo/{tree}/phi"].shape == (cfg.r, hi - lo) == (cfg.r, cfg.n // d)


def test_resume_matches_one_chunk(mesh1, clusters):
    """10 + 10 sharded steps against 20 (``test_sharded_resume_roundtrip``):
    at d=2 against one 20-step chunk tightly (the bias restarts from a fresh
    power, so to rounding) and against the JAX sharded chunk's 20 steps to
    the suite's bounds; at d=1 likewise."""
    ref_state, _ = jax_sharded("desmo", 2, 20)
    ranks = clusters(2)
    for key in ref_state.params:
        split = whole(ranks, f"split/params/{key}") if key == "phi" else ranks[0][f"split/params/{key}"]
        one = whole(ranks, f"whole/params/{key}") if key == "phi" else ranks[0][f"whole/params/{key}"]
        np.testing.assert_allclose(split, one, rtol=1e-5, atol=1e-7, err_msg=key)
        np.testing.assert_allclose(split, ref_state.params[key], rtol=5e-4, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(ranks[0]["split/metrics/total"], ranks[0]["whole/metrics/total"], rtol=1e-5)
    assert tuple(ranks[0]["split/count_epoch"]) == (20, 20)
    split, _ = run_port_d1("desmo", mesh1, [10, 10])
    for key in ref_state.params:
        np.testing.assert_allclose(split.params[key].numpy(), ref_state.params[key], rtol=5e-4, atol=1e-5,
                                   err_msg=key)


def test_ortho_sign_comes_from_the_summed_gram(mesh1, clusters):
    """Trap 3: the ranks' own latent Grams have the other off-diagonal sign
    than the summed one, and phi's first step (its ortho term alone) at
    d=2 equals the step at d=1."""
    cfg, x, modes, params = ortho_problem()
    lat_gram = [modes[rows].T @ modes[rows] for rows in (slice(0, 32), slice(32, 64))]
    assert lat_gram[0][0, 1] > 0 > lat_gram[1][0, 1] and (lat_gram[0] + lat_gram[1])[0, 1] < 0
    chunk = shard_step.make_sharded_fused_chunk(port_spec(cfg), cfg, mesh1)
    state = train.init_state(checkpoint.params_from_jax(params, "cpu"), cfg)
    one, _ = chunk(state, port_batch(x, modes), 1)
    ranks = clusters(2)
    phi = whole(ranks, "ortho/params/phi")
    moved = np.abs(phi - params["phi"])
    assert np.all(moved > 0.5 * cfg.lr_phi)  # every row took a step of about lr_phi
    np.testing.assert_allclose(phi, one.params["phi"].numpy(), rtol=0, atol=1e-7)


def test_max_arg_is_reduced_with_max_before_the_sum(mesh1):
    """Trap 2: each step's first all-reduce is max_arg's, with MAX; then one
    SUM of the other partials."""
    calls = []

    class Recording(parallel.SpaceMesh):
        def all_reduce(self, t, op="sum"):
            calls.append((op, t.numel()))
            return super().all_reduce(t, op)

    rec = Recording(mesh1.group, mesh1.rank, mesh1.size, mesh1.device)
    cfg, x, modes, params = problem("desmo")
    chunk = shard_step.make_sharded_fused_chunk(port_spec(cfg), cfg, rec)
    chunk(train.init_state(checkpoint.params_from_jax(params, "cpu"), cfg), port_batch(x, modes), 2)
    K = port_spec(cfg).num_poly_terms + 3 * cfg.r
    flat = K * cfg.m + K * K + cfg.r * cfg.r + K + 3 * cfg.r
    assert calls == [("max", 1), ("sum", flat)] * 2


def _random_inputs(n, m, r, P, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    spec = desmo.DesmoSpec(n, m, r, P, 1.0)
    K = spec.num_poly_terms + 3 * r

    def f(*shape, scale=1.0, offset=0.0):
        return torch.as_tensor((offset + scale * rng.standard_normal(shape)).astype(np.float32)).to(dtype)

    b = f(K, m, scale=0.5)
    return spec, (f(n, r, scale=0.3), f(n, m), f(r, n, scale=0.1, offset=1.0), b, b @ b.T, f(K, scale=0.5),
                  f(3 * r))


def _shards(args, bounds):
    pod, x, phi = args[:3]
    return [(pod[lo:hi].contiguous(), x[lo:hi].contiguous(), phi[:, lo:hi].contiguous()) + args[3:]
            for lo, hi in bounds]


def _bounds(n, d):
    return [parallel.row_range(n, d, k) for k in range(d)]


@pytest.mark.parametrize("n, m, r, P", [(256, 40, 2, 2), (101, 33, 4, 3)])
def test_step_partials_over_uneven_shards(n, m, r, P):
    """Three uneven shards, their partials summed and max taken, against the
    whole rows and against the float64 version, each part to 5e-6 of its
    largest entry; dl's rows are the whole call's. The whole-row call is no
    closer than that to float64 itself: its AᵀA is 2.3e-6 off at n=256
    (the summed shards 9.6e-7), so the two fp32 sums are held to each other
    on the float64 scale too."""
    spec, args = _random_inputs(n, m, r, P, seed=n)
    K = spec.num_poly_terms + 3 * r
    dl, flat, max_arg = shard_step.step_partials(*args, spec, n)
    parts = [shard_step.step_partials(*a, spec, n) for a in _shards(args, _bounds(n, 3))]
    assert [p[0].shape[0] for p in parts] == [n // 3 + (k < n % 3) for k in range(3)]
    summed = sum(p[1] for p in parts)
    ref64 = shard_step.step_partials_plain(*(a.double() for a in args), spec, n)
    for name, got, whole_v, ref in zip(("ax", "ga", "latg", "gcoef", "gomega"),
                                       shard_step.split_sums(summed, K, m, r), shard_step.split_sums(flat, K, m, r),
                                       shard_step.split_sums(ref64[1], K, m, r)):
        scale = float(ref.abs().max())
        assert float((got - whole_v).abs().max()) <= 5e-6 * scale, name
        assert float((got.double() - ref).abs().max()) <= 5e-6 * scale, name
        assert float((whole_v.double() - ref).abs().max()) <= 5e-6 * scale, name
    np.testing.assert_array_equal(torch.cat([p[0] for p in parts]).numpy(), dl.numpy())
    assert float((dl.double() - ref64[0]).abs().max()) <= 5e-6 * float(ref64[0].abs().max())
    assert max(float(p[2]) for p in parts) == float(max_arg)


def test_normalisation_is_by_the_global_row_count():
    """Trap 1: a shard's dl (and so its coefficient and omega partials) is
    the whole call's when normalised by the global n, and d times larger by
    the shard's own row count."""
    n, m, r, P = 96, 20, 2, 2
    spec, args = _random_inputs(n, m, r, P, seed=3)
    dl = shard_step.step_partials(*args, spec, n)[0]
    lo, hi = _bounds(n, 2)[1]
    shard = _shards(args, [(lo, hi)])[0]
    np.testing.assert_allclose(shard_step.step_partials(*shard, spec, n)[0].numpy(), dl[lo:hi].numpy(), rtol=1e-6)
    local = shard_step.step_partials(*shard, spec, hi - lo)[0]
    np.testing.assert_allclose(local.numpy(), 2.0 * dl[lo:hi].numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="n_total"):
        shard_step.step_partials(*args, spec, n - 1)


def test_wrapper_rejects_malformed_inputs_and_counts_no_cpu_launch():
    spec, args = _random_inputs(40, 12, 2, 2, seed=1)
    before = shard_step.step_partials.launches
    shard_step.step_partials(*args, spec, 40)
    assert shard_step.step_partials.launches == before == 0
    pod, x, phi, b, gb, c, om = args
    for bad in ((pod, x.double(), phi, b, gb, c, om), (pod, x, phi.T.contiguous().T, b, gb, c, om),
                (pod, x, phi, b[:-1], gb, c, om), (pod, x, phi, b, gb, c, om[:-1])):
        with pytest.raises(ValueError):
            shard_step.step_partials(*bad, spec, 40)


@pytest.mark.parametrize("r, P", [(2, 2), (4, 3), (4, 4), (8, 2), (8, 3), (9, 1)])
def test_supports_sharded_matches_jax(r, P):
    cfg = dataclasses.replace(configs.get("cylinder"), r=r, poly_order=P)
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    assert shard_step.supports_sharded(desmo.DesmoSpec(cfg.n, cfg.m, r, P), cfg) == jshard.supports_sharded(
        jdesmo.DesmoSpec(cfg.n, cfg.m, r, P), jcfg)


@pytest.mark.parametrize("nf", [0, 1, 10, 63, 64])
def test_fourier_supports_sharded_matches_jax(nf):
    cfg = dataclasses.replace(configs.get("fourier_cylinder"), n_fourier=nf)
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    spec = fourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, nf, cfg.period_init)
    jspec = jfourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, nf, cfg.period_init)
    assert shard_step.supports_sharded(spec, cfg) == jshard.supports_sharded(jspec, jcfg) == (1 <= nf <= 63)


def test_runner_over_a_mesh(mesh1, clusters, tmp_path):
    """``runner.run`` over a mesh at omega_init=1 on a small cylinder (n=201,
    uneven at d=2): at d=1 it is the mega-kernel's plain chunk run without a
    mesh to rounding, at d=2 within 5e-4 over all 20 epochs (ortho within
    1e-5 absolute: orthonormal POD modes start it at the rounding of their
    Gram, whose sign steers phi); rank 0 writes the exports, phi is whole
    again in the returned state."""
    cfg = dataclasses.replace(configs.get("cylinder"), **RUNNER_CFG)
    x = synthetic.cylinder_wake(201, 60)
    one = runner.run(cfg, x, out_dir=str(tmp_path / "d1"), echo=False, device="cpu", device_mesh=mesh1)
    ref = runner.run(dataclasses.replace(cfg, chunk_method="megakernel"), x, out_dir=str(tmp_path / "k"),
                     echo=False, device="cpu")
    ranks = clusters(2)
    for key in train.METRICS:
        np.testing.assert_allclose(one.history[key], ref.history[key], rtol=1e-6, atol=1e-9, err_msg=key)
        np.testing.assert_allclose(ranks[0][f"runner/history/{key}"], ref.history[key], rtol=5e-4,
                                   atol=1e-5 if key == "ortho" else 1e-7, err_msg=key)
    assert one.state.params["phi"].shape == (2, 201) == ranks[1]["runner/params/phi"].shape
    assert abs(float(ranks[0]["runner/relative_error"]) - ref.relative_error) <= 1e-3 * ref.relative_error
    for run_dir in (Path(one.out_dir), clusters.dir(2) / "runs" / "cylinder"):
        assert {"state_epoch10.npz", "state_final.npz", "cylinder_r2_final.pt", "cylinder.csv"} <= {
            p.name for p in run_dir.iterdir()}


def test_runner_at_the_preset_omega(mesh1, tmp_path):
    """At the preset's omega_init=1e4 the one-rank mesh run equals the
    mega-kernel's plain chunk run, epoch for epoch."""
    cfg = dataclasses.replace(configs.get("cylinder"), r=2, poly_order=2, num_epochs=12, checkpoint_every=6)
    x = synthetic.cylinder_wake(120, 40)
    one = runner.run(cfg, x, out_dir=str(tmp_path / "d1"), echo=False, device="cpu", device_mesh=mesh1)
    ref = runner.run(dataclasses.replace(cfg, chunk_method="megakernel"), x, out_dir=str(tmp_path / "k"),
                     echo=False, device="cpu")
    for key in train.METRICS:
        np.testing.assert_allclose(one.history[key], ref.history[key], rtol=1e-6, err_msg=key)


def test_cli_runs_over_a_mesh(mesh1, tmp_path, capsys):
    """``run --mesh space=1`` at full width on the CPU, to its exports."""
    argv = ["run", "--preset", "cylinder", "--synthetic", "--epochs", "3", "--device", "cpu",
            "--out-dir", str(tmp_path), "--mesh", "space=1"]
    assert cli_main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["mesh"] == "space=1" and np.isfinite(summary["relative_error"])
    assert {"cylinder_r4_final.pt", "state_final.npz"} <= set(os.listdir(tmp_path / "cylinder"))


@pytest.mark.parametrize(
    "extra, error, match",
    [
        (["--mesh", "space=1,time=2"], NotImplementedError, "time axis"),
        (["--mesh", "space=1", "--seeds", "2"], NotImplementedError, "packed sharded ensemble"),
        (["--mesh", "space=1", "--preset", "ae_cylinder"], NotImplementedError, "eager path over a mesh"),
        (["--mesh", "space=1", "--chunk-method", "scan"], NotImplementedError, "eager path over a mesh"),
        (["--mesh", "space=one"], SystemExit, "--mesh expects"),
    ],
    ids=["time", "seeds", "ae", "scan", "malformed"],
)
def test_cli_refuses_what_the_mesh_does_not_run(mesh1, tmp_path, extra, error, match):
    argv = ["run", "--preset", "cylinder", "--synthetic", "--epochs", "2", "--device", "cpu",
            "--out-dir", str(tmp_path)] + extra
    with pytest.raises(error, match=match):
        cli_main(argv)


def test_megakernel_on_an_unsupported_preset_raises(mesh1, tmp_path):
    cfg = dataclasses.replace(configs.get("cylinder"), r=8, poly_order=3, chunk_method="megakernel", num_epochs=2)
    with pytest.raises(ValueError, match="no sharded mega-kernel"):
        runner.run(cfg, synthetic.cylinder_wake(40, 20), out_dir=str(tmp_path), device="cpu", device_mesh=mesh1)


EMULATION = HERE / "cuda_emulation" / "cooperative"


@pytest.fixture(scope="module")
def emulated_shard_step(tmp_path_factory):
    """``csrc/shard_step.cu`` compiled by the host C++ compiler against
    ``tests/cuda_emulation/cooperative``: every block's threads run at once,
    ``this_grid().sync()`` is a barrier over all of them."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA source for the emulated grid")
    out = tmp_path_factory.mktemp("shard_step_emulated")
    cpp = out / "shard_step_emulated.cpp"
    cpp.write_text((_build.CSRC / "shard_step.cu").read_text() + '\n#include "shard_harness.inc"\n')
    exe = out / "shard_step_emulated"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-I", str(EMULATION), str(cpp), "-o", str(exe)],
                   check=True, capture_output=True, timeout=240)
    return exe


def run_emulated(exe, tmp_path, args, spec, n_total, grid):
    """One launch of the CUDA source on an emulated grid of ``grid`` blocks;
    returns ``(dl, flat, max_arg)`` as numpy."""
    pod, x = args[0], args[1]
    n, m = x.shape
    r, P, K = spec.r, spec.poly_order, spec.num_poly_terms + 3 * spec.r
    header = np.array([n, m, r, P, K, n_total, grid], np.int32)
    arrays = [a.numpy() for a in args] + [train_chunk.column_table(spec, 1)]
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(header.tobytes() + b"".join(np.ascontiguousarray(a).tobytes() for a in arrays))
    proc = subprocess.run([str(exe), str(src), str(dst)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = np.fromfile(dst, np.float32)
    assert out.size == n * r + K * m + K * K + r * r + K + 3 * r + 1
    return out[:n * r].reshape(n, r), out[n * r:-1], out[-1:]


@pytest.mark.parametrize(
    "n, m, r, P",
    [
        (96, 40, 2, 2),  # the JAX suite's r and P; two column sub-slabs per block
        (64, 24, 4, 3),  # the cylinder regime, K=47
        (37, 9, 2, 2),  # ragged rows, a block with no columns
        (40, 17, 5, 2),  # K=36: the kernel built for K <= 64
        (33, 12, 4, 4),  # K=82: the kernel built for K <= 128
    ],
)
def test_cuda_source_on_emulated_grid(emulated_shard_step, tmp_path, n, m, r, P):
    """Four emulated blocks over all rows, and three over each of three
    uneven shards with their partials summed, against the plain version:
    the same fp32 arithmetic in another summation order, each part held to
    2e-6 of its largest entry; max_arg exactly."""
    spec, args = _random_inputs(n, m, r, P, seed=n + m)
    K = spec.num_poly_terms + 3 * r
    ref = shard_step.step_partials_plain(*args, spec, n)
    got = run_emulated(emulated_shard_step, tmp_path, args, spec, n, grid=4)
    parts = [run_emulated(emulated_shard_step, tmp_path, a, spec, n, grid=3) for a in _shards(args, _bounds(n, 3))]
    summed = (np.concatenate([p[0] for p in parts]), sum(p[1] for p in parts), max(p[2] for p in parts))
    for dl, flat, max_arg in (got, summed):
        assert np.isfinite(flat).all() and np.isfinite(dl).all()
        assert np.abs(dl - ref[0].numpy()).max() <= 2e-6 * float(ref[0].abs().max())
        for name, g, w in zip(("ax", "ga", "latg", "gcoef", "gomega"),
                              shard_step.split_sums(torch.as_tensor(flat), K, m, r), shard_step.split_sums(ref[1], K, m, r)):
            assert float((g - w).abs().max()) <= 2e-6 * float(w.abs().max()), name
        assert float(max_arg[0]) == float(ref[2])
