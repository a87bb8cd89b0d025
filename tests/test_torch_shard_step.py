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
- Its packed form (``make_sharded_fused_ensemble_chunk``, S=3 seeds) the same
  way against the reference's at d=1, 2 and 4: desmo, Fourier with the
  periods m, m/2 and m/3, a hyperparameter sweep, and a NaN seed that stays
  in its own metrics; and ``runner.run`` with two seeds over d=2.
- ``step_partials_plain`` on uneven shards against the whole rows and a
  float64 reference, and the traps of the row split: ``dA`` normalised by
  the global n m, ``max_arg`` reduced with MAX (once a chunk, apart from
  the one SUM a step), the ortho term's sign from the summed latent Gram.
- The plain chunk (``step_plain``: the update of the previous step, then
  the partials) against the order the chunk had before the kernel took the
  update over (the partials, then the update), bit for bit.
- ``supports_sharded`` against the reference's.
- ``runner.run`` and the CLI over a mesh, and what they refuse.
- The CUDA source (``csrc/shard_step.cu``) compiled by the host compiler and
  run on an emulated cooperative grid, whole and in uneven shards, against
  ``step_plain``: the partials alone, the update of the previous step
  followed by the partials, and the update alone (``rows=False``), desmo
  and Fourier; and its routines marked as copies of ``csrc/train_chunk.cu``'s
  the same text as their counterparts there.

The CUDA kernel itself is held against its plain version on the card by
``tests/test_torch_gpu.py``.
"""

import dataclasses
import functools
import json
import os
import re
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
from desmo_tpu import ensemble as jens  # noqa: E402
from desmo_tpu import pod as jpod  # noqa: E402
from desmo_tpu import train as jtrain  # noqa: E402
from desmo_tpu.io import synthetic as jsynthetic  # noqa: E402
from desmo_tpu.models import desmo as jdesmo  # noqa: E402
from desmo_tpu.models import fourier as jfourier  # noqa: E402
from desmo_tpu.pallas import shard_step as jshard  # noqa: E402
from desmo_tpu.pallas import train_chunk as jtc  # noqa: E402
from desmo_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from desmo_tpu_torch import checkpoint, configs, ensemble, parallel, runner, train  # noqa: E402
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
    for case in ENSEMBLE_CASES:
        cfg, x, modes, params, hyp, steps = ensemble_problem(case)
        key = f"ens_{case}"
        arrays[f"{key}/cfg"] = np.array(json.dumps(dataclasses.asdict(cfg)))
        arrays[f"{key}/x"], arrays[f"{key}/modes"], arrays[f"{key}/steps"] = x, modes, np.array(steps)
        arrays.update({f"{key}/params/{k}": v for k, v in params.items()})
        arrays.update({f"{key}/{k}": v for k, v in hyp.items()})
    src = tmp / "in.npz"
    np.savez(src, **arrays)
    done = {}

    def launch(d):
        if d not in done:
            tasks = "desmo,fourier,resume,ortho,runner,ensemble,runner_seeds" if d == 2 else "desmo,fourier,ensemble"
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


ENSEMBLE_S = 3
ENSEMBLE_CASES = ("desmo", "fourier", "sweep", "nan")


def ensemble_problem(case):
    """``tests/test_shard_step.py``'s seed-packed problems: S=3 seeds of
    :func:`problem` from ``desmo_tpu.ensemble.init_params(seed=1,
    phi_sigma=0.1)`` (numpy); 'fourier' with the periods m, m/2 and m/3,
    'sweep' with per-seed betas, lambdas and LR scales, 'nan' with seed 1's
    phi NaN (2 steps). Returns ``(cfg, x, modes, params, hyp, steps)``."""
    cfg, x, modes, _ = problem("fourier" if case == "fourier" else "desmo")
    spec, _ = jax_spec_params(cfg)
    periods = [float(cfg.m), cfg.m / 2.0, cfg.m / 3.0] if case == "fourier" else None
    params = {k: np.array(v) for k, v in jens.init_params(spec, ENSEMBLE_S, seed=1, phi_sigma=0.1,
                                                          periods=periods).items()}
    if case == "nan":
        params["phi"][1] = np.nan
    hyp = {}
    if case == "sweep":
        hyp = {"betas": np.array([1e-3, 5e-3, 1e-2], np.float32), "lams": np.array([1e-4, 1e-5, 1e-3], np.float32),
               "lr_scales": np.array([1.0, 0.5, 2.0], np.float32)}
    return cfg, x, modes, params, hyp, 2 if case == "nan" else STEPS


@functools.cache
def jax_sharded_ensemble(case, d):
    """``desmo_tpu``'s sharded seed-packed chunk on a d-device CPU mesh (its
    megastep in interpret mode) over :func:`ensemble_problem`; state and
    metrics as numpy."""
    cfg, x, modes, params, hyp, steps = ensemble_problem(case)
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    spec, _ = jax_spec_params(cfg)
    mesh = jmake_mesh(n_space=d, n_time=1, devices=jax.devices()[:d])
    chunk = jshard.make_sharded_fused_ensemble_chunk(spec, jcfg, mesh, ENSEMBLE_S, bt=16, betas=hyp.get("betas"),
                                                     lams=hyp.get("lams"))
    state = jax.tree.map(jnp.array, jens.init_state({k: jnp.asarray(v) for k, v in params.items()}, jcfg,
                                                    ENSEMBLE_S, lr_scales=hyp.get("lr_scales")))
    with jax.sharding.set_mesh(mesh):
        state, mets = chunk(state, jtc.prepare_batch(x, modes, bt=16, n_mult=16 * d), num_steps=steps)
    return jax.tree.map(np.asarray, state), {k: np.asarray(v) for k, v in mets.items()}


def run_port_ensemble_d1(case, mesh):
    """The port's sharded packed chunk on the one-rank mesh over
    :func:`ensemble_problem` (``ensemble.init_state`` of the JAX package's
    initial parameters)."""
    cfg, x, modes, params, hyp, steps = ensemble_problem(case)
    state = ensemble.init_state(checkpoint.params_from_jax(params, "cpu"), cfg, ENSEMBLE_S,
                                lr_scales=hyp.get("lr_scales"))
    chunk = shard_step.make_sharded_fused_ensemble_chunk(port_spec(cfg), cfg, mesh, ENSEMBLE_S,
                                                         betas=hyp.get("betas"), lams=hyp.get("lams"))
    state, mets = chunk(parallel.local_state(state, mesh), parallel.shard_batch(port_batch(x, modes), mesh), steps)
    return state, {k: v.numpy() for k, v in mets.items()}


@pytest.mark.parametrize("case", ENSEMBLE_CASES)
@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_ensemble_matches_jax_sharded_ensemble(mesh1, clusters, case, d):
    """The sharded packed chunk against ``desmo_tpu``'s at the same d, to
    ``tests/test_shard_step.py``'s tolerances: total_s and max_arg rtol 5e-4
    atol 1e-6, params rtol 5e-4 atol 1e-5, the per-seed LRs rtol 1e-6, count
    and epoch equal. The NaN seed: at step 0 seed 1's rec, ortho and total_s
    are not finite, and seeds 0 and 2 match the reference's; the port keeps
    seeds 0 and 2 finite at every step, their metrics the bits of the same
    seeds' run without the NaN (the reference's update lets the NaN reach
    every seed from step 1 on, through its masked cross-seed products)."""
    ref_state, ref_m = jax_sharded_ensemble(case, d)
    if d == 1:
        state, mets = run_port_ensemble_d1(case, mesh1)
        params = {k: v.numpy() for k, v in state.params.items()}
        lrs, count_epoch = state.sched.lrs.numpy(), (state.count, state.epoch)
    else:
        ranks = clusters(d)
        key = f"ens_{case}"
        mets = {k: ranks[0][f"{key}/metrics/{k}"] for k in ("rec", "ortho", "l1", "total_s", "total", "max_arg")}
        params = {k: whole(ranks, f"{key}/params/{k}") if k == "phi" else ranks[0][f"{key}/params/{k}"]
                  for k in ref_state.params}
        lrs, count_epoch = ranks[0][f"{key}/lrs"], ranks[0][f"{key}/count_epoch"]
        assert params["phi"].shape == ref_state.params["phi"].shape
    steps = ensemble_problem(case)[5]
    assert tuple(count_epoch) == (steps, steps)
    if case == "nan":
        for key in ("rec", "ortho", "total_s"):
            assert not np.isfinite(mets[key][0, 1]) and not np.isfinite(ref_m[key][0, 1]), key
            np.testing.assert_allclose(mets[key][0, [0, 2]], ref_m[key][0, [0, 2]], rtol=5e-4, atol=1e-6, err_msg=key)
            assert np.isfinite(mets[key][:, [0, 2]]).all(), key
        clean = run_port_ensemble_d1("desmo", mesh1)[1] if d == 1 else {
            k: clusters(d)[0][f"ens_desmo/metrics/{k}"] for k in ("rec", "total_s")}
        for key in ("rec", "total_s"):
            np.testing.assert_array_equal(mets[key][:, [0, 2]], clean[key][:steps, [0, 2]], err_msg=key)
        return
    for key in ("total_s", "max_arg"):
        np.testing.assert_allclose(mets[key], ref_m[key], rtol=5e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(mets["total"], mets["total_s"].sum(1), rtol=1e-6)
    for key, ref_v in ref_state.params.items():
        np.testing.assert_allclose(params[key], ref_v, rtol=5e-4, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(lrs, ref_state.sched.lrs, rtol=1e-6)


@pytest.mark.parametrize("d", [2, 4])
def test_replicated_state_is_bit_equal_on_every_rank(clusters, d):
    """Everything but phi's rows comes from all-reduced sums and rank 0's
    broadcast only, so after 25 steps B, c, omega (and the series and
    periods), the LRs and the metrics are the same bits on every rank."""
    ranks = clusters(d)
    keys = [k for k in ranks[0] if (k.split("/")[0] in ("desmo", "fourier") or k.startswith("ens_"))
            and "/phi" not in k]
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
    """Trap 2: max_arg is a max over the ranks, never part of the SUM: each
    step makes one SUM all-reduce of its partials, and the chunk one MAX
    all-reduce of its (num_steps,) max_arg rows at its end (the values of
    the reference's per-step pmax)."""
    calls = []

    class Recording(parallel.SpaceMesh):
        def all_reduce(self, t, op="sum"):
            calls.append((op, t.numel()))
            return super().all_reduce(t, op)

    rec = Recording(mesh1.group, mesh1.rank, mesh1.size, mesh1.device)
    cfg, x, modes, params = problem("desmo")
    chunk = shard_step.make_sharded_fused_chunk(port_spec(cfg), cfg, rec)
    _, mets = chunk(train.init_state(checkpoint.params_from_jax(params, "cpu"), cfg), port_batch(x, modes), 2)
    K = port_spec(cfg).num_poly_terms + 3 * cfg.r
    flat = K * cfg.m + K * K + cfg.r * cfg.r + K + 3 * cfg.r
    assert calls == [("sum", flat)] * 2 + [("max", 2)]
    assert mets["max_arg"].shape == (2,) and bool((mets["max_arg"] > 0).all())


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
    before = shard_step.step.launches
    shard_step.step_partials(*args, spec, 40)
    assert shard_step.step.launches == before == 0
    pod, x, phi, b, gb, c, om = args
    for bad in ((pod, x.double(), phi, b, gb, c, om), (pod, x, phi.T.contiguous().T, b, gb, c, om),
                (pod, x, phi, b[:-1], gb, c, om), (pod, x, phi, b, gb, c, om[:-1])):
        with pytest.raises(ValueError):
            shard_step.step_partials(*bad, spec, 40)


def test_clock_and_phase_split_need_the_card():
    """The kernel's clock lives in the card's scratch: ``clock`` on buffers
    the plain version uses, and ``phase_split`` on CPU tensors, raise."""
    spec, cfg, cs, batch = emulated_state(24, 8, 2, 2, 0, seed=3)
    buf = shard_step.make_buffers(cs, batch, 2, spec, cfg, 24)
    with pytest.raises(ValueError, match="needs the card's buffers"):
        shard_step.clock(buf, spec)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        shard_step.phase_split(spec, cfg, None, None, batch, 2)


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


def test_runner_with_seeds_over_a_mesh(mesh1, clusters, tmp_path):
    """``runner.run`` with two seeds over a mesh (``ensemble.fit`` through
    the sharded packed chunk) at omega_init=1: at d=1 the packed
    mega-kernel's plain chunk run without a mesh to rounding, at d=2 within
    5e-4 (ortho 1e-5 absolute, as :func:`test_runner_over_a_mesh`); rank 0
    alone writes ``ensemble.json``, ``term_stability.json`` and the exports,
    and the kept seed's phi comes back whole."""
    cfg = dataclasses.replace(configs.get("cylinder"), **RUNNER_CFG, n_seeds=2)
    x = synthetic.cylinder_wake(201, 60)
    one = runner.run(cfg, x, out_dir=str(tmp_path / "d1"), echo=False, device="cpu", device_mesh=mesh1)
    ref = runner.run(dataclasses.replace(cfg, chunk_method="megakernel"), x, out_dir=str(tmp_path / "k"),
                     echo=False, device="cpu")
    ranks = clusters(2)
    for key in train.METRICS[:4]:
        np.testing.assert_allclose(one.history[key], ref.history[key], rtol=1e-5, atol=1e-9, err_msg=key)
        np.testing.assert_allclose(ranks[0][f"runner_seeds/history/{key}"], ref.history[key], rtol=5e-4,
                                   atol=1e-5 if key == "ortho" else 1e-7, err_msg=key)
    assert one.state.params["phi"].shape == (2, 201) == ranks[1]["runner_seeds/params/phi"].shape
    np.testing.assert_array_equal(ranks[1]["runner_seeds/params/phi"], ranks[0]["runner_seeds/params/phi"])
    for run_dir in (Path(one.out_dir), clusters.dir(2) / "runs_seeds" / "cylinder"):
        with open(run_dir / "ensemble.json") as fh:
            report = json.load(fh)
        assert report["n_seeds"] == 2 and report["best_seed"] in (0, 1)
        assert {"term_stability.json", "state_epoch10.npz", "state_final.npz", "cylinder_r2_final.pt"} <= {
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
        (["--mesh", "space=1", "--seeds", "2", "--chunk-method", "scan"], NotImplementedError, "item 5.2"),
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


def pre_kernel_order_chunk(spec, cfg, mesh, state, batch, num_steps):
    """The sharded chunk in the order it ran before the step kernel took the
    replicated update over: each step's partials (the plain version), then
    max_arg all-reduced with MAX and the partials with SUM, then the update,
    with PyTorch operations on the host."""
    from desmo_tpu_torch.kernels._chunk_optim import _BETA, _LAM, _LR0, _POW, B1, _adamax_, sched_step_

    nf = train_chunk.n_fourier(spec, cfg)
    r = spec.r
    K = spec.num_poly_terms + 3 * r
    n, m = spec.n, spec.m
    nm = float(n * m)
    x, pod, x_sq = batch["x"], batch["pod_modes"], batch["x_sq"]
    stacked = train_chunk.stack_seed(state)
    cs = train_chunk.pack_seeds(stacked, [cfg.beta], [cfg.l1_lambda])
    phi, phi_mu, phi_nu = cs.phi.unbind(0)
    if nf:
        zc, zc_mu, zc_nu = cs.series.unbind(0)
        per, per_mu, per_nu = cs.periods.unbind(0)
        tw = torch.as_tensor(fourier.TWO_PI * fourier.t_points(m), device=x.device)
    else:
        bm, b_mu, b_nu = cs.b.unbind(0)
    c, c_mu, c_nu = cs.coef.unbind(0)
    om, om_mu, om_nu = cs.omega.unbind(0)
    sv = cs.svec
    beta, lam = sv[0, _BETA], sv[0, _LAM]
    offdiag = 1.0 - torch.eye(r, dtype=torch.float32, device=x.device)
    rows, maxargs = [], []
    for _ in range(num_steps):
        if nf:
            bm, harmonics, th_b = train_chunk.series_forward(zc, per, tw)
        gb = bm @ bm.T
        dl, flat, max_arg = shard_step.step_partials_plain(pod, x, phi, bm, gb, c, om, spec, n)
        mesh.all_reduce(max_arg, "max")
        mesh.all_reduce(flat, "sum")
        ax, ga, latg, gcoef, gomega = shard_step.split_sums(flat, K, m, r)
        rec = (torch.sum(ga * gb) - 2.0 * torch.sum(ax * bm) + x_sq) / nm
        ortho = 0.5 * torch.sum(torch.abs(latg * offdiag))
        l1 = torch.sum(torch.abs(c))
        total = rec + beta * ortho + lam * l1
        rows.append(torch.stack([rec, ortho, l1, total]))
        maxargs.append(max_arg)
        lat = pod * phi.T
        g_phi = ((dl + beta * (lat @ (torch.sign(latg) * offdiag))) * pod).T
        g_coef = gcoef + lam * torch.sign(c)
        g_b = (2.0 / nm) * (ga @ bm - ax)
        bias = 1.0 - sv[0, _POW] * B1
        lrs = sv[0, _LR0:_LR0 + 5].clone()
        _adamax_(c, c_mu, c_nu, g_coef, lrs[0], bias)
        _adamax_(phi, phi_mu, phi_nu, g_phi, lrs[1], bias)
        if nf:
            g_zc, g_per = train_chunk.series_backward(g_b, zc, per, harmonics, th_b)
            _adamax_(zc, zc_mu, zc_nu, g_zc, lrs[2], bias)
            _adamax_(per, per_mu, per_nu, g_per, lrs[4], bias)
        else:
            _adamax_(bm, b_mu, b_nu, g_b, lrs[2], bias)
        _adamax_(om, om_mu, om_nu, gomega, lrs[3], bias)
        sched_step_(sv, total.reshape(1), cfg)
    out = train_chunk.seed_view(train_chunk.unpack_seeds(cs, stacked, num_steps), 0)
    mets = torch.stack(rows)
    metrics = {k: mets[:, i] for i, k in enumerate(train_chunk.METRICS[:4])}
    metrics["max_arg"] = torch.cat(maxargs)
    return out, metrics


@pytest.mark.parametrize("variant", ["desmo", "fourier"])
def test_plain_chunk_equals_the_pre_kernel_order(mesh1, variant):
    """The chunk's plain path, each launch the update of the previous step
    and then the partials (``step_plain``), one SUM a step and one MAX a
    chunk, equals the order it had before (each step's partials, MAX and
    SUM, then the update) bit for bit: state, metrics and scheduler, over a
    12-step chunk in which the scheduler cuts the LRs."""
    cfg, x, modes, params = problem(variant)
    cfg = dataclasses.replace(cfg, patience=2)
    spec = port_spec(cfg)
    state = train.init_state(checkpoint.params_from_jax(params, "cpu"), cfg)
    # best below any total: the scheduler counts bad epochs and cuts the LRs
    state = dataclasses.replace(state, sched=dataclasses.replace(state.sched, best=torch.tensor(0.0)))
    got, got_m = shard_step.make_sharded_fused_chunk(spec, cfg, mesh1)(state, port_batch(x, modes), 12)
    want, want_m = pre_kernel_order_chunk(spec, cfg, mesh1, state, port_batch(x, modes), 12)
    for tree in ("params", "mu", "nu"):
        for key, v in getattr(want, tree).items():
            np.testing.assert_array_equal(getattr(got, tree)[key].numpy(), v.numpy(), err_msg=f"{tree}/{key}")
    for key in train_chunk.METRICS:
        np.testing.assert_array_equal(got_m[key].numpy(), want_m[key].numpy(), err_msg=key)
    for key in ("lrs", "best", "num_bad"):
        np.testing.assert_array_equal(getattr(got.sched, key).numpy(), getattr(want.sched, key).numpy(), err_msg=key)
    assert (got.count, got.epoch) == (want.count, want.epoch) == (12, 12)
    assert bool((want.sched.lrs < state.sched.lrs).any())  # the plateau scheduler stepped the LRs


@pytest.mark.parametrize("r, P", [(2, 2), (4, 3), (4, 4), (5, 2)])
def test_kernel_table_lists_each_lanes_factors(r, P):
    """The step kernel's table: the one-seed column table, then for each
    latent lane j the entries k P + p (ascending) whose factor p of a
    polynomial column k is lane j + 1, which the polynomial backward walks;
    every factor that is not the constant lane 0 is listed once."""
    spec = desmo.DesmoSpec(40, 12, r, P, 1.0)
    ct = train_chunk.column_table(spec, 1)
    K, T = ct.shape[0], spec.num_poly_terms
    table = shard_step.kernel_table(spec)
    assert table.dtype == np.int32 and table.shape == (ct.size + r + 1 + K * P,)
    np.testing.assert_array_equal(table[:ct.size], ct.reshape(-1))
    d_off, d_tp = table[ct.size:ct.size + r + 1], table[ct.size + r + 1:]
    for j in range(r):
        entries = d_tp[d_off[j]:d_off[j + 1]]
        assert list(entries) == sorted(entries)
        assert all(ct[e // P, 4 + e % P] == j + 1 and e // P < T for e in entries)
    assert d_off[r] == int((ct[:T, 4:] > 0).sum())


def cuda_definition(src: str, name: str) -> str:
    """The top-level definition of the constant, function or struct ``name``
    in a CUDA source, a function's template line included, without comments
    and with each run of whitespace one space."""
    constant = re.search(rf"^constexpr int {name} = [^;]*;", src, re.M)
    if constant:
        return re.sub(r"\s+", " ", constant.group(0))
    found = re.search(rf"^(?:template <[^\n]*>\n)?(?:struct {name}\b|[A-Za-z_][^\n(;]*\b{name}\s*\()", src, re.M)
    assert found, f"no definition of {name}"
    depth, end = 0, src.index("{", found.end())
    for end in range(end, len(src)):
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        if depth == 0:
            break
    return re.sub(r"\s+", " ", re.sub(r"//[^\n]*", "", src[found.start():end + 1])).strip()


# the step kernel's routines that copy the mega-kernel's unchanged (the
# others take the step's own phases, buffers or launch-wide hyperparameters)
VERBATIM_COPIES = (
    "kXbGroups", "kXbSplit", "kXbChunk", "kXbLd", "xb_stages", "xb_ring_floats", "xb_tile", "kMaxTiles", "kAxRows",
    "kAxLdX", "kAxTilesN", "kAxMaxWidth", "ax_ld_a", "ax_ring_floats", "AxSplit", "ax_split", "ax_partial",
    "ax_partials", "adamax", "block_sum", "block_max", "reduce_partials", "series_angle", "series_value",
    "series_partial", "store_series", "kMaxSeeds", "series_update", "valid_shape",
)


@pytest.mark.parametrize("name", VERBATIM_COPIES)
def test_step_kernel_copies_the_mega_kernels_routine(name):
    """Each routine of ``csrc/shard_step.cu`` that copies its counterpart in
    ``csrc/train_chunk.cu`` unchanged is marked so there and has the same
    text, comments and spacing aside: the sharded chunk equals the
    mega-kernel bit for bit on one rank only while the copies stay the
    same."""
    step_src = (_build.CSRC / "shard_step.cu").read_text()
    chunk_src = (_build.CSRC / "train_chunk.cu").read_text()
    marked = rf"as train_chunk\.cu(?:[^\n]*\n//)*?[^\n]*\b{name}\b"  # in the comment that starts so
    assert re.search(marked, step_src), f"{name} is not marked as a copy"
    assert cuda_definition(step_src, name) == cuda_definition(chunk_src, name)


EMULATION = HERE / "cuda_emulation" / "cooperative"


@pytest.fixture(scope="module")
def emulated_shard_step(tmp_path_factory):
    """``csrc/shard_step.cu`` compiled by the host C++ compiler against
    ``tests/cuda_emulation/cooperative``: every block's threads run at once,
    ``this_grid().sync()`` is a barrier over all of them; the tile headers
    from ``desmo_tpu_torch/csrc``, ``cp.async`` and ``mma.sync`` from
    ``tests/cuda_emulation/mma_emulated.h``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA source for the emulated grid")
    out = tmp_path_factory.mktemp("shard_step_emulated")
    cpp = out / "shard_step_emulated.cpp"
    cpp.write_text((_build.CSRC / "shard_step.cu").read_text() + '\n#include "shard_harness.inc"\n')
    exe = out / "shard_step_emulated"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-I", str(EMULATION), "-I", str(_build.CSRC), str(cpp),
                    "-o", str(exe)], check=True, capture_output=True, timeout=240)
    return exe


def emulated_state(n, m, r, P, nf, seed, n_seeds=1):
    """A state of S = ``n_seeds`` packed seeds with Adamax moments under
    way, its schedulers set to cut the LRs at the next step (patience 0, best
    below any total), each seed with its own LRs, beta and lambda, and a
    batch, all float32 from numpy's generator: ``(spec, cfg, cs, batch)``."""
    from desmo_tpu_torch.kernels._chunk_optim import B1, SVEC

    rng = np.random.default_rng(seed)
    spec = fourier.FourierSpec(n, m, r, P, 1.0, nf, float(m)) if nf else desmo.DesmoSpec(n, m, r, P, 1.0)
    S = n_seeds
    K = S * (spec.num_poly_terms + 3 * r)

    def f(*shape, scale=1.0, offset=0.0):
        return torch.as_tensor((offset + scale * rng.standard_normal(shape)).astype(np.float32))

    def moments(t):
        return torch.stack([t, 0.01 * t.abs(), 0.1 + t.abs()]).contiguous()

    temporal = (dict(series=moments(f(K, 2 * nf + 1, scale=0.3)), periods=moments(m * (1.0 + 0.2 * f(K).abs())))
                if nf else dict(b=moments(f(K, m, scale=0.5))))
    cfg = configs.RunConfig(name="emulated", variant="fourier" if nf else "desmo", n=n, m=m, r=r, poly_order=P,
                            patience=0, sched_every=1)
    svec = torch.zeros((S, SVEC))
    for q in range(S):  # seed q's LRs, beta and lambda (1 + q/2) times seed 0's
        svec[q, :5] = (1.0 + 0.5 * q) * torch.tensor([1e-3, 2e-3, 3e-3, 4e-3, 5e-3])
        svec[q, 5:12] = torch.tensor([-1.0, B1 ** 3, 3.0, 0.0, 3.0, 0.5 * (1.0 + 0.5 * q), 1e-3 * (1.0 + 0.5 * q)])
    # best, b1^count, count, num_bad, epoch, beta, lam
    cs = train_chunk.ChunkState(phi=moments(f(S * r, n, scale=0.1, offset=1.0)), coef=moments(f(K, scale=0.5)),
                                omega=moments(f(3 * S * r)), svec=svec, **temporal)
    x = f(n, m)
    return spec, cfg, cs, {"x": x, "pod_modes": f(n, r, scale=0.3), "x_sq": torch.sum(x * x)}


def run_emulated(exe, tmp_path, buf, spec, grid, rows=True):
    """One launch of the CUDA source on an emulated grid of ``grid`` blocks
    from the CPU buffers ``buf`` (``shard_step.StepBuffers``, float32);
    returns a new ``StepBuffers`` holding what the launch left."""
    out = buf.to("cpu", torch.float32)
    cs, cfg = out.cs, out.cfg
    n, m = buf.x.shape
    r, P, K = spec.r, spec.poly_order, spec.num_poly_terms + 3 * spec.r
    header = np.array([n, m, r, P, K, buf.seeds, buf.n_total, grid, buf.nf, buf.met.shape[0], int(rows),
                       cfg.sched_every], np.int32)
    floats = np.array([cfg.patience, cfg.sched_factor, cfg.sched_min_lr, float(buf.x_sq)], np.float32)
    state = [cs.phi] + ([cs.series, cs.periods] if buf.nf else [cs.b])
    tail = [cs.coef, cs.omega, cs.svec, out.sums, out.dl, out.gb, out.met, out.max_arg]
    inputs = ([out.pod, out.x, torch.as_tensor(shard_step.kernel_table(spec, buf.seeds)), cs.phi]
              + ([torch.as_tensor(fourier.t_points(m)), cs.series, cs.periods] if buf.nf else [cs.b])
              + tail + [out.count])
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(header.tobytes() + floats.tobytes() + b"".join(t.numpy().tobytes() for t in inputs))
    proc = subprocess.run([str(exe), str(src), str(dst)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    raw = np.fromfile(dst, np.float32)
    o = 0
    for t in state + tail:
        t.copy_(torch.from_numpy(raw[o:o + t.numel()].copy()).view(t.shape))
        o += t.numel()
    assert raw.size == o + 1
    out.count.copy_(torch.from_numpy(raw[o:].view(np.int32).copy()))
    return out


def shard_of(buf, lo, hi):
    """Rows [lo, hi) of the buffers, as a rank holding them would: its rows
    of X, the POD modes, phi with its moments and dl; the rest copied."""
    out = buf.to("cpu", torch.float32)
    out.cs.phi = out.cs.phi[:, :, lo:hi].contiguous()
    out.pod, out.x, out.dl = out.pod[lo:hi].contiguous(), out.x[lo:hi].contiguous(), out.dl[lo:hi].contiguous()
    return out


def temporal_state(buf):
    return [buf.cs.series, buf.cs.periods] if buf.nf else [buf.cs.b]


def assert_close(got, want, rtol, what):
    """Each part of ``got`` within ``rtol`` of the largest entry of its ``want``."""
    for name, g, w in zip(what, got, want):
        assert float((g.double() - w.double()).abs().max()) <= rtol * float(w.abs().max()), name


def check_emulated_step(exe, tmp_path, spec, cfg, cs, batch):
    """The CUDA source on emulated grids against ``step_plain``, each part to
    2e-6 of its largest entry (the same fp32 arithmetic in another
    summation order), max_arg exactly: four blocks over all rows, and three
    over each of three uneven shards (partials summed as the ranks' SUM
    would sum them), for the partials alone from the state (counter 0),
    then the update of that step followed by the next partials (counter 1),
    and over all rows the update alone (``rows=False``). The replicated
    state that the shards' launches leave is the same bits in each."""
    n, m = batch["x"].shape
    r, K = spec.r, spec.num_poly_terms + 3 * spec.r
    buf = shard_step.make_buffers(cs, batch, 2, spec, cfg, n)
    S = buf.seeds
    bounds = _bounds(n, 3)
    sums_names = ("ax", "ga", "latg", "gcoef", "gomega")
    first = buf.to("cpu", torch.float32)
    shard_step.step_plain(first, spec)
    second = first.to("cpu", torch.float32)
    shard_step.step_plain(second, spec)
    for start, ref in ((buf, first), (first, second)):
        whole_run = run_emulated(exe, tmp_path, start, spec, grid=4)
        parts = [run_emulated(exe, tmp_path, shard_of(start, lo, hi), spec, grid=3) for lo, hi in bounds]
        s = int(start.count)
        summed = (torch.cat([p.dl for p in parts]), sum(p.sums for p in parts),
                  max(float(p.max_arg[s]) for p in parts), torch.cat([p.cs.phi for p in parts], dim=2))
        for dl, sums, max_arg, phi in ((whole_run.dl, whole_run.sums, float(whole_run.max_arg[s]), whole_run.cs.phi),
                                       summed):
            assert bool(torch.isfinite(sums).all()) and bool(torch.isfinite(dl).all())
            assert_close([dl, phi[0], phi[1], phi[2]], [ref.dl, ref.cs.phi[0], ref.cs.phi[1], ref.cs.phi[2]], 2e-6,
                         ("dl", "phi", "phi_mu", "phi_nu"))
            assert_close(shard_step.split_seed_sums(sums, K, m, r, S), shard_step.split_seed_sums(ref.sums, K, m, r, S),
                         2e-6, sums_names)
            assert max_arg == float(ref.max_arg[s])
        replicated = [whole_run] + parts
        for run in replicated:
            assert int(run.count) == s + 1
            assert_close([run.gb], [ref.gb], 2e-6, ["gb"])
            state = [run.cs.coef, run.cs.omega] + temporal_state(run)
            assert_close([t[i] for t in state for i in range(3)], [t[i] for t in [ref.cs.coef, ref.cs.omega]
                                                                   + temporal_state(ref) for i in range(3)],
                         2e-6, [f"state {k}" for k in range(3 * len(state))])
            np.testing.assert_allclose(run.cs.svec.numpy(), ref.cs.svec.numpy(), rtol=2e-6)
            if s:
                np.testing.assert_allclose(run.met[s - 1].numpy(), ref.met[s - 1].numpy(), rtol=2e-6, atol=1e-12)
        for run in parts:
            for got, want in ((run.cs.coef, parts[0].cs.coef), (run.cs.omega, parts[0].cs.omega),
                              (run.cs.svec, parts[0].cs.svec), (run.met, parts[0].met), (run.gb, parts[0].gb)):
                assert torch.equal(got, want)
            for got, want in zip(temporal_state(run), temporal_state(parts[0])):
                assert torch.equal(got, want)
    assert bool((second.cs.svec[:, :5] < first.cs.svec[:, :5]).all())  # the update cut every seed's LRs
    # the update alone, as the chunk's last launch runs it
    ref = first.to("cpu", torch.float32)
    shard_step.step_plain(ref, spec, rows=False)
    alone = run_emulated(exe, tmp_path, first, spec, grid=3, rows=False)
    assert int(alone.count) == 1 and torch.equal(alone.sums, first.sums) and torch.equal(alone.dl, first.dl)
    np.testing.assert_allclose(alone.met[0].numpy(), ref.met[0].numpy(), rtol=2e-6, atol=1e-12)
    state, want = [alone.cs.phi, alone.cs.coef, alone.cs.omega] + temporal_state(alone), [
        ref.cs.phi, ref.cs.coef, ref.cs.omega] + temporal_state(ref)
    assert_close([t[0] for t in state], [t[0] for t in want], 2e-6, [f"param {k}" for k in range(len(state))])
    np.testing.assert_allclose(alone.cs.svec.numpy(), ref.cs.svec.numpy(), rtol=2e-6)


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
    """The desmo form of the step kernel on emulated grids against
    ``step_plain`` (``check_emulated_step``)."""
    check_emulated_step(emulated_shard_step, tmp_path, *emulated_state(n, m, r, P, 0, seed=n + m))


@pytest.mark.parametrize(
    "n, m, r, P, nf",
    [
        (64, 24, 2, 2, 3),  # the fourier_cylinder regime's K=12 at nF=3
        (37, 9, 4, 3, 10),  # K=47, ragged rows, a block with no columns, fourier_cylinder's nF
    ],
)
def test_fourier_cuda_source_on_emulated_grid(emulated_shard_step, tmp_path, n, m, r, P, nf):
    """The Fourier form of the step kernel (B from the series in the
    prologue, the series and periods stepped through the series backward)
    on emulated grids against ``step_plain`` (``check_emulated_step``)."""
    check_emulated_step(emulated_shard_step, tmp_path, *emulated_state(n, m, r, P, nf, seed=n + m + nf))
