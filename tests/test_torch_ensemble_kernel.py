"""The packed form of the port's mega-kernel module
(``desmo_tpu_torch.kernels.train_chunk``: ``supports_packed``,
``select_ensemble_chunk``, ``train_chunk_plain_packed``,
``fused_ensemble_chunk``) against ``desmo_tpu``'s seed-packed mega-kernel
(``make_fused_ensemble_chunk`` in interpret mode, as
``tests/test_ensemble_kernel.py`` runs it), at that suite's problems and
tolerances, both packages starting from the same stacked state
(``checkpoint.state_from_jax``); and the packed CUDA source
(``csrc/train_chunk.cu``) on an emulated cooperative grid against the plain
packed chunk. The CUDA kernel itself is held against the plain packed chunk
on the card by ``tests/test_torch_gpu.py``.
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
from desmo_tpu import ensemble as jens  # noqa: E402
from desmo_tpu import pod as jpod  # noqa: E402
from desmo_tpu.io import synthetic as jsynthetic  # noqa: E402
from desmo_tpu.models import desmo as jdesmo  # noqa: E402
from desmo_tpu.models import fourier as jfourier  # noqa: E402
from desmo_tpu.pallas import train_chunk as jtc  # noqa: E402
from desmo_tpu_torch import checkpoint, configs, ensemble  # noqa: E402
from desmo_tpu_torch.kernels import _build, train_chunk  # noqa: E402
from desmo_tpu_torch.models import desmo, fourier  # noqa: E402


def problem(S=3, n=96, m=40, r=2, P=2, lr_omega=0.1, patience=300, sched_every=1):
    """``tests/test_ensemble_kernel.py::problem``: configuration, data, POD
    modes and the JAX package's jittered params (seed 1)."""
    cfg = configs.RunConfig(
        name="ens-mk", variant="desmo", n=n, m=m, r=r, poly_order=P, omega_init=1.0, lr_omega=lr_omega,
        num_epochs=40, patience=patience, sched_every=sched_every, log_every=100, checkpoint_every=1000,
    )
    x = jsynthetic.separable_rank_k(n, m, k=r, seed=0)
    x -= x.mean(axis=1, keepdims=True)
    modes = np.array(jpod.pod(x, r).modes, np.float32)
    jspec = jdesmo.DesmoSpec(n, m, r, P, omega_init=1.0)
    params = jens.init_params(jspec, S, seed=1, phi_sigma=0.1, omega_spread=0.2)
    return cfg, jspec, x.astype(np.float32), modes, params


def fproblem(S=3, n=96, m=40, r=2, P=2, nf=3, periods=None, patience=300, sched_every=1):
    """``tests/test_ensemble_kernel.py::fproblem``: periodic data and, when
    given, distinct per-seed periods."""
    cfg = configs.RunConfig(
        name="ens-fmk", variant="fourier", n=n, m=m, r=r, poly_order=P, n_fourier=nf, period_init=float(m),
        omega_init=1.0, lr_omega=0.1, num_epochs=40, patience=patience, sched_every=sched_every,
        log_every=100, checkpoint_every=1000,
    )
    jspec = jfourier.FourierSpec(n, m, r, P, omega_init=1.0, n_fourier=nf, period_init=float(m))
    t = jfourier.t_points(m)
    s = np.linspace(0, 2 * np.pi, n)
    x = np.outer(np.sin(s), np.sin(2 * np.pi * 2 * t / m)) + 0.5 * np.outer(np.cos(s), np.cos(2 * np.pi * 3 * t / m))
    x = (x - x.mean(axis=1, keepdims=True)).astype(np.float32)
    modes = np.array(jpod.pod(x, r).modes, np.float32)
    params = jens.init_params(jspec, S, seed=1, phi_sigma=0.1, omega_spread=0.2, periods=periods)
    return cfg, jspec, x, modes, params


def port_spec(cfg):
    if cfg.variant == "fourier":
        return fourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier,
                                   cfg.period_init)
    return desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)


def jax_state(cfg, params, S, lr_scales=None, best=None):
    """The JAX package's stacked state; ``best`` replaces every seed's best
    (0: no epoch improves, so the schedulers drop the LRs)."""
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    state = jax.tree.map(jnp.array, jens.init_state(params, jcfg, S, lr_scales=lr_scales))
    if best is not None:
        state = state._replace(sched=state.sched._replace(best=jnp.full((S,), best, jnp.float32)))
    return jcfg, state


def run_jax(cfg, jspec, x, modes, params, S, steps, betas=None, lams=None, lr_scales=None, best=None):
    """``steps`` epochs of the JAX package's seed-packed mega-kernel
    (interpret mode)."""
    jcfg, state = jax_state(cfg, params, S, lr_scales, best)
    fused = jtc.make_fused_ensemble_chunk(jspec, jcfg, S, bt=32, interpret=True, betas=betas, lams=lams)
    state, mets = fused(state, jtc.prepare_batch(x, modes, bt=32), num_steps=steps)
    return jax.tree.map(np.asarray, state), {k: np.asarray(v) for k, v in mets.items()}


def port_batch(x, modes):
    xt = torch.as_tensor(x)
    return {"x": xt, "x_sq": torch.sum(xt * xt), "pod_modes": torch.as_tensor(modes)}


def port_state(cfg, params, S, lr_scales=None, best=None):
    _, state = jax_state(cfg, params, S, lr_scales, best)
    return checkpoint.state_from_jax(jax.tree.map(np.asarray, state), "cpu")


def run_plain(cfg, x, modes, params, S, chunks, betas=None, lams=None, lr_scales=None, best=None):
    spec, batch, state = port_spec(cfg), port_batch(x, modes), port_state(cfg, params, S, lr_scales, best)
    mets = []
    for steps in chunks:
        state, m = train_chunk.train_chunk_plain_packed(state, batch, steps, spec, cfg, betas, lams)
        mets.append({k: v.numpy() for k, v in m.items()})
    return state, {k: np.concatenate([m[k] for m in mets]) for k in mets[0]}


def assert_state_close(ours, ref):
    """The JAX suite's final-state bounds (``test_ensemble_kernel.py:147-158``):
    params rtol 5e-4 (atol 1e-5), per-seed LRs 1e-6, best 3e-4."""
    for key, ref_v in ref.params.items():
        np.testing.assert_allclose(ours.params[key].numpy(), ref_v, rtol=5e-4, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(ours.sched.lrs.numpy(), ref.sched.lrs, rtol=1e-6)
    np.testing.assert_allclose(ours.sched.best.numpy(), ref.sched.best, rtol=3e-4)
    assert ours.epoch == int(ref.epoch) and ours.count == int(ref.opt.count)


def assert_trace_close(mets, ref_m, ortho_atol=1e-6):
    """The JAX suite's trace bounds: rtol 3e-4, atol 1e-6 (ortho 5e-6 for the
    Fourier problem, whose seed 0 starts exactly POD-orthogonal)."""
    for key in ("rec", "ortho", "l1", "total_s"):
        atol = ortho_atol if key == "ortho" else 1e-6
        np.testing.assert_allclose(mets[key], ref_m[key], rtol=3e-4, atol=atol, err_msg=key)
    np.testing.assert_allclose(mets["total"], ref_m["total"], rtol=3e-4, atol=1e-6)
    assert mets["max_arg"].shape == ref_m["max_arg"].shape


@pytest.mark.parametrize("variant", ["desmo", "fourier"])
@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 8, 9, 10, 11])
@pytest.mark.parametrize("r, P", [(2, 2), (4, 2), (4, 3), (9, 1)])
def test_supports_packed_matches_jax(variant, S, r, P):
    base = configs.get("fourier_cylinder" if variant == "fourier" else "aneurysm")
    cfg = dataclasses.replace(base, r=r, poly_order=P)
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    if variant == "fourier":
        spec = fourier.FourierSpec(100, 50, r, P, n_fourier=10)
        jspec = jfourier.FourierSpec(100, 50, r, P, n_fourier=10)
    else:
        spec, jspec = desmo.DesmoSpec(100, 50, r, P), jdesmo.DesmoSpec(100, 50, r, P)
    assert train_chunk.supports_packed(spec, cfg, S) == jtc.supports_packed(jspec, jcfg, S)
    assert ensemble.max_seeds_packed(spec) == jens.max_seeds_packed(jspec)


def test_supports_packed_refuses_ae_and_long_series():
    spec = desmo.DesmoSpec(100, 50, 4, 2)
    assert not train_chunk.supports_packed(spec, configs.get("ae_cylinder"), 2)
    assert not train_chunk.supports_packed(fourier.FourierSpec(100, 50, 2, 2, n_fourier=64),
                                           configs.get("fourier_cylinder"), 2)


def test_select_ensemble_chunk_policy():
    cfg, _, _, _, _ = problem()
    spec = port_spec(cfg)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert train_chunk.select_ensemble_chunk(spec, cfg, 3, cpu) is None  # auto on the CPU: the eager loop
    assert train_chunk.select_ensemble_chunk(spec, cfg, 3, cuda) is not None
    assert train_chunk.select_ensemble_chunk(spec, dataclasses.replace(cfg, loss_method="factored"), 3, cuda) is None
    assert train_chunk.select_ensemble_chunk(spec, dataclasses.replace(cfg, loss_method="fused"), 3, cuda) is not None
    for dev in (cpu, cuda):
        assert train_chunk.select_ensemble_chunk(spec, dataclasses.replace(cfg, chunk_method="scan"), 3, dev) is None
        mk = dataclasses.replace(cfg, chunk_method="megakernel")
        assert train_chunk.select_ensemble_chunk(spec, mk, 3, dev) is not None
        with pytest.raises(ValueError, match="pack"):
            train_chunk.select_ensemble_chunk(spec, mk, 9, dev)  # 9 seeds exceed the 8-row cap
    assert train_chunk.select_ensemble_chunk(spec, cfg, 9, cuda) is None


def test_plain_packed_chunk_matches_jax_kernel():
    """30 epochs of three jittered seeds (``test_packed_kernel_matches_packed_scan``'s
    problem) against the JAX package's packed kernel."""
    cfg, jspec, x, modes, params = problem()
    ref_state, ref_m = run_jax(cfg, jspec, x, modes, params, 3, 30)
    state, mets = run_plain(cfg, x, modes, params, 3, [30])
    assert_trace_close(mets, ref_m)
    assert_state_close(state, ref_state)
    assert (mets["max_arg"] > 0).all()


def test_plain_packed_fourier_chunk_matches_jax_kernel():
    """The Fourier problem with distinct per-seed periods
    (``test_packed_fourier_kernel_matches_packed_scan``)."""
    cfg, jspec, x, modes, params = fproblem(periods=[40.0, 19.2, 30.0])
    ref_state, ref_m = run_jax(cfg, jspec, x, modes, params, 3, 30)
    state, mets = run_plain(cfg, x, modes, params, 3, [30])
    assert_trace_close(mets, ref_m, ortho_atol=5e-6)
    assert_state_close(state, ref_state)
    assert set(state.params) >= {"period", "trig_period"}


def test_plain_packed_plateau_drops_match_jax_kernel():
    """Tiny patience and a best no epoch beats: each seed's scheduler drops
    its LRs on the epochs the JAX kernel's does."""
    cfg, jspec, x, modes, params = problem(S=2, patience=3, sched_every=2)
    ref_state, ref_m = run_jax(cfg, jspec, x, modes, params, 2, 20, best=0.0)
    state, mets = run_plain(cfg, x, modes, params, 2, [20], best=0.0)
    assert (state.sched.lrs[:, 0] < cfg.lr_coef).all()  # the drops happened
    np.testing.assert_allclose(state.sched.lrs.numpy(), ref_state.sched.lrs, rtol=1e-6)
    np.testing.assert_array_equal(state.sched.num_bad.numpy(), ref_state.sched.num_bad)
    np.testing.assert_allclose(mets["total_s"], ref_m["total_s"], rtol=5e-4, atol=1e-6)


def test_plain_packed_resume_mid_run():
    """chunk(8) then chunk(8) against the JAX kernel's 16
    (``test_resume_mid_run``), and against the port's own chunk(16)."""
    cfg, jspec, x, modes, params = problem(S=2)
    ref_state, ref_m = run_jax(cfg, jspec, x, modes, params, 2, 16)
    split, split_m = run_plain(cfg, x, modes, params, 2, [8, 8])
    whole, whole_m = run_plain(cfg, x, modes, params, 2, [16])
    assert split.epoch == 16 and split.count == 16
    np.testing.assert_allclose(split_m["total_s"], whole_m["total_s"], rtol=1e-5)
    assert_state_close(split, ref_state)


@pytest.mark.parametrize("variant", ["desmo", "fourier"])
def test_plain_packed_hyper_sweep_matches_jax_kernel(variant):
    """Heterogeneous per-seed beta, lambda and LR scale
    (``test_packed_kernel_hyper_sweep_matches_packed_scan`` and its Fourier
    twin): 25 epochs against the JAX kernel under the same hypers."""
    cfg, jspec, x, modes, params = problem() if variant == "desmo" else fproblem()
    betas = np.array([1e-3, 5e-3, 1e-2], np.float32)
    lams = np.array([1e-4, 1e-5, 1e-3], np.float32)
    scales = np.array([1.0, 0.5, 2.0], np.float32)
    ref_state, ref_m = run_jax(cfg, jspec, x, modes, params, 3, 25, betas, lams, scales)
    state, mets = run_plain(cfg, x, modes, params, 3, [25], betas, lams, scales)
    assert_trace_close(mets, ref_m, ortho_atol=1e-6 if variant == "desmo" else 5e-6)
    assert_state_close(state, ref_state)


@pytest.mark.parametrize("variant", ["desmo", "fourier"])
def test_each_packed_seed_matches_the_seed_alone(variant):
    """Seed s of the plain packed chunk against the one-model plain chunk
    from that seed's state: the same arithmetic per seed, so the trace to
    2e-5 and the params to 1e-4 (``test_packed_seeds_match_independent_single_kernels``)."""
    cfg, _, x, modes, params = problem() if variant == "desmo" else fproblem(periods=[40.0, 19.2, 30.0])
    spec, batch, state = port_spec(cfg), port_batch(x, modes), port_state(cfg, params, 3)
    packed, m_k = train_chunk.train_chunk_plain_packed(state, batch, 25, spec, cfg)
    for s in range(3):
        alone, m_s = train_chunk.train_chunk_plain(train_chunk.seed_view(state, s), batch, 25, spec, cfg)
        np.testing.assert_allclose(m_k["total_s"][:, s].numpy(), m_s["total"].numpy(), rtol=2e-5, atol=1e-7)
        for key in alone.params:
            np.testing.assert_allclose(packed.params[key][s].numpy(), alone.params[key].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=f"seed {s}: {key}")


def test_one_seed_and_uniform_hypers_are_bitwise():
    """S = 1 through the packed chunk is the one-model chunk bit for bit, and
    hypers equal to the config's give the bits of no hypers
    (``test_single_seed_wrapper_bitwise_equals_standard_kernel``,
    ``test_uniform_hypers_bitwise_equal_no_hypers``)."""
    cfg, _, x, modes, params = problem(S=2)
    spec, batch = port_spec(cfg), port_batch(x, modes)
    state = port_state(cfg, params, 2)
    one = train_chunk.seed_view(state, 0)
    p1, m1 = train_chunk.train_chunk_plain_packed(train_chunk.stack_seed(one), batch, 12, spec, cfg)
    s1, ms = train_chunk.train_chunk_plain(one, batch, 12, spec, cfg)
    assert torch.equal(m1["total_s"][:, 0], ms["total"])
    assert all(torch.equal(p1.params[k][0], s1.params[k]) for k in s1.params)
    a, ma = train_chunk.train_chunk_plain_packed(state, batch, 12, spec, cfg)
    b, mb = train_chunk.train_chunk_plain_packed(
        state, batch, 12, spec, cfg, np.full(2, cfg.beta, np.float32), np.full(2, cfg.l1_lambda, np.float32))
    assert torch.equal(ma["total_s"], mb["total_s"])
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def test_one_seed_group_takes_its_own_hypers():
    """An S = 1 group of a sweep trains under its combo, not the config's
    (``test_single_seed_remainder_group_honors_hypers``): against the JAX
    kernel at S = 1 with the same hypers."""
    cfg, jspec, x, modes, params = problem(S=1)
    betas, lams = np.array([7e-2], np.float32), np.array([3e-2], np.float32)
    ref_state, ref_m = run_jax(cfg, jspec, x, modes, params, 1, 10, betas, lams)
    state, mets = run_plain(cfg, x, modes, params, 1, [10], betas, lams)
    np.testing.assert_allclose(mets["total_s"], ref_m["total_s"], rtol=3e-4, atol=1e-6)
    assert_state_close(state, ref_state)


def test_a_nan_seed_stays_isolated():
    """Seed 1's phi is NaN: its metrics are non-finite, the others' finite
    and equal to a run without it (``test_packed_kernel_isolates_diverged_seed_metrics``)."""
    cfg, _, x, modes, params = problem()
    spec, batch = port_spec(cfg), port_batch(x, modes)
    state = port_state(cfg, params, 3)
    clean, m_clean = train_chunk.train_chunk_plain_packed(state, batch, 3, spec, cfg)
    state.params["phi"][1] = float("nan")
    _, mets = train_chunk.train_chunk_plain_packed(state, batch, 3, spec, cfg)
    for key in ("rec", "ortho", "total_s"):
        assert not torch.isfinite(mets[key][:, 1]).any(), key
        assert torch.equal(mets[key][:, [0, 2]], m_clean[key][:, [0, 2]]), key


def test_cpu_takes_the_plain_packed_chunk_and_counts_no_launch():
    cfg, _, x, modes, params = problem()
    spec, batch, state = port_spec(cfg), port_batch(x, modes), port_state(cfg, params, 3)
    before = train_chunk.fused_ensemble_chunk.launches
    s1, m1 = train_chunk.fused_ensemble_chunk(state, batch, 3, spec, cfg)
    s2, m2 = train_chunk.train_chunk_plain_packed(state, batch, 3, spec, cfg)
    assert train_chunk.fused_ensemble_chunk.launches == before == 0
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(s1.params[k], s2.params[k]) for k in s1.params)
    with pytest.raises(ValueError, match="seed"):
        train_chunk.fused_ensemble_chunk(state, batch, 3, spec, cfg, betas=[1e-3])


def test_column_table_at_one_seed_is_the_single_seed_layout():
    spec = desmo.DesmoSpec(10, 5, 4, 3)
    tab = train_chunk.column_table(spec, 1)
    T, r = spec.num_poly_terms, spec.r
    np.testing.assert_array_equal(tab[:T, 1], 0)
    np.testing.assert_array_equal(tab[:T, 4:], spec.factor_table())
    np.testing.assert_array_equal(tab[T:, 1], 1 + np.arange(3 * r) // r)
    np.testing.assert_array_equal(tab[T:, 2], 1 + np.arange(3 * r) % r)
    np.testing.assert_array_equal(tab[T:, 3], np.arange(3 * r))
    packed = train_chunk.column_table(spec, 3)
    np.testing.assert_array_equal(packed[packed[:, 1] == 0, 4:], ensemble.packed_factor_table(spec, 3))


EMULATION = Path(__file__).parent / "cuda_emulation" / "cooperative"


@pytest.fixture(scope="module")
def emulated_train_chunk(tmp_path_factory):
    """``csrc/train_chunk.cu`` compiled by the host C++ compiler against
    ``tests/cuda_emulation/cooperative`` (all blocks at once,
    ``this_grid().sync()`` a barrier over every thread)."""
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


@pytest.mark.parametrize(
    "n, m, r, P, S, nf, steps, patience, hypers",
    [
        (96, 40, 2, 2, 3, 0, 4, 300, False),  # the JAX suite's size, three seeds
        (40, 17, 4, 2, 2, 0, 3, 300, True),  # K'=54 (built for 64), per-seed beta, lambda, LR scale
        (37, 9, 2, 2, 3, 0, 6, 1, False),  # ragged rows, a block with no columns, LR drops
        (96, 40, 2, 2, 3, 3, 4, 300, True),  # Fourier, distinct periods and hypers
        (40, 17, 2, 2, 8, 2, 2, 300, False),  # Fourier, eight seeds: K'=96 (built for 128)
    ],
)
def test_packed_cuda_source_on_emulated_grid(emulated_train_chunk, tmp_path, n, m, r, P, S, nf, steps,
                                             patience, hypers):
    """The packed form on four emulated blocks against the plain packed
    chunk, from jittered seeds and POD-like modes that are not orthonormal:
    the same fp32 arithmetic in another summation order, held to 2e-6 of each
    array's largest entry."""
    import test_torch_train_chunk as single

    rng = np.random.default_rng(n + S + nf)
    cfg = configs.RunConfig(
        name="emu", variant="fourier" if nf else "desmo", n=n, m=m, r=r, poly_order=P, omega_init=1.0,
        lr_omega=1.0, n_fourier=max(nf, 1), period_init=float(m), patience=patience, sched_every=2 if patience == 1 else 1,
    )
    spec = port_spec(cfg) if nf else desmo.DesmoSpec(n, m, r, P, 1.0)
    xt = torch.as_tensor(rng.standard_normal((n, m)).astype(np.float32))
    batch = {"x": xt, "x_sq": torch.sum(xt * xt),
             "pod_modes": torch.as_tensor((0.3 * rng.standard_normal((n, r))).astype(np.float32))}
    periods = list(m * (0.7 + 0.6 * rng.random(S))) if nf else None
    params = ensemble.init_params(spec, S, seed=1, phi_sigma=0.1, omega_spread=0.2, periods=periods)
    if nf:
        for key in ("z", "z_trig"):
            params[key] = torch.as_tensor((0.5 * rng.standard_normal(params[key].shape)).astype(np.float32))
    betas = lams = scales = None
    if hypers:
        betas = np.geomspace(1e-3, 1e-2, S).astype(np.float32)
        lams = np.geomspace(1e-5, 1e-3, S).astype(np.float32)
        scales = np.where(np.arange(S) % 2, 0.5, 1.0)
    state = ensemble.init_state(params, cfg, S, lr_scales=scales)
    if patience == 1:  # a best no epoch beats: the schedulers drop the LRs within the chunk
        state.sched = dataclasses.replace(state.sched, best=torch.zeros(S))
    got = single.run_emulated(emulated_train_chunk, tmp_path, state, batch, steps, spec, cfg, 4, betas, lams)
    single.assert_emulated_matches_plain(got, state, batch, steps, spec, cfg, betas, lams)
    if patience == 1:
        assert (got["svec"][:, 0] < cfg.lr_coef).all()  # every seed's scheduler dropped its LRs


@pytest.mark.parametrize(
    "r, P, S, nf",
    [
        (2, 2, 4, 0),  # K'=48 (the KP=48 form) against the seeds' K=12 (KP=32)
        (4, 2, 3, 0),  # K'=81 (KP=128) against K=27 (KP=32): aneurysm's seed width
        (2, 2, 5, 3),  # Fourier, K'=60 (KP=64) against K=12 (KP=32)
    ],
)
def test_packed_seed_equals_the_seed_alone_on_emulated_grid(emulated_train_chunk, tmp_path, r, P, S, nf):
    """Each seed of the packed CUDA source equals the one-seed source run
    alone from that seed's state, bit for bit, though the two run different
    KP forms: the contractions sum in an order that does not depend on KP.
    The metrics' max |omega lat| is over all seeds, so it is left out."""
    import test_torch_train_chunk as single

    n, m, steps = 40, 33, 3
    rng = np.random.default_rng(S + 10 * r + nf)
    cfg = configs.RunConfig(
        name="emu", variant="fourier" if nf else "desmo", n=n, m=m, r=r, poly_order=P, omega_init=1.0,
        lr_omega=1.0, n_fourier=max(nf, 1), period_init=float(m),
    )
    spec = port_spec(cfg) if nf else desmo.DesmoSpec(n, m, r, P, 1.0)
    xt = torch.as_tensor(rng.standard_normal((n, m)).astype(np.float32))
    batch = {"x": xt, "x_sq": torch.sum(xt * xt),
             "pod_modes": torch.as_tensor((0.3 * rng.standard_normal((n, r))).astype(np.float32))}
    periods = list(m * (0.7 + 0.6 * rng.random(S))) if nf else None
    state = ensemble.init_state(
        ensemble.init_params(spec, S, seed=2, phi_sigma=0.1, omega_spread=0.2, periods=periods), cfg, S)
    packed = single.run_emulated(emulated_train_chunk, tmp_path, state, batch, steps, spec, cfg, 4)
    ks = spec.num_poly_terms + 3 * r
    for s in range(S):
        alone = single.run_emulated(emulated_train_chunk, tmp_path, train_chunk.stack_seed(
            train_chunk.seed_view(state, s)), batch, steps, spec, cfg, 4)
        rows = {"phi": slice(s * r, (s + 1) * r), "b": slice(s * ks, (s + 1) * ks),
                "series": slice(s * ks, (s + 1) * ks), "periods": slice(s * ks, (s + 1) * ks),
                "coef": slice(s * ks, (s + 1) * ks), "omega": slice(s * 3 * r, (s + 1) * 3 * r)}
        for name, got in alone.items():
            if name == "svec":
                want = packed[name][s:s + 1]
            elif name == "metrics":
                got, want = got[:, :, :4], packed[name][:, s:s + 1, :4]
            else:
                want = packed[name][:, rows[name]]
            np.testing.assert_array_equal(got, want, err_msg=f"seed {s}: {name}")
