"""The packed form of the port's sharded step: ``kernels.shard_step``
(``supports_sharded_packed``, the packed ``step_plain``,
``make_sharded_fused_ensemble_chunk``, ``kernel_table``),
``kernels.train_chunk.select_ensemble_chunk(device_mesh=...)``,
``ensemble.fit(device_mesh=...)`` and ``run --seeds S --mesh space=d``.
``tests/test_torch_shard_step.py`` holds the sharded packed chunk against
``desmo_tpu``'s at d=1, 2 and 4 (its gloo processes run the ensemble too);
here:

- the packed plain partials over 2 and 3 uneven shards against the whole
  rows and against float64;
- the sharded packed chunk on one rank against the packed mega-kernel's
  plain chunk, and each packed seed against the one-seed sharded chunk run
  alone from its state, bit for bit;
- ``supports_sharded_packed`` against the reference's; the mesh policy of
  ``select_ensemble_chunk``; ``fit`` over a mesh; the CLI;
- the packed CUDA source (``csrc/shard_step.cu``) on the emulated
  cooperative grid against ``step_plain``, and a packed seed against the
  one-seed launch from its state, bit for bit.

The CUDA kernel itself is held against its plain version on the card by
``tests/test_torch_gpu.py``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from desmo_tpu import configs as jconfigs  # noqa: E402
from desmo_tpu.models import desmo as jdesmo  # noqa: E402
from desmo_tpu.models import fourier as jfourier  # noqa: E402
from desmo_tpu.pallas import shard_step as jshard  # noqa: E402
from desmo_tpu_torch import checkpoint, configs, ensemble, parallel  # noqa: E402
from desmo_tpu_torch.__main__ import main as cli_main  # noqa: E402
from desmo_tpu_torch.kernels import shard_step, train_chunk  # noqa: E402
from desmo_tpu_torch.models import desmo, fourier  # noqa: E402
from test_torch_shard_step import (  # noqa: E402
    ENSEMBLE_S,
    _bounds,
    check_emulated_step,
    emulated_shard_step,  # noqa: F401  (the fixture)
    emulated_state,
    ensemble_problem,
    port_batch,
    port_spec,
    run_emulated,
    shard_of,
)

PARTS = ("ax", "ga", "latg", "gcoef", "gomega")


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo mesh of this process."""
    return parallel.make_mesh(1, device="cpu")


@pytest.mark.parametrize("n, m, r, P, S", [(256, 40, 2, 2, 3), (101, 33, 4, 3, 2)])
def test_packed_partials_over_uneven_shards(n, m, r, P, S):
    """S seeds' partials (``step_plain`` at the counter 0) over 2 and 3
    uneven shards, summed as the ranks' SUM would sum them, against the
    whole rows and against float64, each part within 5e-6 of its largest
    entry; the shards' dl rows are the whole call's bits, their max_arg max
    the whole call's."""
    spec, cfg, cs, batch = emulated_state(n, m, r, P, 0, seed=n + S, n_seeds=S)
    K = spec.num_poly_terms + 3 * r
    buf = shard_step.make_buffers(cs, batch, 1, spec, cfg, n)
    whole_run = buf.to("cpu", torch.float32)
    shard_step.step_plain(whole_run, spec)
    ref64 = buf.to("cpu", torch.float64)
    shard_step.step_plain(ref64, spec)
    ref = shard_step.split_seed_sums(ref64.sums, K, m, r, S)
    for got, want in zip(shard_step.split_seed_sums(whole_run.sums, K, m, r, S), ref):
        assert float((got.double() - want).abs().max()) <= 5e-6 * float(want.abs().max())
    for d in (2, 3):
        parts = [shard_of(buf, lo, hi) for lo, hi in _bounds(n, d)]
        for part in parts:
            shard_step.step_plain(part, spec)
        summed = shard_step.split_seed_sums(sum(p.sums for p in parts), K, m, r, S)
        for name, got, whole_v, want in zip(PARTS, summed, shard_step.split_seed_sums(whole_run.sums, K, m, r, S),
                                            ref):
            scale = float(want.abs().max())
            assert float((got - whole_v).abs().max()) <= 5e-6 * scale, (d, name)
            assert float((got.double() - want).abs().max()) <= 5e-6 * scale, (d, name)
        np.testing.assert_array_equal(torch.cat([p.dl for p in parts]).numpy(), whole_run.dl.numpy())
        assert max(float(p.max_arg[0]) for p in parts) == float(whole_run.max_arg[0])
    assert float((whole_run.dl.double() - ref64.dl).abs().max()) <= 5e-6 * float(ref64.dl.abs().max())


def _port_state(case):
    cfg, x, modes, params, hyp, steps = ensemble_problem(case)
    state = ensemble.init_state(checkpoint.params_from_jax(params, "cpu"), cfg, ENSEMBLE_S,
                                lr_scales=hyp.get("lr_scales"))
    return cfg, port_spec(cfg), port_batch(x, modes), state, hyp, steps


@pytest.mark.parametrize("case", ["desmo", "fourier", "sweep"])
def test_sharded_packed_chunk_matches_the_plain_packed_chunk(mesh1, case):
    """On one rank the sharded packed chunk (S one-seed steps sharing X,
    their update at the next launch) against the packed mega-kernel's plain
    chunk (``train_chunk_plain_packed``: batched products over the seeds,
    the update in the same epoch) from the same state over 25 steps: the
    same arithmetic in another rounding order, total_s within 1e-5, the
    parameters within 1e-4 (atol 1e-6), the LRs and the count equal."""
    cfg, spec, batch, state, hyp, steps = _port_state(case)
    chunk = shard_step.make_sharded_fused_ensemble_chunk(spec, cfg, mesh1, ENSEMBLE_S, betas=hyp.get("betas"),
                                                         lams=hyp.get("lams"))
    got, got_m = chunk(state, parallel.shard_batch(batch, mesh1), steps)
    want, want_m = train_chunk.train_chunk_plain_packed(state, batch, steps, spec, cfg, hyp.get("betas"),
                                                        hyp.get("lams"))
    assert set(got_m) == set(want_m) and got_m["total_s"].shape == (steps, ENSEMBLE_S)
    np.testing.assert_allclose(got_m["total_s"].numpy(), want_m["total_s"].numpy(), rtol=1e-5)
    np.testing.assert_allclose(got_m["max_arg"].numpy(), want_m["max_arg"].numpy(), rtol=1e-5)
    for key, v in want.params.items():
        np.testing.assert_allclose(got.params[key].numpy(), v.numpy(), rtol=1e-4, atol=1e-6, err_msg=key)
    assert torch.equal(got.sched.lrs, want.sched.lrs) and (got.count, got.epoch) == (want.count, want.epoch)


def test_each_packed_seed_equals_the_seed_alone(mesh1):
    """Each seed of the sharded packed chunk under a hyperparameter sweep
    against the one-seed sharded chunk run alone from that seed's state with
    its beta and lambda: the same bits, metrics, parameters and LRs."""
    cfg, spec, batch, state, hyp, steps = _port_state("sweep")
    local = parallel.shard_batch(batch, mesh1)
    packed, packed_m = shard_step.make_sharded_fused_ensemble_chunk(
        spec, cfg, mesh1, ENSEMBLE_S, betas=hyp["betas"], lams=hyp["lams"])(state, local, steps)
    for s in range(ENSEMBLE_S):
        one_cfg = dataclasses.replace(cfg, beta=float(hyp["betas"][s]), l1_lambda=float(hyp["lams"][s]))
        alone, alone_m = shard_step.make_sharded_fused_chunk(spec, one_cfg, mesh1)(
            train_chunk.seed_view(state, s), local, steps)
        for key in ("rec", "ortho", "l1"):
            assert torch.equal(packed_m[key][:, s], alone_m[key]), (s, key)
        assert torch.equal(packed_m["total_s"][:, s], alone_m["total"]), s
        for key, v in alone.params.items():
            assert torch.equal(packed.params[key][s], v), (s, key)
        assert torch.equal(packed.sched.lrs[s], alone.sched.lrs), s


@pytest.mark.parametrize("variant", ["desmo", "fourier"])
@pytest.mark.parametrize("r, P", [(2, 2), (4, 2), (4, 3), (8, 2)])
@pytest.mark.parametrize("S", [1, 2, 3, 4, 8, 9])
def test_supports_sharded_packed_matches_jax(variant, r, P, S):
    cfg = dataclasses.replace(configs.get("fourier_cylinder" if variant == "fourier" else "aneurysm"), r=r,
                              poly_order=P)
    jcfg = jconfigs.RunConfig(**dataclasses.asdict(cfg))
    if variant == "fourier":
        spec, jspec = fourier.FourierSpec(100, 50, r, P, n_fourier=10), jfourier.FourierSpec(100, 50, r, P, n_fourier=10)
    else:
        spec, jspec = desmo.DesmoSpec(100, 50, r, P), jdesmo.DesmoSpec(100, 50, r, P)
    assert shard_step.supports_sharded_packed(spec, cfg, S) == jshard.supports_sharded_packed(jspec, jcfg, S)


def test_the_ae_variant_has_no_sharded_packed_chunk(mesh1):
    spec = desmo.DesmoSpec(100, 50, 2, 2)
    assert not shard_step.supports_sharded_packed(spec, configs.get("ae_cylinder"), 2)
    with pytest.raises(ValueError, match="seed-packed"):
        shard_step.make_sharded_fused_ensemble_chunk(spec, configs.get("ae_cylinder"), mesh1, 2)


def test_select_ensemble_chunk_under_a_mesh(mesh1):
    """Under a mesh 'auto' takes the sharded packed chunk on any device (its
    plain version on the CPU) when the loss method is 'auto' or 'fused';
    'scan', an explicit other loss method, or seeds that do not pack give
    None (``ensemble.fit`` then raises); 'megakernel' on seeds that do not
    pack raises ``ValueError``."""
    cfg, spec, *_ = _port_state("desmo")
    cpu = torch.device("cpu")

    def select(c, S=3):
        return train_chunk.select_ensemble_chunk(spec, c, S, cpu, device_mesh=mesh1)

    assert select(cfg) is not None and select(dataclasses.replace(cfg, loss_method="fused")) is not None
    assert select(dataclasses.replace(cfg, chunk_method="megakernel", loss_method="factored")) is not None
    assert select(dataclasses.replace(cfg, chunk_method="scan")) is None
    assert select(dataclasses.replace(cfg, loss_method="factored")) is None
    assert select(cfg, S=9) is None  # 9 seeds exceed the 8-row cap
    with pytest.raises(ValueError, match="sharded seed-packed"):
        select(dataclasses.replace(cfg, chunk_method="megakernel"), S=9)


def _fit(mesh, **over):
    cfg, spec, batch, _, _, _ = _port_state("desmo")
    cfg = dataclasses.replace(cfg, checkpoint_every=8, **over)
    saved, report = [], {}
    out = ensemble.fit(cfg, spec, batch, n_seeds=3, num_epochs=16, seed=1, phi_sigma=0.1, log=None,
                       checkpoint_fn=lambda st, ep: saved.append((st, ep)), device_mesh=mesh, report=report)
    return out, saved, report, spec


def test_fit_over_a_mesh(mesh1):
    """``fit`` over a one-rank mesh through the sharded packed chunk against
    ``fit`` through the packed mega-kernel's plain chunk: the same winner,
    the kept seed's trace within 1e-5, every chunk checkpointed with the
    winner's whole phi; the report's live members whole too."""
    (res, best, finals), saved, report, spec = _fit(mesh1)
    (ref, ref_best, ref_finals), ref_saved, _, _ = _fit(None, chunk_method="megakernel")
    assert best == ref_best and [ep for _, ep in saved] == [ep for _, ep in ref_saved] == [8, 16]
    np.testing.assert_allclose(finals, ref_finals, rtol=1e-5)
    np.testing.assert_allclose(res.history["total"], ref.history["total"], rtol=1e-5)
    assert all(st.params["phi"].shape == (spec.r, spec.n) for st, _ in saved)
    assert res.state.params["phi"].shape == (spec.r, spec.n) and len(report["seed_params"]) == 3
    assert all(p["phi"].shape == (spec.r, spec.n) for p in report["seed_params"])


def test_fit_over_a_mesh_freezes_diverged_seeds(mesh1):
    """Seeds 1 and 2 overflow at init (phi jitter 1e200): over a mesh too
    they are blamed at the first bad step from the replicated metrics,
    frozen, and seed 0 wins."""
    cfg, spec, batch, _, _, _ = _port_state("desmo")
    _, best, finals = ensemble.fit(dataclasses.replace(cfg, checkpoint_every=4), spec, batch, n_seeds=3,
                                   num_epochs=8, phi_sigma=1e200, log=None, device_mesh=mesh1)
    assert best == 0 and np.isfinite(finals[0]) and np.isinf(finals[1:]).all()


def test_cli_runs_seeds_over_a_mesh(mesh1, tmp_path, capsys):
    """``run --seeds 2 --mesh space=1`` at the cylinder's full width on the
    CPU: the summary's seeds and mesh, ``ensemble.json`` and the exports."""
    argv = ["run", "--preset", "cylinder", "--synthetic", "--epochs", "3", "--device", "cpu", "--out-dir",
            str(tmp_path), "--seeds", "2", "--mesh", "space=1"]
    assert cli_main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_seeds"] == 2 and summary["mesh"] == "space=1" and np.isfinite(summary["relative_error"])
    run_dir = tmp_path / "cylinder"
    with open(run_dir / "ensemble.json") as fh:
        assert json.load(fh)["n_seeds"] == 2
    assert {"cylinder_r4_final.pt", "state_final.npz", "term_stability.json"} <= set(os.listdir(run_dir))


@pytest.mark.parametrize("r, P, S", [(2, 2, 3), (4, 3, 2), (5, 2, 2)])
def test_packed_kernel_table_lists_each_seeds_lanes(r, P, S):
    """The packed table: the S-seed column table, then for each latent lane
    jl = s r + j of S r the entries k P + p (ascending) whose factor p of a
    polynomial column k is lane jl + 1, all in seed s's block; every factor
    that is not the constant lane 0 listed once."""
    spec = desmo.DesmoSpec(40, 12, r, P, 1.0)
    ct = train_chunk.column_table(spec, S)
    K = ct.shape[0]
    table = shard_step.kernel_table(spec, S)
    assert table.shape == (ct.size + S * r + 1 + K * P,)
    np.testing.assert_array_equal(table[:ct.size], ct.reshape(-1))
    d_off, d_tp = table[ct.size:ct.size + S * r + 1], table[ct.size + S * r + 1:]
    for jl in range(S * r):
        entries = d_tp[d_off[jl]:d_off[jl + 1]]
        assert list(entries) == sorted(entries)
        assert all(ct[e // P, 0] == jl // r and ct[e // P, 1] == 0 and ct[e // P, 4 + e % P] == jl + 1
                   for e in entries)
    assert d_off[S * r] == int(((ct[:, 4:] > 0) & (ct[:, 1:2] == 0)).sum())


@pytest.mark.parametrize(
    "n, m, r, P, S, nf",
    [
        (96, 40, 2, 2, 3, 0),  # the JAX suite's r and P, K'=36: the kernel built for K <= 48
        (37, 9, 2, 2, 2, 0),  # ragged rows, a block with no columns
        (24, 10, 4, 2, 4, 0),  # aneurysm's r and P at S=4: K'=104, the kernel built for K <= 128
        (64, 24, 2, 2, 3, 3),  # the Fourier form, its seeds' periods apart
        (37, 9, 4, 3, 2, 3),  # K'=94, ragged rows, a block with no columns
    ],
)
def test_packed_cuda_source_on_emulated_grid(emulated_shard_step, tmp_path, n, m, r, P, S, nf):
    """The packed step kernel on emulated grids against ``step_plain``
    (``check_emulated_step``: whole and over three uneven shards, the
    partials, the update then the partials, the update alone), each seed
    with its own LRs, beta and lambda."""
    check_emulated_step(emulated_shard_step, tmp_path, *emulated_state(n, m, r, P, nf, seed=n + m + S, n_seeds=S))


@pytest.mark.parametrize("r, P, S, nf", [(2, 2, 3, 0), (2, 2, 2, 3)])
def test_packed_seed_equals_the_seed_alone_on_emulated_grid(emulated_shard_step, tmp_path, r, P, S, nf):
    """Two launches of the packed kernel (the partials, then the update and
    the next partials) against the one-seed kernel's from each seed's state
    alone: each seed's sums, dl, gb, metrics row and state are the same
    bits, though the packed width needs another build (K' = S K)."""
    n, m = 40, 16
    spec, cfg, cs, batch = emulated_state(n, m, r, P, nf, seed=7, n_seeds=S)
    K = spec.num_poly_terms + 3 * r
    packed = shard_step.make_buffers(cs, batch, 2, spec, cfg, n)
    for _ in range(2):
        packed = run_emulated(emulated_shard_step, tmp_path, packed, spec, grid=3)
    sums = shard_step.split_seed_sums(packed.sums, K, m, r, S)
    for q in range(S):
        one_cs = shard_step.packed_seed(cs, q, r, K)
        one_cs = train_chunk.ChunkState(**{f.name: None if getattr(one_cs, f.name) is None else
                                           getattr(one_cs, f.name).clone() for f in dataclasses.fields(one_cs)})
        alone = shard_step.make_buffers(one_cs, batch, 2, spec, cfg, n)
        for _ in range(2):
            alone = run_emulated(emulated_shard_step, tmp_path, alone, spec, grid=3)
        mine = shard_step.packed_seed(packed.cs, q, r, K)
        for f in ("phi", "coef", "omega", "svec") + (("series", "periods") if nf else ("b",)):
            assert torch.equal(getattr(mine, f), getattr(alone.cs, f)), (q, f)
        for name, got, want in zip(PARTS, sums, shard_step.split_sums(alone.sums, K, m, r)):
            got = got[q * K:(q + 1) * K] if name in ("ax", "gcoef") else got[q] if name in ("ga", "latg") else \
                got[3 * q * r:3 * (q + 1) * r]
            assert torch.equal(got, want), (q, name)
        assert torch.equal(packed.dl[:, q * r:(q + 1) * r], alone.dl), q
        assert torch.equal(packed.gb[q], alone.gb[0]) and torch.equal(packed.met[:, q], alone.met[:, 0]), q
