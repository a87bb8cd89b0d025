"""The plain reference (``perfbench/reference/desmo.py``) against the port's
CPU plain chunk at a tiny size, and the reference's own conventions against
the port's (term order, the packed seeds' initial draws, the POD)."""

import numpy as np
import pytest
import torch

from desmo_tpu_torch import configs, ensemble, library, pod, runner, train
from desmo_tpu_torch.kernels import train_chunk as tc
from perfbench import check, harness, synthetic
from perfbench.reference import desmo as ref

N, M = 300, 60


@pytest.mark.parametrize("r,p", [(4, 3), (4, 2), (2, 2)])
def test_monomials_follow_the_library_order(r, p):
    table = library.factor_table(r, p)
    want = [tuple(int(v) - 1 for v in row if v > 0) for row in table]
    assert ref.monomials(r, p) == want
    assert ref.num_terms(r, p) == library.num_poly_terms(r, p) + 3 * r


def test_seed_params_are_the_packed_seeds_initial_draws():
    spec = runner.build_model(configs.get("aneurysm"), torch.device("cpu"))[0]
    prog = ensemble.init_params(spec, 4, seed=2**33 + 5, phi_sigma=0.02)
    want = ref.seed_params(spec.n, spec.m, 4, 2, 1e4, 4, 2**33 + 5, 0.02, "cpu")
    for s in range(4):
        for k in ref.LEAVES:
            assert torch.equal(prog[k][s], want[s][k]), (s, k)


def test_pod_is_the_host_svd():
    x = synthetic.wake(N, M, 3, "cpu")
    got = ref.pod_modes(x, 4)
    prog = pod.pod_host(x.numpy(), 4, "cpu").modes
    assert check.pod_gap(check.signed_like(got, prog), prog) < 1e-6


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11), 3.0], dtype=torch.float32)
    assert ref.tf32(x).tolist() == [1.0, 1.0 + 2.0**-10, 1.0, -(1.0 + 2.0**-10), 3.0]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert 0 < float(((ref.tf32(y) - y).abs() / y.abs()).max()) <= 2.0**-11


def _problem(omega_init: float, lr_omega: float, seeds: int = 1):
    cfg = dict(configs.get("cylinder").__dict__)
    cfg.update(n=N, m=M, omega_init=omega_init, lr_omega=lr_omega, chunk_method="megakernel", n_seeds=seeds)
    cfg = configs.RunConfig(**cfg)
    x = synthetic.wake(N, M, 7, "cpu")
    p, _ = runner.compute_pod(cfg, x.numpy(), torch.device("cpu"))
    batch = runner.prepare_batch(x.numpy(), p.modes, torch.device("cpu"))
    spec, params, _, _ = runner.build_model(cfg, torch.device("cpu"))
    return cfg, spec, batch, params, x, p.modes


def _ref_cfg(cfg):
    return {k: getattr(cfg, k) for k in ("poly_order", "patience", "sched_factor", "sched_min_lr", "sched_every")}


def test_three_reference_epochs_follow_the_plain_chunk():
    """At omega_init=1 two float32 orders stay together: the reference's own
    trajectory holds the plain chunk's state and metrics tightly."""
    cfg, spec, batch, params, x, modes = _problem(1.0, 1.0)
    state = train.init_state(params, cfg)
    st = ref.initial_state(ref.initial_params(N, M, 4, 3, 1.0, "cpu"), cfg.group_lrs)
    for _ in range(3):
        state, mets = tc.fused_train_chunk(state, batch, 1, spec, cfg)
        m_ref, _, st = ref.epoch(st, x, modes, _ref_cfg(cfg), cfg.beta, cfg.l1_lambda)
        for key in ("rec", "l1", "total"):
            assert float(mets[key][0]) == pytest.approx(m_ref[key], rel=2e-6)
        assert float(mets["ortho"][0]) == pytest.approx(m_ref["ortho"], abs=1e-6)
        for k in ref.LEAVES:
            np.testing.assert_allclose(state.params[k].numpy(), st["params"][k].numpy(), rtol=1e-5, atol=1e-6)
    assert state.epoch == st["epoch"] == 3 and state.count == st["count"] == 3


@pytest.mark.parametrize("seeds", [1, 2])
def test_check_reads_the_plain_chunk_as_the_reference_at_the_preset_omega(seeds):
    """At omega_init=1e4 the check follows the program step by step: the
    plain chunk reads within float32 rounding on every number, one seed or
    packed."""
    cfg, spec, batch, params, x, modes = _problem(1e4, 1e3, seeds)
    if seeds == 1:
        chunk = tc.select_chunk(spec, cfg, torch.device("cpu"))
        state = train.init_state(params, cfg)
    else:
        chunk = tc.select_ensemble_chunk(spec, cfg, seeds, torch.device("cpu"))
        state = ensemble.init_state(ensemble.init_params(spec, seeds, seed=11, phi_sigma=cfg.seed_phi_sigma), cfg,
                                    seeds)
    states, mets = [harness.host_states(state, seeds, seeds > 1)], []
    for _ in range(3):
        state, m = chunk(state, batch, 1)
        mets.append(harness.seed_metrics(m, seeds))
        states.append(harness.host_states(state, seeds, seeds > 1))
    obs = check.Observed(x=x, modes=batch["pod_modes"], states=[[st[s] for st in states] for s in range(seeds)],
                         metrics=[[mm[s] for mm in mets] for s in range(seeds)])
    rc = dict(cfg.__dict__)
    numbers = check.compare(obs, rc, [(cfg.beta, cfg.l1_lambda)] * seeds, "desmo", 11)
    assert numbers["pod"] == 0.0 and numbers["init"] == 0.0
    assert numbers["loss"] < 1e-5 and numbers["ortho"] < 1e-6
    assert numbers["grad"] < 1e-5 and numbers["update"] < 1e-5
