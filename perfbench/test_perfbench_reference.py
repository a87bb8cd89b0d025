"""The plain references (``perfbench/reference/desmo.py``, ``fourier.py``
and ``ae.py``) against the port's CPU plain chunks at a tiny size, and the
references' own conventions against the port's (term order, the packed
seeds' initial draws, the AE's init, the POD, the series' time points, the
exports' keys)."""

import numpy as np
import pytest
import torch

from desmo_tpu_torch import checkpoint, configs, ensemble, library, pod, runner, train
from desmo_tpu_torch.kernels import ae_chunk
from desmo_tpu_torch.kernels import train_chunk as tc
from desmo_tpu_torch.models import autoencoder
from perfbench import check, harness, synthetic
from perfbench.reference import ae as aref
from perfbench.reference import desmo as ref
from perfbench.reference import fourier as fref

N, M = 300, 60


@pytest.mark.parametrize("r,p", [(4, 3), (4, 2), (2, 2)])
def test_monomials_follow_the_library_order(r, p):
    table = library.factor_table(r, p)
    want = [tuple(int(v) - 1 for v in row if v > 0) for row in table]
    assert ref.monomials(r, p) == want
    assert ref.num_terms(r, p) == library.num_poly_terms(r, p) + 3 * r


@pytest.mark.parametrize("preset,module", [("aneurysm", ref), ("fourier_cylinder", fref)])
def test_seed_params_are_the_packed_seeds_initial_draws(preset, module):
    cfg = configs.get(preset)
    spec = runner.build_model(cfg, torch.device("cpu"))[0]
    prog = ensemble.init_params(spec, 4, seed=2**33 + 5, phi_sigma=0.02)
    want = module.seed_params(dict(cfg.__dict__, seed_phi_sigma=0.02), 4, 2**33 + 5, "cpu")
    assert set(prog) == set(module.LEAVES)
    for s in range(4):
        for k in module.LEAVES:
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


def _problem(omega_init: float, lr_omega: float, seeds: int = 1, preset: str = "cylinder"):
    cfg = dict(configs.get(preset).__dict__)
    cfg.update(n=N, m=M, omega_init=omega_init, lr_omega=lr_omega, chunk_method="megakernel", n_seeds=seeds)
    cfg = configs.RunConfig(**cfg)
    x = synthetic.wake(N, M, 7, "cpu")
    p, _ = runner.compute_pod(cfg, x.numpy(), torch.device("cpu"))
    batch = runner.prepare_batch(x.numpy(), None if cfg.variant == "ae" else p.modes, torch.device("cpu"))
    spec, params, _, _ = runner.build_model(cfg, torch.device("cpu"))
    return cfg, spec, batch, params, x, p.modes


def test_three_reference_epochs_follow_the_plain_chunk():
    """At omega_init=1 two float32 orders stay together: the reference's own
    trajectory holds the plain chunk's state and metrics tightly."""
    cfg, spec, batch, params, x, modes = _problem(1.0, 1.0)
    state = train.init_state(params, cfg)
    st = ref.initial_state(ref.initial_params(cfg.__dict__, "cpu"), cfg.group_lrs)
    for _ in range(3):
        state, mets = tc.fused_train_chunk(state, batch, 1, spec, cfg)
        m_ref, _, st = ref.epoch(st, x, modes, cfg.__dict__, cfg.beta, cfg.l1_lambda)
        for key in ("rec", "l1", "total"):
            assert float(mets[key][0]) == pytest.approx(m_ref[key], rel=2e-6)
        assert float(mets["ortho"][0]) == pytest.approx(m_ref["ortho"], abs=1e-6)
        for k in ref.LEAVES:
            np.testing.assert_allclose(state.params[k].numpy(), st["params"][k].numpy(), rtol=1e-5, atol=1e-6)
    assert state.epoch == st["epoch"] == 3 and state.count == st["count"] == 3


@pytest.mark.parametrize("preset,reference,seeds", [
    ("cylinder", "desmo", 1), ("cylinder", "desmo", 2), ("fourier_cylinder", "fourier", 1),
    ("fourier_cylinder", "fourier", 2), ("ae_cylinder", "ae", 1)])
def test_check_reads_the_plain_chunk_as_the_reference_at_the_preset_omega(seeds, preset, reference):
    """At omega_init=1e4 the check follows the program step by step: the
    plain chunk reads within float32 rounding on every number, one seed or
    packed, desmo, Fourier or AE."""
    cfg, spec, batch, params, x, modes = _problem(1e4, configs.get(preset).lr_omega, seeds, preset)
    module = check.reference_module(reference)
    if seeds == 1:
        chunk = tc.select_chunk(spec, cfg, torch.device("cpu"))
        state = train.init_state(params, cfg)
    else:
        chunk = tc.select_ensemble_chunk(spec, cfg, seeds, torch.device("cpu"))
        state = ensemble.init_state(ensemble.init_params(spec, seeds, seed=11, phi_sigma=cfg.seed_phi_sigma), cfg,
                                    seeds)
    states, mets = [harness.host_states(state, seeds, seeds > 1, module.LEAVES)], []
    for _ in range(3):
        state, m = chunk(state, batch, 1)
        mets.append(harness.seed_metrics(m, seeds, module.METRICS))
        states.append(harness.host_states(state, seeds, seeds > 1, module.LEAVES))
    obs = check.Observed(x=x, modes=modes, states=[[st[s] for st in states] for s in range(seeds)],
                         metrics=[[mm[s] for mm in mets] for s in range(seeds)])
    rc = dict(cfg.__dict__)
    numbers = check.compare(obs, rc, [(cfg.beta, cfg.l1_lambda)] * seeds, reference, cfg.seed if seeds == 1 else 11)
    assert numbers["pod"] == 0.0 and numbers["init"] == 0.0
    assert numbers["loss"] < 1e-5 and numbers["ortho"] < 1e-6
    assert numbers["grad"] < 1e-5 and numbers["update"] < 1e-5


def test_three_fourier_reference_epochs_follow_the_plain_chunk():
    """The Fourier reference's own trajectory against the plain chunk's
    Fourier form at omega_init=1: B from the series formed directly on
    ``torch.linspace`` against the chunk's recurrence on ``t_points``, the
    periods stepped in their own group."""
    cfg, spec, batch, params, x, modes = _problem(1.0, 1.0, preset="fourier_cylinder")
    state = train.init_state(params, cfg)
    st = fref.initial_state(fref.initial_params(cfg.__dict__, "cpu"), cfg.group_lrs)
    for _ in range(3):
        state, mets = tc.fused_train_chunk(state, batch, 1, spec, cfg)
        m_ref, _, st = fref.epoch(st, x, modes, cfg.__dict__, cfg.beta, cfg.l1_lambda)
        for key in ("rec", "l1", "total"):
            assert float(mets[key][0]) == pytest.approx(m_ref[key], rel=2e-6)
        assert float(mets["ortho"][0]) == pytest.approx(m_ref["ortho"], abs=1e-6)
        for k in fref.LEAVES:
            np.testing.assert_allclose(state.params[k].numpy(), st["params"][k].numpy(), rtol=1e-5, atol=1e-6)
    assert state.epoch == st["epoch"] == 3 and state.count == st["count"] == 3
    assert not torch.equal(st["params"]["period"], fref.initial_params(cfg.__dict__, "cpu")["period"])


def test_the_series_time_points_are_linspace_rounded_once():
    """The reference's t is the points j m / (m - 1) each rounded once to
    float32, as NumPy's float32 linspace and the program's ``t_points`` have
    them; the script's ``torch.linspace(0, m, m)`` in float32 lies within one
    float32 step of them."""
    from desmo_tpu_torch.models import fourier as prog_fourier

    for m in (80, 1001):
        t = fref.t_points(m, "cpu")
        exact = np.arange(m, dtype=np.float64) * (m / (m - 1))
        assert np.array_equal(t.numpy(), exact.astype(np.float32))
        assert np.array_equal(t.numpy(), prog_fourier.t_points(m))
        np.testing.assert_allclose(torch.linspace(0, m, m).numpy(), t.numpy(), rtol=2.0**-23, atol=0)


@pytest.mark.parametrize("seed", [43, 2**33 + 5])
def test_ae_seed_params_are_the_programs_init(seed):
    """The AE reference's Xavier/zero-bias draws equal the program's
    ``autoencoder.init_params`` bit for bit, at the published (n, m)."""
    cfg = configs.get("ae_cylinder")
    spec = runner.build_model(cfg, torch.device("cpu"))[0]
    prog = autoencoder.init_params(spec, seed=seed)
    (want,) = aref.seed_params(cfg.__dict__, 1, seed, "cpu")
    assert list(prog) == list(aref.LEAVES)
    for k in aref.LEAVES:
        assert torch.equal(prog[k], want[k]), k
    with pytest.raises(ValueError):
        aref.seed_params(cfg.__dict__, 2, seed, "cpu")


def test_three_ae_reference_epochs_follow_the_plain_chunk():
    """At omega_init=1 the AE reference's own trajectory (direct residuals,
    autograd) holds the plain chunk's (factored residuals, analytic
    gradients) state and metrics, the decoder's ae among them, to float32
    rounding as it grows: the ReLU funnel at its LR of 1e-2 moves far each
    epoch (rec 8.9, 1.6, 39.3 here), and the two orders part by 4e-7, 2.4e-6
    and 5.7e-6 of rec over the three epochs; a wrong term parts by far
    more."""
    cfg, spec, batch, params, x, modes = _problem(1.0, 1.0, preset="ae_cylinder")
    state = train.init_state(params, cfg)
    st = aref.initial_state(aref.initial_params(cfg.__dict__, cfg.seed, "cpu"), cfg.group_lrs)
    for _ in range(3):
        state, mets = ae_chunk.ae_chunk_plain(state, batch, 1, spec, cfg)
        m_ref, _, st = aref.epoch(st, x, modes, cfg.__dict__, cfg.beta, cfg.l1_lambda)
        for key in aref.METRICS:
            assert float(mets[key][0]) == pytest.approx(m_ref[key], rel=2e-5), key
        for k in aref.LEAVES:
            np.testing.assert_allclose(state.params[k].numpy(), st["params"][k].numpy(), rtol=1e-4, atol=1e-6)
    assert state.epoch == st["epoch"] == 3 and state.count == st["count"] == 3
    for k in ("c_trig", "z_trig", "omega"):  # the tanh channel is out of the loss
        assert torch.equal(st["params"][k][2], aref.initial_params(cfg.__dict__, cfg.seed, "cpu")[k][2]), k


@pytest.mark.parametrize("preset,module", [("cylinder", ref), ("fourier_cylinder", fref), ("ae_cylinder", aref)])
def test_pt_params_read_the_programs_export_exactly(tmp_path, preset, module):
    """Each reference's ``.pt`` key scheme reads back the leaves the program
    exported (``checkpoint.save_pt``), bit for bit."""
    cfg = configs.RunConfig(**dict(configs.get(preset).__dict__, n=N, m=M))
    params = runner.build_model(cfg, torch.device("cpu"))[1]
    gen = torch.Generator().manual_seed(3)
    params = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    path = str(tmp_path / "p.pt")
    checkpoint.save_pt(path, checkpoint.state_dict_from_params(params, cfg.variant))
    got = module.pt_params(torch.load(path, map_location="cpu", weights_only=True))
    assert set(got) == set(module.LEAVES)
    for k in module.LEAVES:
        assert np.array_equal(got[k], params[k].numpy()), k

