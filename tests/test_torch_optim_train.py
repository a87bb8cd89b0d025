"""The port's optimizer, scheduler and training loop against ``torch.optim``
and the JAX package (``desmo_tpu.optim``, ``desmo_tpu.train``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from desmo_tpu import checkpoint as jckpt  # noqa: E402
from desmo_tpu import configs  # noqa: E402
from desmo_tpu import optim as joptim  # noqa: E402
from desmo_tpu import train as jtrain  # noqa: E402
from desmo_tpu.models import desmo as jdesmo  # noqa: E402
from desmo_tpu_torch import checkpoint, optim, train  # noqa: E402
from desmo_tpu_torch.models import desmo  # noqa: E402


def test_adamax_matches_torch_and_jax_with_per_element_lrs():
    """Two parameter groups packed in one vector with per-element LRs, 50
    steps on a fixed quadratic + sine."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal(7).astype(np.float32)
    lr_w, lr_v, split = 3e-2, 2.0, 5
    a = rng.standard_normal((split, split)).astype(np.float32)
    target = rng.standard_normal(split).astype(np.float32)

    def loss_of(w, v, lib):
        return lib.sum((lib.asarray(a) @ w - lib.asarray(target)) ** 2) + lib.sum(lib.sin(v))

    # torch.optim reference, two groups
    wt = torch.nn.Parameter(torch.tensor(w0[:split].copy()))
    vt = torch.nn.Parameter(torch.tensor(w0[split:].copy()))
    opt = torch.optim.Adamax([{"params": [wt], "lr": lr_w}, {"params": [vt], "lr": lr_v}], weight_decay=0.0)
    ref = []
    for _ in range(50):
        opt.zero_grad()
        loss_of(wt, vt, torch).backward()
        opt.step()
        ref.append(np.concatenate([wt.detach().numpy(), vt.detach().numpy()]))

    # the port: one packed vector, per-element LRs
    vec = torch.tensor(w0.copy())
    lr = torch.tensor([lr_w] * split + [lr_v] * (7 - split))
    state = optim.adamax_init(vec)
    ours = []
    for _ in range(50):
        leaf = vec.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_of(leaf[:split], leaf[split:], torch), leaf)
        upd, state = optim.adamax_update(g, state, lr)
        vec = vec + upd
        ours.append(vec.numpy().copy())
    np.testing.assert_allclose(np.stack(ours), np.stack(ref), rtol=2e-5, atol=2e-6)

    # the JAX package on the same problem
    params = {"w": jnp.asarray(w0[:split]), "v": jnp.asarray(w0[split:])}
    jstate = joptim.adamax_init(params)
    lr_tree = {"w": jnp.float32(lr_w), "v": jnp.float32(lr_v)}
    grad_fn = jax.jit(jax.grad(lambda p: loss_of(p["w"], p["v"], jnp)))
    update = jax.jit(joptim.adamax_update)
    for _ in range(50):
        upd, jstate = update(grad_fn(params), jstate, lr_tree)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
    jvec = np.concatenate([np.asarray(params["w"]), np.asarray(params["v"])])
    np.testing.assert_allclose(ours[-1], jvec, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("patience", [0, 2, 5])
def test_plateau_matches_torch_and_jax(patience):
    rng = np.random.default_rng(42)
    seq = np.abs(rng.standard_normal(200)).astype(np.float32)
    seq[::7] = seq[::7] * 0.5  # occasional strong improvements

    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adamax([{"params": [p], "lr": 1e-2}, {"params": [], "lr": 1e3}])
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, mode="min", patience=patience, factor=0.1, min_lr=1e-6)
    jstate = joptim.plateau_init(jnp.asarray([1e-2, 1e3]))
    state = optim.plateau_init([1e-2, 1e3], "cpu")
    for v in seq:
        sched.step(float(v))
        jstate = joptim.plateau_step(jstate, jnp.float32(v), patience=patience)
        state = optim.plateau_step(state, torch.tensor(v), patience=patience)
        ref = [g["lr"] for g in opt.param_groups]
        np.testing.assert_allclose(state.lrs.numpy(), ref, rtol=1e-6)
        np.testing.assert_array_equal(state.lrs.numpy(), np.asarray(jstate.lrs))
        assert int(state.num_bad) == int(jstate.num_bad)


def _parity_problem(n=60, m=40, r=2, P=2, steps=300):
    rng = np.random.default_rng(0)
    s = np.linspace(0, 2 * np.pi, n)
    t = np.linspace(0, 6 * np.pi, m)
    x = (np.outer(np.sin(s), np.sin(t)) + 0.5 * np.outer(np.cos(s), np.cos(t))).astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    q, _ = np.linalg.qr(rng.standard_normal((n, r)))
    cfg = configs.RunConfig(
        name="parity", variant="desmo", n=n, m=m, r=r, poly_order=P, omega_init=1.0,
        lr_omega=1.0, num_epochs=steps, patience=20, sched_every=10, log_every=1000,
        checkpoint_every=10_000,
    )
    return cfg, x, q.astype(np.float32)


def test_fit_trace_matches_jax_train_chunk():
    cfg, x, pod_modes = _parity_problem()
    steps = cfg.num_epochs
    jspec = jdesmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
    jparams = jdesmo.init_params(jspec)
    jloss = jdesmo.build_loss(jspec, cfg.beta, cfg.l1_lambda, method="factored")
    chunk = jtrain.make_train_chunk(jloss, jdesmo.param_groups(jparams), cfg)
    jstate = jax.tree.map(jnp.array, jtrain.init_state(jparams, cfg))
    jbatch = {"x": jnp.asarray(x), "pod_modes": jnp.asarray(pod_modes)}
    jstate, jmetrics = chunk(jstate, jbatch, num_steps=steps)

    spec = desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
    params = desmo.Desmo(spec).params()
    batch = {"x": torch.as_tensor(x), "pod_modes": torch.as_tensor(pod_modes)}
    loss_fn = desmo.build_loss(spec, cfg.beta, cfg.l1_lambda, method="factored")
    res = train.fit(loss_fn, desmo.param_groups(params), cfg, params, batch, chunk_size=100, log=None)

    assert res.state.epoch == steps and res.state.count == steps
    for key in ("rec", "ortho", "l1", "total"):
        ref = np.asarray(jmetrics[key])
        # early steps: same semantics, only fp noise; later: accumulated divergence
        np.testing.assert_allclose(res.history[key][:20], ref[:20], rtol=2e-4, err_msg=key)
        np.testing.assert_allclose(res.history[key], ref, rtol=5e-2, err_msg=key)
    np.testing.assert_allclose(res.state.sched.lrs.numpy(), np.asarray(jstate.sched.lrs), rtol=1e-6)
    assert np.isfinite(res.steps_per_sec)


def test_fit_checkpoint_cadence_and_state_file_reads_in_jax(tmp_path):
    cfg, x, pod_modes = _parity_problem(steps=10)
    cfg = configs.RunConfig(**{**cfg.__dict__, "checkpoint_every": 4})
    spec = desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
    params = desmo.Desmo(spec).params()
    batch = {"x": torch.as_tensor(x), "pod_modes": torch.as_tensor(pod_modes)}
    loss_fn = desmo.build_loss(spec, cfg.beta, cfg.l1_lambda)
    seen = []

    def ckpt(state, epoch):
        seen.append((epoch, state.epoch))
        checkpoint.save_state(str(tmp_path / f"state_{epoch}.npz"), state)

    lines = []
    res = train.fit(loss_fn, desmo.param_groups(params), cfg, params, batch, log=lines.append, checkpoint_fn=ckpt)
    assert seen == [(4, 4), (8, 8), (10, 10)]
    assert len(res.history["total"]) == 10
    assert lines[0].startswith("Epoch [1/10], Rec Loss: ") and lines[-1].startswith("Epoch [10/10]")
    # the caller's params are not trained in place
    assert torch.equal(params["phi"], torch.ones_like(params["phi"]))

    jspec = jdesmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
    template = jtrain.init_state(jdesmo.init_params(jspec), cfg)
    loaded = jckpt.load_state(str(tmp_path / "state_10.npz"), template)
    assert int(loaded.epoch) == 10 and int(loaded.opt.count) == 10
    for k, v in res.state.params.items():
        np.testing.assert_array_equal(np.asarray(loaded.params[k]), v.numpy())
        np.testing.assert_array_equal(np.asarray(loaded.opt.nu[k]), res.state.nu[k].numpy())
    np.testing.assert_array_equal(np.asarray(loaded.sched.lrs), res.state.sched.lrs.numpy())


def test_fit_raises_on_nonfinite_loss():
    cfg, x, pod_modes = _parity_problem(steps=6)
    spec = desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
    params = desmo.Desmo(spec).params()
    batch = {"x": torch.as_tensor(x), "pod_modes": torch.as_tensor(pod_modes)}
    inner = desmo.build_loss(spec, cfg.beta, cfg.l1_lambda)
    calls = []

    def loss_fn(p, b):
        total, metrics = inner(p, b)
        calls.append(1)
        return (total * float("nan") if len(calls) >= 4 else total), metrics

    with pytest.raises(FloatingPointError, match="epoch 3"):
        train.fit(loss_fn, desmo.param_groups(params), cfg, params, batch, log=None)
