"""The device POD (``desmo_tpu_torch.pod``) against ``desmo_tpu.pod`` on the
same numpy inputs, and the run → evaluate round trip under each device
method (``runner.compute_pod``)."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from desmo_tpu import configs as jconfigs  # noqa: E402
from desmo_tpu import pod as jpod  # noqa: E402
from desmo_tpu.io import synthetic  # noqa: E402
from desmo_tpu_torch import configs, pod, runner  # noqa: E402


def _decaying(n=300, m=40, k=6, seed=0):
    """Centred data whose leading singular values are well apart, so that
    each mode is fixed to rounding (up to its sign)."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n, k)))
    v, _ = np.linalg.qr(rng.standard_normal((m, k)))
    s = 10.0 * 0.5 ** np.arange(k)
    return ((u * s) @ v.T).astype(np.float32)


def _host(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("method", ["snapshots", "svd"])
def test_device_pod_with_canonical_signs_matches_jax(method):
    x = _decaying()
    r = 4
    ref = jpod.canonical_signs(jpod.pod(x, r, method=method))
    ours = pod.canonical_signs(pod.pod(x, r, method=method, device="cpu"))
    modes = np.asarray(ref.modes)
    np.testing.assert_allclose(_host(ours.modes), modes, rtol=0, atol=1e-5 * np.abs(modes).max())
    np.testing.assert_allclose(_host(ours.singular_values), np.asarray(ref.singular_values), rtol=1e-5)
    np.testing.assert_allclose(_host(ours.temporal), np.asarray(ref.temporal), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_host(ours.energy), np.asarray(ref.energy), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_host(ours.reconstruction), np.asarray(ref.reconstruction), rtol=0,
                               atol=1e-5 * np.abs(x).max())
    assert pod.pod_relative_error(x, ours) == pytest.approx(jpod.pod_relative_error(x, ref), rel=1e-5)


def test_auto_method_picks_as_jax():
    """'auto' is the method of snapshots for tall X and the SVD for wide X."""
    for shape in ((300, 40), (30, 60)):
        x = _decaying(*shape, k=5)
        ref = jpod.canonical_signs(jpod.pod(x, 3))
        ours = pod.canonical_signs(pod.pod(x, 3, device="cpu"))
        np.testing.assert_allclose(_host(ours.singular_values), np.asarray(ref.singular_values), rtol=1e-5)
        np.testing.assert_allclose(_host(ours.modes), np.asarray(ref.modes), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="unknown POD method"):
        pod.pod(x, 3, method="streaming", device="cpu")


def test_randomized_pod_matches_exact_on_decaying_spectrum():
    """The range finder against the exact truncated SVD, at the tolerances
    of ``tests/test_pod.py``: singular values, each mode up to its sign, the
    reconstruction, the energy identity and orthonormal modes. The sketch
    is drawn from ``torch.Generator``, so its numbers are not
    ``jax.random``'s."""
    x = synthetic.separable_rank_k(300, 80, k=10, seed=3).astype(np.float64)
    x += 1e-4 * np.random.default_rng(0).standard_normal(x.shape)
    r = 4
    exact = jpod.pod_numpy(x, r)
    res = pod.randomized_pod(x, r, oversample=8, n_iter=2, seed=0, device="cpu")
    np.testing.assert_allclose(_host(res.singular_values), exact[3], rtol=1e-3)
    got = _host(res.modes)
    for i in range(r):
        dot = abs(float(got[:, i] @ exact[1][:, i]))
        assert dot > 1 - 1e-3, f"mode {i} misaligned: |dot|={dot}"
    np.testing.assert_allclose(_host(res.reconstruction), exact[0], rtol=5e-3, atol=5e-4)
    err_mat = pod.pod_relative_error(x, res)
    err_fac = float(np.sqrt(max(0.0, 1.0 - np.sum(_host(res.energy)[:r]))))
    assert abs(err_mat - err_fac) < 1e-3
    np.testing.assert_allclose(got.T @ got, np.eye(r), atol=1e-5)
    # the dispatch, and the same sketch for the same seed
    again = pod.pod(x, r, method="randomized", device="cpu")
    assert torch.equal(again.modes, res.modes)


def test_randomized_pod_rank_deficient_data():
    """Exactly low-rank data with the sketch wider than its rank: the
    shifted CholeskyQR keeps every output finite, the leading modes exact
    and the tail singular values near zero (``tests/test_pod.py:291``)."""
    x = synthetic.separable_rank_k(60, 40, k=2, seed=0).astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    res = pod.randomized_pod(x, 4, device="cpu")  # k = 12 >> rank 2
    for a in (res.modes, res.temporal, res.singular_values, res.energy, res.reconstruction):
        assert torch.isfinite(a).all()
    s = _host(res.singular_values)
    exact = np.linalg.svd(x, compute_uv=False)
    np.testing.assert_allclose(s[:2], exact[:2], rtol=1e-3)
    assert s[2] < 1e-3 * s[0]
    assert pod.pod_relative_error(x, res) < 1e-3


def test_cholesky_qr2_matches_jax():
    from desmo_tpu.pod import _cholesky_qr2 as jqr2

    import jax

    y = np.random.default_rng(2).standard_normal((200, 12)).astype(np.float32)
    ref = np.asarray(jqr2(jax.numpy.asarray(y), jax.lax.Precision.HIGHEST))
    ours = _host(pod._cholesky_qr2(torch.as_tensor(y)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours.T @ ours, np.eye(12), atol=1e-5)


def test_sign_align_and_canonical_signs_match_jax():
    x = _decaying(k=5)
    host = jpod.pod_host(x, 3)
    flipped_modes = np.asarray(host.modes) * np.array([-1.0, 1.0, -1.0], np.float32)
    base = pod.pod_host(x, 3, "cpu")
    ours_flip = dataclasses.replace(base, modes=torch.as_tensor(flipped_modes),
                                    temporal=base.temporal * torch.tensor([-1.0, 1.0, -1.0])[:, None])
    ref_flip = dataclasses.replace(host, modes=jax_array(flipped_modes),
                                   temporal=host.temporal * jax_array([-1.0, 1.0, -1.0])[:, None])
    aligned = pod.sign_align(ours_flip, base.modes)
    ref_aligned = jpod.sign_align(ref_flip, host.modes)
    np.testing.assert_array_equal(_host(aligned.modes), np.asarray(ref_aligned.modes))
    np.testing.assert_array_equal(_host(aligned.temporal), np.asarray(ref_aligned.temporal))
    np.testing.assert_array_equal(_host(aligned.modes), _host(base.modes))
    canon = pod.canonical_signs(ours_flip)
    ref_canon = jpod.canonical_signs(ref_flip)
    np.testing.assert_array_equal(_host(canon.modes), np.asarray(ref_canon.modes))
    np.testing.assert_array_equal(_host(canon.temporal), np.asarray(ref_canon.temporal))
    # a data-only convention: both sign patterns land on the same modes
    np.testing.assert_array_equal(_host(pod.canonical_signs(base).modes), _host(canon.modes))
    assert canon.reconstruction is ours_flip.reconstruction


def jax_array(a):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(a, np.float32))


def test_rank_sweep_matches_jax():
    x = _decaying(k=6)
    ref = jpod.rank_sweep(x, 5)
    ours = pod.rank_sweep(x, 5, device="cpu")
    assert [r for r, _ in ours] == [r for r, _ in ref]
    np.testing.assert_allclose([e for _, e in ours], [e for _, e in ref], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("method", ["snapshots", "svd", "randomized"])
def test_compute_pod_matches_jax(method):
    cfg = dataclasses.replace(configs.get("cylinder"), r=2, pod_method=method)
    x = _decaying(k=6)
    from desmo_tpu import runner as jrunner

    p, p2 = runner.compute_pod(cfg, x, torch.device("cpu"))
    jp, jp2 = jrunner.compute_pod(jconfigs.RunConfig(**dataclasses.asdict(cfg)), x)
    assert p.modes.shape == (300, 2) and p2.modes.shape == (300, 4)
    if method == "randomized":  # different sketches: the same subspace
        np.testing.assert_allclose(_host(p2.singular_values), np.asarray(jp2.singular_values), rtol=1e-4)
        np.testing.assert_allclose(_host(p.modes), np.asarray(jp.modes), rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(_host(p2.singular_values), np.asarray(jp2.singular_values), rtol=1e-5)
        np.testing.assert_allclose(_host(p.modes), np.asarray(jp.modes), rtol=0, atol=1e-5)
    # the same device rebuilds the same bits: what evaluate relies on
    q, _ = runner.compute_pod(cfg, x, torch.device("cpu"))
    assert torch.equal(q.modes, p.modes)


@pytest.mark.parametrize("method", ["snapshots", "svd", "randomized"])
def test_run_evaluate_roundtrip_device_pod(tmp_path, method):
    """A run with a device POD and the evaluate of its final checkpoint
    with the same method rebuild the same modes, so the errors are equal
    (``tests/test_runner.py:347``); the host POD, whose signs may differ,
    pairs the masks with other modes."""
    cfg = dataclasses.replace(
        configs.get("cylinder"), name="tiny", r=2, poly_order=2, omega_init=1.0, lr_omega=1.0, num_epochs=60,
        checkpoint_every=60, pod_method=method, chunk_method="scan",
    )
    x = synthetic.separable_rank_k(60, 40, k=2, seed=0)
    x -= x.mean(axis=1, keepdims=True)
    art = runner.run(cfg, x, out_dir=str(tmp_path), echo=False, device="cpu")
    pt = os.path.join(art.out_dir, "tiny_r2_final.pt")
    rep = runner.evaluate(cfg, x, pt, echo=False, device="cpu")
    assert np.isfinite(rep["relative_error"])
    assert rep["relative_error"] == art.relative_error
    assert rep["pod_error_r"] == art.pod_error_r
    assert [e[1:] for e in rep["sweep"]] == [(e.error, e.nonzero_terms) for e in art.sweep]
