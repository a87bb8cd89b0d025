"""The port's dual-contraction module against the JAX Pallas kernels (run in
interpret mode, as ``tests/test_pallas.py`` runs them), and the CUDA source
run on an emulated grid. The CUDA kernel itself is held against its twin on
the card by ``tests/test_torch_gpu.py``."""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from desmo_tpu import losses as jlosses  # noqa: E402
from desmo_tpu.pallas import (  # noqa: E402
    dual_contractions as jdual,
    dual_contractions_split as jdual_split,
    factored_mse_fused_split as jfused_split,
    split_snapshots,
)
from desmo_tpu_torch import losses  # noqa: E402
from desmo_tpu_torch.kernels import _build, dual_gemm  # noqa: E402

SHAPES = [(100, 7, 50), (512, 47, 128), (700, 50, 333)]


def _inputs(n, k, m, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    a = (scale * rng.standard_normal((n, k))).astype(np.float32)
    b = (scale * rng.standard_normal((k, m))).astype(np.float32)
    x = rng.standard_normal((n, m)).astype(np.float32)
    return a, b, x


@pytest.mark.parametrize("n,k,m", SHAPES)
def test_dual_contractions_match_jax_kernels(n, k, m):
    a, b, x = _inputs(n, k, m)
    ax, xb = dual_gemm.dual_contractions(*map(torch.as_tensor, (a, b, x)))
    assert ax.shape == (k, m) and xb.shape == (n, k)
    for ref_ax, ref_xb in (
        jdual(jnp.asarray(a), jnp.asarray(b), jnp.asarray(x), interpret=True),
        jdual_split(jnp.asarray(a), jnp.asarray(b), *split_snapshots(jnp.asarray(x)), interpret=True),
    ):
        # the Pallas kernels are 3-pass bf16, fp32-grade vs the matrix norm
        ref_ax, ref_xb = np.asarray(ref_ax), np.asarray(ref_xb)
        assert np.abs(ax.numpy() - ref_ax).max() < 5e-5 * np.abs(ref_ax).max()
        assert np.abs(xb.numpy() - ref_xb).max() < 5e-5 * np.abs(ref_xb).max()


def test_factored_mse_fused_matches_jax_split_kernel():
    a, b, x = _inputs(300, 11, 90, seed=1, scale=0.3)
    x_sq = np.float32(np.sum(x.astype(np.float64) ** 2))
    ta = torch.as_tensor(a).requires_grad_(True)
    tb = torch.as_tensor(b).requires_grad_(True)
    val = dual_gemm.factored_mse_fused(ta, tb, torch.as_tensor(x), torch.as_tensor(x_sq))
    da, db = torch.autograd.grad(val, (ta, tb))

    xh, xl = split_snapshots(jnp.asarray(x))

    def jval(a, b):
        return jfused_split(a, b, xh, xl, jnp.asarray(x_sq), True)

    ref = float(jval(jnp.asarray(a), jnp.asarray(b)))
    ref_grads = jax.grad(jval, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(val.item(), ref, rtol=1e-4)
    np.testing.assert_allclose(val.item(), float(jlosses.mse(a @ b, x)), rtol=1e-3)
    for g, gr in zip((da, db), ref_grads):
        gr = np.asarray(gr)
        assert np.abs(g.numpy() - gr).max() < 2e-4 * np.abs(gr).max()


def test_fused_backward_matches_autograd_of_factored_mse():
    a, b, x = _inputs(200, 13, 70, seed=2, scale=0.3)
    tx = torch.as_tensor(x)
    grads = []
    for fn in (
        lambda a, b: dual_gemm.factored_mse_fused(a, b, tx, torch.sum(tx * tx)),
        lambda a, b: losses.factored_mse(a, b, tx),
    ):
        ta = torch.as_tensor(a).requires_grad_(True)
        tb = torch.as_tensor(b).requires_grad_(True)
        grads.append(torch.autograd.grad(fn(ta, tb), (ta, tb)))
    for g, gr in zip(*grads):
        assert torch.abs(g - gr).max() < 1e-5 * torch.abs(gr).max()


def test_cpu_takes_the_twin_and_counts_no_launch():
    before = dual_gemm.dual_contractions.launches
    a, b, x = map(torch.as_tensor, _inputs(64, 5, 33, seed=3))
    ax, xb = dual_gemm.dual_contractions(a, b, x)
    pax, pxb = dual_gemm.dual_contractions_plain(a, b, x)
    assert torch.equal(ax, pax) and torch.equal(xb, pxb)
    assert dual_gemm.dual_contractions.launches == before == 0


@pytest.mark.parametrize(
    "bad",
    [
        lambda a, b, x: (a.double(), b, x),
        lambda a, b, x: (a, b[:, :-1], x),
        lambda a, b, x: (a, b, x.T.contiguous().T),
    ],
)
def test_wrapper_rejects_malformed_inputs(bad):
    a, b, x = map(torch.as_tensor, _inputs(40, 4, 30, seed=4))
    with pytest.raises(ValueError):
        dual_gemm.dual_contractions(*bad(a, b, x))


@pytest.mark.parametrize("compiler", ["false", "no-such-nvcc"])
def test_failed_build_raises(monkeypatch, tmp_path, compiler):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: shutil.which(compiler) or str(tmp_path / compiler))
    with pytest.raises(RuntimeError):
        _build.build("dual_gemm")
    assert not list(tmp_path.glob("*.so"))


EMULATION = Path(__file__).parent / "cuda_emulation"


@pytest.fixture(scope="module")
def emulated_dual_gemm(tmp_path_factory):
    """``csrc/dual_gemm.cu`` compiled by the host C++ compiler against
    ``tests/cuda_emulation``: one OS thread per CUDA thread, a barrier per
    block. It checks the kernels' indexing, masking and fixed-order
    reductions without a GPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA source for the emulated grid")
    src = (_build.CSRC / "dual_gemm.cu").read_text()
    out = tmp_path_factory.mktemp("dual_gemm_emulated")
    cpp = out / "dual_gemm_emulated.cpp"
    cpp.write_text(re.sub(r"<<<[^>]*>>>", "", src) + '\n#include "harness.inc"\n')
    exe = out / "dual_gemm_emulated"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-I", str(EMULATION), str(cpp), "-o", str(exe)],
        check=True, capture_output=True, timeout=240,
    )
    return exe


@pytest.mark.parametrize(
    "n,m,k",
    # every K template (16/32/48/64/128), ragged rows and columns, one tile
    # and many column splits; the packed widths of the ensemble's eager loss
    # (fourier_cylinder S=8: K'=96; aneurysm S=4: K'=108) and K'=128
    [(5, 3, 1), (64, 33, 16), (33, 257, 32), (130, 70, 47), (97, 40, 64), (700, 333, 50),
     (70, 45, 96), (65, 40, 108), (40, 33, 128)],
)
def test_cuda_source_on_emulated_grid(emulated_dual_gemm, n, m, k):
    proc = subprocess.run(
        [str(emulated_dual_gemm), str(n), str(m), str(k)], capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
