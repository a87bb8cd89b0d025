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
from desmo_tpu_torch import losses, runner  # noqa: E402
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
        lambda a, b, x: (a, b, torch.as_strided(x, x.shape, (x.shape[1] - 1, 1))),  # rows overlap
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
# seconds for one emulated run: the products are mma.sync's, emulated with a
# barrier over the warp's 32 threads each (about 97,000 at (700, 333, 50),
# 4 s alone on 8 cores, and much longer beside the other test workers)
EMULATED_RUN_TIMEOUT = 600


@pytest.fixture(scope="module")
def emulated_dual_gemm(tmp_path_factory):
    """``csrc/dual_gemm.cu`` compiled by the host C++ compiler against
    ``tests/cuda_emulation`` (and ``csrc`` for its tile headers): one OS
    thread per CUDA thread, a barrier per block and per warp, the
    ``cp.async`` and ``mma.sync`` stand-ins. It checks the kernels'
    indexing, masking and fixed-order reductions without a GPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA source for the emulated grid")
    src = (_build.CSRC / "dual_gemm.cu").read_text()
    out = tmp_path_factory.mktemp("dual_gemm_emulated")
    cpp = out / "dual_gemm_emulated.cpp"
    cpp.write_text(re.sub(r"<<<[^>]*>>>", "", src) + '\n#include "harness.inc"\n')
    exe = out / "dual_gemm_emulated"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-I", str(EMULATION), "-I", str(_build.CSRC), str(cpp), "-o",
         str(exe)],
        check=True, capture_output=True, timeout=240,
    )
    return exe


@pytest.mark.parametrize(
    "n,m,k",
    # every K template (16/32/48/64/128), ragged rows and columns, one tile
    # and many column slabs; the packed widths of the ensemble's eager loss
    # (fourier_cylinder S=8: K'=96; aneurysm S=4: K'=108) and K'=128; then
    # the AᵀX split's edges: n under one xb tile and one row group (20),
    # several ragged row groups at K'=108 and 128, ragged slabs (259 = 2 x
    # 128 + 3, 131), m = 1 and 3 mod 4 (X's and B's rows not 16-byte
    # aligned: the 4-byte copies), K=47 and 33 (A's rows not aligned), and
    # sixteen row groups over two slabs
    [(5, 3, 1), (64, 33, 16), (33, 257, 32), (130, 70, 47), (97, 40, 64), (700, 333, 50),
     (70, 45, 96), (65, 40, 108), (40, 33, 128),
     (20, 9, 12), (300, 41, 108), (257, 259, 128), (190, 131, 47), (129, 7, 33), (1000, 130, 12)],
)
def test_cuda_source_on_emulated_grid(emulated_dual_gemm, n, m, k):
    """The kernels on an emulated grid with the wrapper's plan, run twice:
    ax and xb against float64 at 5e-6 of max|ref|, the two runs bit for bit."""
    proc = subprocess.run(
        [str(emulated_dual_gemm), str(n), str(m), str(k)], capture_output=True, text=True,
        timeout=EMULATED_RUN_TIMEOUT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "n,m,k,ldx",
    # X as a view with its rows apart, the padding NaN: rows of 16 bytes (m =
    # 1 and 3 mod 4, padded to a multiple of 4), and a stride that
    # is not a multiple of 4 (the 4-byte copies)
    [(130, 70, 47, 72), (190, 131, 47, 132), (300, 41, 108, 44), (65, 33, 12, 35)],
)
def test_cuda_source_on_emulated_grid_with_row_stride(emulated_dual_gemm, n, m, k, ldx):
    """The kernels on X whose rows lie ldx floats apart: the padding never
    reaches ax or xb."""
    proc = subprocess.run(
        [str(emulated_dual_gemm), str(n), str(m), str(k), str(ldx)], capture_output=True, text=True,
        timeout=EMULATED_RUN_TIMEOUT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _rows_16b(x: torch.Tensor) -> torch.Tensor:
    """x as a view of a zero-padded copy whose rows lie a multiple of 16
    bytes apart."""
    n, m = x.shape
    xv = torch.zeros((n, (m + 3) // 4 * 4), dtype=x.dtype)[:, :m]
    xv.copy_(x)
    return xv


@pytest.mark.parametrize("m", [33, 35, 36])
def test_wrapper_takes_x_with_rows_apart_on_the_cpu(m):
    """On the CPU the wrapper takes X as a view with its rows apart through
    its plain version: the same bits as contiguous X, and no launch. (The
    kernel's row stride is held on the emulated grid and on the card.)"""
    rng = np.random.default_rng(m)
    a, b, x = (torch.as_tensor(rng.standard_normal(s, dtype=np.float32)) for s in ((20, 7), (7, m), (20, m)))
    xv = _rows_16b(x)
    assert xv.stride() == ((m + 3) // 4 * 4, 1) and torch.equal(xv, x)
    before = dual_gemm.dual_contractions.launches
    ax, xb = dual_gemm.dual_contractions(a, b, x)
    axv, xbv = dual_gemm.dual_contractions(a, b, xv)
    assert torch.equal(ax, axv) and torch.equal(xb, xbv)
    assert dual_gemm.dual_contractions.launches == before


def test_fused_loss_on_aligned_rows_matches_contiguous_x():
    """The fused loss and its gradients on a batch whose X has 16-byte rows
    equal those on contiguous X, through the model's loss and the wrapper's
    plain path (the CPU's; the kernel's row stride is held by
    ``test_cuda_source_on_emulated_grid_with_row_stride`` and, on the card,
    ``test_kernel_on_rows_apart_matches_contiguous``)."""
    from desmo_tpu_torch.models import desmo as desmo_model

    n, m, r = 60, 33, 2
    x = np.random.default_rng(5).standard_normal((n, m)).astype(np.float32)
    pod_modes = torch.as_tensor(np.linalg.svd(x, full_matrices=False)[0][:, :r].copy())
    spec = desmo_model.DesmoSpec(n, m, r, 2, 1.0)
    loss_fn = desmo_model.build_loss(spec, 1e-3, 1e-4, method="fused")
    out = []
    for aligned in (False, True):
        batch = runner.prepare_batch(x, pod_modes, torch.device("cpu"))
        assert batch["x"].is_contiguous()
        if aligned:
            batch["x"] = _rows_16b(batch["x"])
        params = {k: v.clone().requires_grad_(True) for k, v in desmo_model.Desmo(spec).params().items()}
        total, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(total, list(params.values()))
        out.append((total.detach(), {k: v.detach() for k, v in metrics.items()}, grads))
    (t0, m0, g0), (t1, m1, g1) = out
    assert torch.equal(t0, t1) and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(u, v) for u, v in zip(g0, g1))
