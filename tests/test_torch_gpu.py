"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device and skips without one. The module imports
no jax, so it runs on a machine that has none; ``tests/conftest.py`` does
import jax, so run it there with

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q
"""

import pytest

torch = pytest.importorskip("torch")

from desmo_tpu_torch import losses  # noqa: E402
from desmo_tpu_torch.kernels import dual_gemm  # noqa: E402

pytestmark = pytest.mark.gpu

# the shapes of tests/test_torch_dual_gemm.py and the cylinder preset's
SHAPES = [(100, 7, 50), (512, 47, 128), (700, 50, 333), (3961, 47, 1001)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, k, m, device, seed=0, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return tuple(
        (torch.randn(shape, generator=gen) * s).to(device)
        for shape, s in (((n, k), scale), ((k, m), scale), ((n, m), 1.0))
    )


@pytest.mark.parametrize("n,k,m", SHAPES)
def test_kernel_matches_twin(cuda, n, k, m):
    a, b, x = _inputs(n, k, m, cuda)
    launches = dual_gemm.dual_contractions.launches
    ax, xb = dual_gemm.dual_contractions(a, b, x)
    torch.cuda.synchronize()
    assert dual_gemm.dual_contractions.launches == launches + 1
    pax, pxb = dual_gemm.dual_contractions_plain(a, b, x)
    assert (ax - pax).abs().max() <= 5e-5 * pax.abs().max()
    assert (xb - pxb).abs().max() <= 5e-5 * pxb.abs().max()
    ax2, xb2 = dual_gemm.dual_contractions(a, b, x)
    assert torch.equal(ax, ax2) and torch.equal(xb, xb2)  # fixed-order reductions


def test_fused_loss_grads_match_autograd_of_factored_mse(cuda):
    a, b, x = _inputs(3961, 47, 1001, cuda, seed=1, scale=0.3)
    out = []
    for fn in (
        lambda a_, b_: dual_gemm.factored_mse_fused(a_, b_, x, torch.sum(x * x)),
        lambda a_, b_: losses.factored_mse(a_, b_, x),
    ):
        a_, b_ = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        val = fn(a_, b_)
        out.append((val.detach(),) + torch.autograd.grad(val, (a_, b_)))
    (v, da, db), (rv, rda, rdb) = out
    assert abs(float(v - rv)) <= 1e-4 * abs(float(rv))
    assert (da - rda).abs().max() <= 2e-4 * rda.abs().max()
    assert (db - rdb).abs().max() <= 2e-4 * rdb.abs().max()


def test_kernel_rejects_k_above_its_limit(cuda):
    a, b, x = _inputs(64, 65, 32, cuda)
    with pytest.raises(ValueError, match="K=65"):
        dual_gemm.dual_contractions(a, b, x)
