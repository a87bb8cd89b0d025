"""The one place that resolves the torch device.

There is no silent CPU path: asking for ``cuda`` on a machine without a GPU
raises. The CPU runs only when it is asked for by name (``--device cpu``), and
then every kernel wrapper takes its plain PyTorch twin.
"""

from __future__ import annotations

import torch


def fp32_matmul() -> None:
    """Run float32 matrix products in full float32 (no TF32), for matmul and
    cuDNN both. The X-cancellation terms of the factored MSE need about 5e-6
    relative accuracy; TF32 keeps about 1e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(name: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``name`` (``"cuda"``, ``"cuda:1"`` or ``"cpu"``).

    Raises ``RuntimeError`` when a CUDA device is asked for and none is
    available, and ``ValueError`` for any other device type."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass --device cpu to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    fp32_matmul()
    return dev
