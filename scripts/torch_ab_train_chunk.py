#!/usr/bin/env python3
"""Compare two versions of the port's mega-kernel on one GPU, in turns.

    git show <rev>:desmo_tpu_torch/csrc/train_chunk.cu > build/train_chunk_a.cu
    python3 scripts/torch_ab_train_chunk.py build/train_chunk_a.cu

Compiles ``build/train_chunk_a.cu`` (version A) into ``build/ab/`` with the
kernels' own nvcc flags, and builds the checkout's
``desmo_tpu_torch/csrc/train_chunk.cu`` (version B) as the package does.
Then, on the cylinder preset at full width (n=3961, m=1001, r=4, P=3;
synthetic data, the preset's init), runs one 2,000-epoch chunk of each in the
order A, B, B, A and prints each launch's µs per epoch and its phase split
from the kernel's own clock; then how far B's metrics trace and params lie
from A's after 200 epochs at omega_init=1 and lr_omega=1. Prints the card's
name and power limit first. Version A must have the checkout's C interface.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path
from unittest import mock

STEPS = 2000
PARITY_STEPS = 200
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def build_other(src: str) -> ctypes.CDLL:
    """Version A's library, compiled as ``kernels._build`` compiles the
    checkout's sources."""
    from desmo_tpu_torch.kernels import _build

    out = _build.BUILD_DIR.parent / "ab" / "libtrain_chunk_a.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), src], check=True)
    return ctypes.CDLL(str(out))


@contextlib.contextmanager
def launching(lib: ctypes.CDLL):
    """Route ``fused_train_chunk`` and ``phase_split`` through ``lib``."""
    from desmo_tpu_torch.kernels import train_chunk

    with mock.patch.object(train_chunk, "_lib", lambda: lib):
        train_chunk._grid.cache_clear()
        yield
    train_chunk._grid.cache_clear()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("other", help="the source of version A")
    parser.add_argument("--steps", type=int, default=STEPS)
    args = parser.parse_args(argv)

    import torch

    from desmo_tpu_torch import configs, device as device_mod, pod, runner, train
    from desmo_tpu_torch.kernels import train_chunk
    from desmo_tpu_torch.models import desmo

    dev = device_mod.resolve("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = {"A": train_chunk._bind(build_other(args.other)), "B": train_chunk._lib()}
    cfg = configs.get("cylinder")
    x, _ = runner.load_data(cfg, synthetic=True)
    batch = runner.prepare_batch(x, pod.pod_host(x, cfg.r, dev).modes, dev)
    spec = desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
    state = train.init_state(desmo.Desmo(spec, device=dev).params(), cfg)

    for name in ("A", "B", "B", "A"):
        with launching(libs[name]):
            split = train_chunk.phase_split(state, batch, args.steps, spec, cfg)
        total = sum(split.values())
        print(f"{name}: {total * 1e6 / args.steps:.1f} us/epoch over {args.steps} epochs; "
              + ", ".join(f"{k} {v * 1e6 / args.steps:.1f}" for k, v in split.items() if k != "prologue")
              + f" us/epoch; prologue {split['prologue'] * 1e6:.1f} us")

    # B against A where the dynamics are tame: omega_init=1, lr_omega=1
    unit = dataclasses.replace(cfg, omega_init=1.0, lr_omega=1.0)
    unit_spec = desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, 1.0)
    unit_state = train.init_state(desmo.Desmo(unit_spec, device=dev).params(), unit)
    out = {}
    for name in ("A", "B"):
        with launching(libs[name]):
            out[name] = train_chunk.fused_train_chunk(unit_state, batch, PARITY_STEPS, unit_spec, unit)
    torch.cuda.synchronize()
    (sa, ma), (sb, mb) = out["A"], out["B"]
    trace = max(float(((mb[k] - ma[k]).abs() / ma[k].abs()).max()) for k in ("rec", "l1", "total"))
    params = max(float((sb.params[k] - sa.params[k]).abs().max() / sa.params[k].abs().max()) for k in sa.params)
    print(f"B vs A, omega_init=1 lr_omega=1, {PARITY_STEPS} epochs: trace (rec, l1, total) {trace:.2e}, "
          f"params {params:.2e} of max|param|")
    return 0


if __name__ == "__main__":
    sys.exit(main())
