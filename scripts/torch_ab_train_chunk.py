#!/usr/bin/env python3
"""Compare two versions of the port's mega-kernel on one GPU, in turns.

    git show <rev>:desmo_tpu_torch/csrc/train_chunk.cu > build/train_chunk_a.cu
    python3 scripts/torch_ab_train_chunk.py build/train_chunk_a.cu

    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 scripts/torch_ab_train_chunk.py build/parent [--preset fourier_cylinder] [--eager]
    python3 scripts/torch_ab_train_chunk.py build/parent \
        --preset cylinder,fourier_cylinder,aneurysm,aneurysm:4,fourier_cylinder:8

Version B is this checkout. Version A is either a kernel source with the
checkout's C interface, compiled by the script itself into ``build/ab/``
with the kernels' own nvcc flags, or a directory holding another checkout,
whose package builds and launches its own kernel (any C interface; the
preset must be one that checkout runs).

On a preset at full width (default cylinder: n=3961, m=1001, r=4, P=3;
synthetic data, the preset's init), the script runs one 2,000-epoch chunk of
each version in the order A, B, B, A and prints each launch's µs per epoch
and its phase split from the kernel's own clock. ``--preset`` takes a
comma-separated list of cells, each a preset or ``preset:S`` for S seeds
packed as ``ensemble.fit`` packs them (the packed form); in directory mode
each turn runs every cell in turn. For a kernel source it then
prints how far B's metrics trace and params lie from A's after 200 epochs at
omega_init=1 and lr_omega=1. With ``--eager`` (directory mode only) each
turn times the eager loop instead (``chunk_method="scan"``, the fused loss
through the dual-contraction kernel): µs per step on the host's clock over
``--steps`` epochs, after 10 warm-up epochs. Prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

STEPS = 2000
PARITY_STEPS = 200
ROOT = Path(__file__).resolve().parents[1]


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


def problem(cell: str, **over):
    """``(cfg, spec, batch, state)`` of the cell ``preset`` or ``preset:S``
    at full width on the card, through the package on ``sys.path``: the
    preset's init, or S seeds packed as ``ensemble.fit`` packs them."""
    from desmo_tpu_torch import configs, device as device_mod, pod, runner, train
    from desmo_tpu_torch.models import desmo

    preset, _, seeds = cell.partition(":")
    dev = device_mod.resolve("cuda")
    cfg = dataclasses.replace(configs.get(preset), **over)
    x, _ = runner.load_data(cfg, synthetic=True)
    batch = runner.prepare_batch(x, pod.pod_host(x, cfg.r, dev).modes, dev)
    if cfg.variant == "fourier":
        from desmo_tpu_torch.models import fourier

        spec = fourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier,
                                   cfg.period_init)
        params = fourier.Fourier(spec, device=dev).params()
    else:
        spec = desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
        params = desmo.Desmo(spec, device=dev).params()
    if seeds:
        from desmo_tpu_torch import ensemble

        S = int(seeds)
        params = ensemble.init_params(spec, S, seed=cfg.seed, phi_sigma=cfg.seed_phi_sigma,
                                      omega_spread=cfg.seed_omega_spread, device=dev)
        return cfg, spec, batch, ensemble.init_state(params, cfg, S)
    return cfg, spec, batch, train.init_state(params, cfg)


def split_line(name: str, split: dict, steps: int) -> str:
    total = sum(split.values())
    return (f"{name}: {total * 1e6 / steps:.1f} us/epoch over {steps} epochs; "
            + ", ".join(f"{k} {v * 1e6 / steps:.1f}" for k, v in split.items() if k != "prologue")
            + f" us/epoch; prologue {split['prologue'] * 1e6:.1f} us")


def time_tree(name: str, tree: str, cells: str, steps: int) -> None:
    """One chunk of the checkout at ``tree`` per cell (this process imports
    its package)."""
    sys.path.insert(0, tree)
    from desmo_tpu_torch.kernels import train_chunk

    if not train_chunk.__file__.startswith(tree):
        raise RuntimeError(f"imported {train_chunk.__file__}, not the package under {tree}")
    for cell in cells.split(","):
        cfg, spec, batch, state = problem(cell)
        print(split_line(f"{cell} {name}", train_chunk.phase_split(state, batch, steps, spec, cfg), steps),
              flush=True)


def time_eager(name: str, tree: str, preset: str, steps: int) -> None:
    """The eager loop of the checkout at ``tree`` (this process imports its
    package), timed on the host's clock: the loop is bound by the host's
    issue of its operations."""
    sys.path.insert(0, tree)
    import torch

    from desmo_tpu_torch import configs, device as device_mod, pod, runner, train

    if not train.__file__.startswith(tree):
        raise RuntimeError(f"imported {train.__file__}, not the package under {tree}")
    dev = device_mod.resolve("cuda")
    cfg = dataclasses.replace(configs.get(preset), chunk_method="scan", loss_method="fused")
    x, _ = runner.load_data(cfg, synthetic=True)
    batch = runner.prepare_batch(x, pod.pod_host(x, cfg.r, dev).modes, dev)
    _, params, loss_fn, groups = runner.build_model(cfg, dev)
    chunk = train.make_train_chunk(loss_fn, groups, cfg)
    state = train.init_state(params, cfg)
    chunk(state, batch, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk(state, batch, steps)
    torch.cuda.synchronize()
    print(f"{name}: eager loop {(time.perf_counter() - t0) * 1e6 / steps:.1f} us/step over {steps} epochs",
          flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("other", help="version A: a kernel source, or a directory holding another checkout")
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--preset", default="cylinder")
    parser.add_argument("--eager", action="store_true", help="time the eager loop (directory mode)")
    parser.add_argument("--as", dest="name", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if args.name is not None:  # one turn of the directory mode, in a process of its own
        (time_eager if args.eager else time_tree)(args.name, os.path.abspath(args.other), args.preset, args.steps)
        return 0

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if os.path.isdir(args.other):
        trees = {"A": os.path.abspath(args.other), "B": str(ROOT)}
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        for name in ("A", "B", "B", "A"):
            subprocess.run([sys.executable, __file__, trees[name], "--as", name, "--preset", args.preset,
                            "--steps", str(args.steps)] + ["--eager"] * args.eager, check=True, env=env)
        return 0
    if args.eager:
        parser.error("--eager needs a directory holding another checkout")

    sys.path.insert(0, str(ROOT))
    import torch

    from desmo_tpu_torch.kernels import train_chunk

    libs = {"A": train_chunk._bind(build_other(args.other)), "B": train_chunk._lib()}
    cfg, spec, batch, state = problem(args.preset)
    for name in ("A", "B", "B", "A"):
        with launching(libs[name]):
            print(split_line(name, train_chunk.phase_split(state, batch, args.steps, spec, cfg), args.steps))

    # B against A where the dynamics are tame: omega_init=1, lr_omega=1
    unit, unit_spec, _, unit_state = problem(args.preset, omega_init=1.0, lr_omega=1.0)
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
