#!/usr/bin/env python3
"""Time two checkouts' dual contraction and AE kernel on one GPU, in turns.

    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 scripts/torch_ab_kernels.py build/parent [--steps 2000]

Version A is the checkout in the directory given, version B this one. Each
turn runs in a process of its own that imports its checkout's package (which
builds its own kernels), in the order A, B, B, A, and prints:

- the dual contraction (``kernels.dual_gemm.dual_contractions``) at the
  eager losses' shapes (n, m, K) = (3961, 1001, 47) (cylinder), (27000, 1000,
  108) (aneurysm with 4 packed seeds) and (3961, 1001, 12) (fourier_cylinder
  and ae_cylinder): µs per call by CUDA events over 200 calls (50 at
  aneurysm), X contiguous, beside the two cuBLAS fp32 products of the plain version
  (``dual_contractions_plain``) timed in the same turn;
- the AE kernel (``kernels.ae_chunk``) at ae_cylinder (n=3961, m=1001, K=12,
  synthetic data, the preset's init): µs per epoch of a ``--steps``-epoch
  launch by CUDA events, and the phase split of another from the kernel's
  own clock (``ae_chunk.phase_split``, block 0).

Prints the card's name and power limit first, and last a table of each
version's two turns.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((3961, 1001, 47), (27000, 1000, 108), (3961, 1001, 12))


def time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def turn(tree: str, steps: int) -> dict:
    """One version's numbers (this process imports the package under ``tree``)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from desmo_tpu_torch import configs, device as device_mod, runner, train
    from desmo_tpu_torch.kernels import ae_chunk, dual_gemm
    from desmo_tpu_torch.models import autoencoder

    if not dual_gemm.__file__.startswith(tree):
        raise RuntimeError(f"imported {dual_gemm.__file__}, not the package under {tree}")
    dev = device_mod.resolve("cuda")
    out: dict = {"dual": {}, "cublas": {}}
    rng = np.random.default_rng(0)
    for n, m, k in SHAPES:
        a, b, x = (torch.as_tensor(rng.standard_normal(s, dtype=np.float32), device=dev)
                    for s in ((n, k), (k, m), (n, m)))
        iters = 50 if n > 10_000 else 200
        out["dual"][str((n, m, k))] = 1e3 * time_ms(lambda: dual_gemm.dual_contractions(a, b, x), iters)
        out["cublas"][str((n, m, k))] = 1e3 * time_ms(lambda: dual_gemm.dual_contractions_plain(a, b, x), iters)
    cfg = configs.get("ae_cylinder")
    x_np, _ = runner.load_data(cfg, synthetic=True)
    batch = runner.prepare_batch(x_np, None, dev)
    spec = autoencoder.AESpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
    state = train.init_state(autoencoder.init_params(spec, seed=cfg.seed, device=dev), cfg)
    out["ae_epoch"] = 1e3 * time_ms(lambda: ae_chunk.fused_ae_chunk(state, batch, steps, spec, cfg), 1) / steps
    split = ae_chunk.phase_split(state, batch, steps, spec, cfg)
    out["ae_split"] = {k: v * 1e6 / steps for k, v in split.items()}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("other", help="version A: a directory holding another checkout")
    parser.add_argument("--steps", type=int, default=2000, help="epochs of each AE launch")
    parser.add_argument("--as", dest="name", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.name is not None:  # one turn, in a process of its own
        print(json.dumps(turn(os.path.abspath(args.other), args.steps)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    trees = {"A": os.path.abspath(args.other), "B": str(ROOT)}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    turns = []
    for name in ("A", "B", "B", "A"):
        proc = subprocess.run([sys.executable, __file__, trees[name], "--as", name, "--steps", str(args.steps)],
                              capture_output=True, text=True, env=env)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr)
            return proc.returncode
        turns.append((name, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(f"{name}: {turns[-1][1]}", flush=True)
    by = {v: [t for n, t in turns if n == v] for v in ("A", "B")}
    for shape in map(str, SHAPES):
        print(f"dual {shape}: A " + "/".join(f"{t['dual'][shape]:.1f}" for t in by["A"])
              + ", B " + "/".join(f"{t['dual'][shape]:.1f}" for t in by["B"])
              + " us; the cuBLAS pair " + "/".join(f"{t['cublas'][shape]:.1f}" for _, t in turns)
              + " us (in the turns' order)")
    print("AE epoch: A " + "/".join(f"{t['ae_epoch']:.1f}" for t in by["A"])
          + ", B " + "/".join(f"{t['ae_epoch']:.1f}" for t in by["B"]) + " us")
    for v in ("A", "B"):
        for t in by[v]:
            print(f"AE split {v}: " + ", ".join(f"{k} {x:.1f}" for k, x in t["ae_split"].items())
                  + f" us/epoch (sum {sum(t['ae_split'].values()):.1f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
