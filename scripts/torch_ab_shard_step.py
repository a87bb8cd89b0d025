#!/usr/bin/env python3
"""Time two checkouts' sharded step on one GPU, in turns.

    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 scripts/torch_ab_shard_step.py build/parent [--steps 500]

Version A is the checkout in the directory given, version B this one. Each
turn runs in a process of its own that imports its checkout's package (which
builds its own kernels), in the order A, B, B, A. A turn makes a one-rank
NCCL mesh (``parallel.make_mesh(1)``) and, at cylinder and fourier_cylinder
as configured (full width, synthetic data, the preset's init), prints:

- the sharded step (``kernels.shard_step.make_sharded_fused_chunk``): µs
  per step over a ``--steps``-step chunk by CUDA events, the chunk as a
  caller of ``train.fit`` runs it (allocations and set-up included);
- in one ``torch.profiler`` window of a ``--steps``-step chunk, the device
  time a step (the kernels, copies and all-reduces) and the window's wall
  time a step; the busy share is their ratio;
- the step kernel's launches in one ``--steps``-step chunk;
- the mega-kernel's epoch (``kernels.train_chunk.fused_train_chunk``) over a
  ``--steps``-epoch launch in the same turn, for scale;
- a SHA-256 digest of the metrics and the state after one ``--steps``-step
  chunk, so that the table says whether the two versions give the same bits;
- the step kernel's own clock by part (``shard_step.phase_split``), µs per
  launch over a ``--steps``-step chunk.

Prints the card's name and power limit first, and last a table of each
version's two turns.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PRESETS = ("cylinder", "fourier_cylinder")


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
    import torch

    from desmo_tpu_torch import configs, device as device_mod, parallel, pod, runner, train
    from desmo_tpu_torch.kernels import shard_step, train_chunk
    from desmo_tpu_torch.models import desmo, fourier

    if not shard_step.__file__.startswith(tree):
        raise RuntimeError(f"imported {shard_step.__file__}, not the package under {tree}")
    dev = device_mod.resolve("cuda")
    device_mod.fp32_matmul()
    mesh = parallel.make_mesh(1, device=dev)
    # the step kernel's counted wrapper: ``step`` since the update moved into it, ``step_partials`` before
    wrapper = getattr(shard_step, "step", None) or shard_step.step_partials
    out = {}
    for name in PRESETS:
        cfg = configs.get(name)
        x_np, _ = runner.load_data(cfg, synthetic=True)
        batch = runner.prepare_batch(x_np, pod.pod_host(x_np, cfg.r, dev).modes, dev)
        if cfg.variant == "fourier":
            spec = fourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier,
                                       cfg.period_init)
            params = fourier.Fourier(spec, device=dev).params()
        else:
            spec = desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
            params = desmo.Desmo(spec, device=dev).params()
        state = train.init_state(params, cfg)
        chunk = shard_step.make_sharded_fused_chunk(spec, cfg, mesh)
        local = parallel.shard_batch(batch, mesh)
        step_us = 1e3 * time_ms(lambda: chunk(state, local, steps), 1) / steps
        before = wrapper.launches
        end, mets = chunk(state, local, steps)
        launches = wrapper.launches - before
        digest = hashlib.sha256()
        for t in [mets[k] for k in sorted(mets)] + [end.params[k] for k in sorted(end.params)]:
            digest.update(t.detach().cpu().numpy().tobytes())
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chunk(state, local, steps)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6 / steps
        device_us = sum(e.self_device_time_total for e in prof.key_averages()
                        if str(e.device_type).endswith("CUDA")) / steps
        mega_us = 1e3 * time_ms(lambda: train_chunk.fused_train_chunk(state, batch, steps, spec, cfg), 1) / steps
        split = {k: v * 1e6 / (steps + 1) for k, v in shard_step.phase_split(spec, cfg, mesh, state, local, steps).items()}
        out[name] = dict(step_us=step_us, device_us=device_us, window_us=window_us, launches=launches,
                         mega_us=mega_us, digest=digest.hexdigest(), split=split)
    torch.distributed.destroy_process_group()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("other", help="version A: a directory holding another checkout")
    parser.add_argument("--steps", type=int, default=500, help="steps of each timed chunk")
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
    for preset in PRESETS:
        for key, what in (("step_us", "sharded step, us"), ("device_us", "device time a step, us"),
                          ("window_us", "wall time a step in the profiled window, us"),
                          ("launches", f"step kernel launches in a {args.steps}-step chunk"),
                          ("mega_us", "the mega-kernel's epoch, us")):
            print(f"{preset} {what}: A " + "/".join(f"{t[preset][key]:.1f}" for t in by["A"])
                  + ", B " + "/".join(f"{t[preset][key]:.1f}" for t in by["B"]))
        for v in ("A", "B"):
            print(f"{preset} busy share {v}: " + "/".join(f"{t[preset]['device_us'] / t[preset]['window_us']:.1%}"
                                                          for t in by[v]))
        print(f"{preset} kernel clock, us per launch: " + ", ".join(
            f"{k} A " + "/".join(f"{t[preset]['split'][k]:.1f}" for t in by["A"]) + " B "
            + "/".join(f"{t[preset]['split'][k]:.1f}" for t in by["B"]) for k in by["B"][0][preset]["split"]))
        digests = {t[preset]["digest"] for _, t in turns}
        print(f"{preset} metrics and state after a {args.steps}-step chunk: "
              + ("the same bits in every turn" if len(digests) == 1 else f"{len(digests)} different digests"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
