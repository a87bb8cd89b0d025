#!/usr/bin/env python3
"""How far float32 training traces lie from each other and from the exact
(float64) one, for the mega-kernel and for float32 versions of its step that
differ from the plain chunk only in how the partials are summed.

    python3 scripts/torch_trace_f64.py [--device cpu] [--preset cylinder,fourier_cylinder]
    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 scripts/torch_trace_f64.py --tree build/parent

At each preset as configured but omega_init=1 and lr_omega=1 (the setting
of ``chip_smoke.py`` phases 5 and 5f; synthetic data, the reference init),
runs 200 epochs of:

- ``kernel``: the mega-kernel (``train_chunk.fused_train_chunk``), on the
  card only; with ``--tree DIR`` also ``kernel DIR``, the mega-kernel of the
  checkout at DIR (run in a child process that imports that checkout's
  package, which builds its own kernel);
- ``plain``: the plain chunk in float32 (``train_chunk.train_chunk_plain``);
- ``sums exact``: the step in float32 (``shard_step.plain_trace``) with every
  partial summed over the rows in float64 and rounded once to float32;
- ``gcoef, gomega exact``: the same with only gcoef and gomega so summed;
- ``float64``: the step in float64 (``shard_step.plain_trace``);

and prints, for rec and l1, each trace's largest distance over the epochs
from ``float64`` and from ``plain``, as a share of the one it is held to. The
two float32 versions with exactly rounded sums are correct implementations
that differ from the plain chunk in rounding only, so their distances show
what a limit on the distance from the plain chunk has to admit. On the card
it prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EPOCHS = 200


def problem(name: str, dev):
    """The preset at omega_init=1, lr_omega=1: (config, spec, batch, state),
    through the package on ``sys.path``."""
    from desmo_tpu_torch import configs, pod, runner, train
    from desmo_tpu_torch.models import desmo, fourier

    preset = dataclasses.replace(configs.get(name), omega_init=1.0, lr_omega=1.0)
    x, _ = runner.load_data(preset, synthetic=True)
    batch = runner.prepare_batch(x, pod.pod_host(x, preset.r, dev).modes, dev)
    if preset.variant == "fourier":
        spec = fourier.FourierSpec(preset.n, preset.m, preset.r, preset.poly_order, 1.0, preset.n_fourier,
                                   preset.period_init)
        params = fourier.Fourier(spec, device=dev).params()
    else:
        spec = desmo.DesmoSpec(preset.n, preset.m, preset.r, preset.poly_order, 1.0)
        params = desmo.Desmo(spec, device=dev).params()
    return preset, spec, batch, train.init_state(params, preset)


def kernel_traces(presets: list[str], out: str) -> None:
    """The mega-kernel's rec and l1 traces at each preset, into ``out``."""
    import numpy as np
    import torch

    from desmo_tpu_torch.kernels import train_chunk

    got = {}
    for name in presets:
        cfg, spec, batch, state = problem(name, torch.device("cuda"))
        metrics = train_chunk.fused_train_chunk(state, batch, EPOCHS, spec, cfg)[1]
        got.update({f"{name}/{key}": metrics[key].cpu().numpy() for key in ("rec", "l1")})
    np.savez(out, **got)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="cylinder,fourier_cylinder")
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--root", default=str(ROOT), help=argparse.SUPPRESS)
    ap.add_argument("--kernel-only", help=argparse.SUPPRESS)  # the child: write kernel_traces here
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    presets = args.preset.split(",")
    if args.kernel_only:
        kernel_traces(presets, args.kernel_only)
        return 0
    import numpy as np
    import torch

    from desmo_tpu_torch.kernels import shard_step, train_chunk

    others = {}
    for tree in args.tree:
        out = Path(args.root) / "build" / f"trace_{Path(tree).name}.npz"
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([sys.executable, __file__, "--root", tree, "--preset", args.preset, "--kernel-only", str(out)],
                       check=True)
        others[f"kernel {tree}"] = dict(np.load(out))
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    else:
        torch.set_num_threads(4)
    partials = shard_step.step_partials_plain

    def exact_sums(first: int):
        """step_partials_plain with the flat sums from entry ``first`` on
        (counted from the end when negative) summed in float64."""

        def fn(*inputs):
            dl, flat, max_arg = partials(*inputs)
            if flat.dtype == torch.float64:
                return dl, flat, max_arg
            exact = partials(*(t.double() for t in inputs[:7]), *inputs[7:])[1].float()
            flat = flat.clone()
            flat[first:] = exact[first:]
            return dl, flat, max_arg

        return fn

    for name in presets:
        preset, spec, batch, state = problem(name, dev)
        tail = spec.num_poly_terms + 6 * spec.r  # gcoef (K) and gomega (3 r) end the flat sums
        traces = {}
        if dev.type == "cuda":
            traces["kernel"] = train_chunk.fused_train_chunk(state, batch, EPOCHS, spec, preset)[1]
            for label, got in others.items():
                traces[label] = {key: torch.as_tensor(got[f"{name}/{key}"]) for key in ("rec", "l1")}
        traces["plain"] = train_chunk.train_chunk_plain(state, batch, EPOCHS, spec, preset)[1]
        for label, first in (("sums exact", 0), ("gcoef, gomega exact", -tail)):
            shard_step.step_partials_plain = exact_sums(first)
            try:
                traces[label] = shard_step.plain_trace(state, batch, EPOCHS, spec, preset, torch.float32)
            finally:
                shard_step.step_partials_plain = partials
        traces["float64"] = shard_step.plain_trace(state, batch, EPOCHS, spec, preset)

        def dist(a, b, key):
            got, want = traces[a][key][:EPOCHS].double().cpu(), traces[b][key][:EPOCHS].double().cpu()
            return float(((got - want).abs() / want.abs()).max())

        print(f"{name} (n, m, K)=({preset.n}, {preset.m}, {spec.num_poly_terms + 3 * spec.r}), omega_init=1, "
              f"lr_omega=1, {EPOCHS} epochs on {dev.type}: largest distance from float64 | from plain")
        for label in traces:
            if label != "float64":
                print(f"  {label:24s}" + "; ".join(f"{key} {dist(label, 'float64', key):.3e} | "
                                                   f"{dist(label, 'plain', key):.3e}" for key in ("rec", "l1")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
