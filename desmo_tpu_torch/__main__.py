"""Command-line interface: ``python -m desmo_tpu_torch <command>``.

    python -m desmo_tpu_torch presets
    python -m desmo_tpu_torch run --preset cylinder --synthetic --epochs 2000
    python -m desmo_tpu_torch run --preset cylinder --npz snapshots.npz --device cpu
    python -m desmo_tpu_torch run --preset cylinder --synthetic --chunk-method scan
    python -m desmo_tpu_torch run --preset fourier_cylinder --synthetic --epochs 2000
    python -m desmo_tpu_torch run --preset aneurysm --synthetic --seeds 4
    python -m desmo_tpu_torch run --preset cylinder --synthetic --sweep-beta 1e-3,1e-2
    python -m desmo_tpu_torch run --preset ae_cylinder --synthetic --chunk-method megakernel
    python -m desmo_tpu_torch run --preset ae_cylinder --synthetic --ae-recipe
    python -m desmo_tpu_torch run --preset cylinder --synthetic --mesh space=1
    python -m desmo_tpu_torch run --preset channel --synthetic --epochs 2000
    python -m desmo_tpu_torch run --preset cylinder --synthetic --resume runs/cylinder/state_epoch2000.npz
    python -m desmo_tpu_torch run --preset fourier_cylinder --synthetic --period-multistart 4 --holdout 0.2
    python -m desmo_tpu_torch run --preset cylinder --synthetic --pod-method snapshots
    python -m desmo_tpu_torch evaluate --preset fourier_cylinder --synthetic \
        --checkpoint runs/fourier_cylinder/fourier_cylinder_r2_final.pt --forecast-after 801
    python -m desmo_tpu_torch inspect-pt runs/cylinder/cylinder_r4_final.pt
    python -m desmo_tpu_torch pod --preset aneurysm --synthetic --method randomized --save pod.npz
    torchrun --nproc-per-node 2 -m desmo_tpu_torch run --preset cylinder --synthetic --device cpu --mesh space=2

``run`` trains on the GPU by default and raises when there is none; the plain
PyTorch path runs only with ``--device cpu``. ``--chunk-method`` sets the
preset's ``chunk_method``: ``auto`` runs the mega-kernel on a GPU and the
eager loop on the CPU. ``--seeds S`` trains S seed-packed models at once
and keeps the best (the packed mega-kernel on a GPU); ``--sweep-beta``,
``--sweep-lam`` and ``--sweep-lr-scale`` give the seeds a grid of
(beta, lambda, LR scale), whose size is the default ``--seeds``. The AE
variant keeps the JAX package's policy: ``auto`` is the eager loop, and
``--chunk-method megakernel`` takes its kernel; ``--ae-recipe`` and
``--ae-data-omega`` turn on its convergence recipe. ``--mesh space=d`` shards
the rows over d processes, one per device (``torchrun --nproc-per-node d``;
one process alone for d = 1), through the sharded step kernel, one launch
and one all-reduce per step; only rank 0 prints and writes. ``--resume``
continues from a ``state_*.npz`` of either package for ``--epochs`` more
epochs. SIGTERM stops ``run`` at the next chunk boundary with
``state_final.npz`` written and ``"preempted": true`` in the summary.
``--period-multistart N`` probes up to N candidate periods of a Fourier
preset before the fit and keeps the best; ``--holdout F`` trains a Fourier
preset on the first 1 - F of the snapshots and scores its series on the
rest (``forecast.json``, and ``forecast`` in the summary);
``--pod-method`` takes the POD on the host (``host``, the reference's
signs) or on the device (``snapshots``, ``svd``, ``randomized``, under a
canonical sign convention): evaluate a checkpoint with the method it was
trained under.

``evaluate`` runs inference from a ``.pt`` checkpoint (the errors, the POD
baselines and the threshold sweep; ``--forecast-after M`` scores a Fourier
checkpoint trained on the first M snapshots at the rest), ``inspect-pt``
lists a checkpoint's arrays and ``pod`` runs the POD alone. Every command
that computes takes ``--device`` (``cuda`` by default).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys


def cmd_presets(_args) -> int:
    from desmo_tpu_torch import configs

    for name in configs.names():
        cfg = configs.get(name)
        print(
            f"{name:18s} variant={cfg.variant:8s} n={cfg.n:6d} m={cfg.m:5d} "
            f"r={cfg.r} P={cfg.poly_order} epochs={cfg.num_epochs}"
        )
    return 0


def _forecast_summary(record: dict) -> dict:
    """A forecast record's scalars for the one-line summary: the per-snapshot
    vectors stay in ``forecast.json``; non-finite errors become null."""
    from desmo_tpu_torch import runner

    return runner.json_finite({k: v for k, v in record.items() if not k.startswith("per_snapshot")})


def _parse_mesh(spec_str, device):
    """'space=4[,time=1]' -> a ``parallel.SpaceMesh`` on ``device`` (or None)."""
    if not spec_str:
        return None
    from desmo_tpu_torch.parallel import make_mesh

    axes = {"space": None, "time": 1}
    for part in spec_str.split(","):
        name, _, val = part.partition("=")
        if name not in axes or not val.isdigit():
            raise SystemExit(
                f"--mesh expects 'space=<d>[,time=<d>]', got {spec_str!r}"
            )
        axes[name] = int(val)
    return make_mesh(n_space=axes["space"], n_time=axes["time"], device=device)


def cmd_run(args) -> int:
    from desmo_tpu_torch import configs, runner, train

    # SIGTERM (SLURM preemption, spot-VM reclaim): a final checkpoint at the
    # next chunk boundary and a clean exit, not death mid-chunk
    train.install_preemption_handler()
    cfg = configs.get(args.preset)
    overrides = {}
    if args.epochs is not None:
        overrides["num_epochs"] = args.epochs
    if args.chunk_method is not None:
        overrides["chunk_method"] = args.chunk_method
    if args.ae_data_omega:
        overrides["ae_omega_data_scaled"] = True
    if args.ae_recipe:
        overrides["ae_recipe"] = True
    if args.period_multistart:
        overrides["period_multistart"] = args.period_multistart
    if args.pod_method:
        overrides["pod_method"] = args.pod_method
    if args.seeds:
        overrides["n_seeds"] = args.seeds
    if args.seed_phi_sigma is not None:
        overrides["seed_phi_sigma"] = args.seed_phi_sigma
    if args.seed_omega_spread is not None:
        overrides["seed_omega_spread"] = args.seed_omega_spread
    for flag in ("sweep_beta", "sweep_lam", "sweep_lr_scale"):
        vals = getattr(args, flag)
        if vals:
            try:
                overrides[flag] = tuple(float(v) for v in vals.split(",") if v.strip())
            except ValueError:
                print(f"error: --{flag.replace('_', '-')} expects a comma-separated list of numbers, got {vals!r}",
                      file=sys.stderr)
                return 2
    if any(k.startswith("sweep_") for k in overrides):
        # one packed seed per combo unless --seeds was given (an explicit
        # --seeds, even 1, is kept; runner.run refuses what cannot run)
        n_combo = math.prod(len(overrides.get(k) or (0,)) for k in ("sweep_beta", "sweep_lam", "sweep_lr_scale"))
        if args.seeds is None and cfg.n_seeds <= 1 and n_combo > 1:
            overrides["n_seeds"] = n_combo
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    device_mesh = _parse_mesh(args.mesh, args.device)
    x, _mesh = runner.load_data(
        cfg,
        data_dir=args.data_dir,
        filename=args.filename,
        extension=args.extension,
        array=args.array,
        location=args.location,
        t_start=args.t_start,
        t_end=args.t_end,
        npz_path=args.npz,
        synthetic=args.synthetic,
        dim=args.dim,
    )
    artifacts = runner.run(cfg, x, out_dir=args.out_dir, device=args.device, device_mesh=device_mesh,
                           resume_from=args.resume, holdout=args.holdout or 0.0)
    if device_mesh is not None and device_mesh.rank != 0:
        return 0
    summary = {
        "preset": cfg.name,
        "device": args.device,
        "chunk_method": cfg.chunk_method,
        "n_seeds": cfg.n_seeds,
        "mesh": args.mesh,
        "relative_error": artifacts.relative_error,
        "pod_error_r": artifacts.pod_error_r,
        "pod_error_2r": artifacts.pod_error_2r,
        # null when the run fits in its first (untimed) chunk
        "steps_per_sec": None if math.isnan(artifacts.steps_per_sec) else artifacts.steps_per_sec,
        "out_dir": artifacts.out_dir,
        "preempted": artifacts.preempted,
    }
    if artifacts.forecast is not None:
        summary["forecast"] = _forecast_summary(artifacts.forecast)
    print(json.dumps(summary))
    return 0


def cmd_evaluate(args) -> int:
    """Inference from a ``.pt`` checkpoint: errors, POD baselines, the sweep."""
    from desmo_tpu_torch import configs, runner

    cfg = configs.get(args.preset)
    if args.pod_method:
        cfg = dataclasses.replace(cfg, pod_method=args.pod_method)
    if args.mesh:
        # refused before a process group is made for it
        raise NotImplementedError(
            "desmo_tpu_torch does not run evaluate over a device mesh (ROADMAP queue 1, item 5) yet")
    x, _mesh = runner.load_data(cfg, data_dir=args.data_dir, npz_path=args.npz, synthetic=args.synthetic)
    out = runner.evaluate(cfg, x, args.checkpoint, device=args.device, figures_dir=args.figures,
                          forecast_after=args.forecast_after)
    summary = {k: v for k, v in out.items() if k != "sweep"}
    if "forecast" in summary:
        summary["forecast"] = _forecast_summary(summary["forecast"])
    print(json.dumps(summary))
    return 0


def cmd_inspect_pt(args) -> int:
    """The arrays of a ``.pt`` checkpoint (the port's, the JAX package's or
    the reference's), one ``name shape`` line each, read onto ``--device``."""
    from desmo_tpu_torch import checkpoint
    from desmo_tpu_torch import device as device_mod

    dev = device_mod.resolve(args.device)
    sd = {k: v.to(dev) for k, v in checkpoint.load_pt(args.path).items()}
    for k in sorted(sd):
        print(f"{k:32s} {tuple(sd[k].shape)}")
    return 0


def cmd_pod(args) -> int:
    """The POD alone, the reference's ``POD_analysis`` stage: the rank-r
    error, singular values and captured energy as one JSON line; ``--save``
    writes the modes, temporal rows and spectrum to an npz."""
    import numpy as np

    from desmo_tpu_torch import configs, pod, runner
    from desmo_tpu_torch import device as device_mod

    if args.method == "streaming":
        raise NotImplementedError(
            "desmo_tpu_torch does not run the streaming POD (ROADMAP queue 1, item 6) yet")
    if args.figures:
        raise NotImplementedError("desmo_tpu_torch does not draw figures (ROADMAP queue 1, item 6) yet")
    cfg = configs.get(args.preset)
    r = args.rank if args.rank is not None else cfg.r
    dev = device_mod.resolve(args.device)
    x, _mesh = runner.load_data(
        cfg, data_dir=args.data_dir, filename=args.filename, extension=args.extension, array=args.array,
        location=args.location, t_start=args.t_start, t_end=args.t_end, npz_path=args.npz,
        synthetic=args.synthetic, dim=args.dim,
    )
    if args.method == "host":
        res = pod.pod_host(x, r, dev)
    else:
        res = pod.canonical_signs(pod.pod(x, r, method=args.method, oversample=args.oversample,
                                          n_iter=args.iters, device=dev))
    err = pod.pod_relative_error(x, res)

    def host(t):
        return t.cpu().numpy()

    if args.save:
        np.savez(args.save, modes=host(res.modes), temporal=host(res.temporal),
                 singular_values=host(res.singular_values), energy=host(res.energy))
    print(json.dumps({
        "preset": cfg.name,
        "method": args.method,
        "rank": r,
        "relative_error": err,
        "singular_values": host(res.singular_values).tolist(),
        "energy_captured": float(np.sum(host(res.energy)[:r])),
        "saved": args.save,
    }))
    return 0


POD_METHODS = ["host", "snapshots", "svd", "randomized"]


def _device_flag(parser) -> None:
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="cuda (default; raises without a GPU) or cpu (plain PyTorch versions of the kernels)",
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="desmo_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("presets", help="list named experiment presets")

    p_run = sub.add_parser("run", help="train a preset end to end")
    p_run.add_argument("--preset", required=True)
    p_run.add_argument("--data-dir", default=None, help="directory of VTK snapshots")
    p_run.add_argument("--filename", default="velocity_", help="snapshot basename")
    p_run.add_argument("--extension", default=".vtu")
    p_run.add_argument("--array", default="velocity", help="VTK array name")
    p_run.add_argument("--location", default="point", choices=["point", "cell"])
    p_run.add_argument("--t-start", type=int, default=0)
    p_run.add_argument("--t-end", type=int, default=None)
    p_run.add_argument("--npz", default=None, help="npz file with key 'X' instead of VTK")
    p_run.add_argument("--synthetic", action="store_true", help="generate synthetic data")
    p_run.add_argument("--dim", type=int, default=None, choices=[2, 3])
    p_run.add_argument("--epochs", type=int, default=None, help="override preset epochs")
    p_run.add_argument("--out-dir", default="./runs")
    p_run.add_argument("--resume", default=None, help="state_*.npz checkpoint to resume")
    p_run.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help="space=d: shard the rows over d processes, one per device (torchrun --nproc-per-node d; "
        "one process for d=1); time=1 only",
    )
    _device_flag(p_run)
    p_run.add_argument(
        "--chunk-method", default=None, choices=["auto", "scan", "megakernel"],
        help="override the preset's RunConfig.chunk_method: auto (the mega-kernel on a GPU), "
        "scan (the eager loop) or megakernel",
    )

    p_run.add_argument(
        "--ae-recipe", action="store_true",
        help="AE variant: the convergence recipe (live MLP init, AE-only warmup, data-scaled omega)",
    )
    p_run.add_argument(
        "--ae-data-omega", action="store_true",
        help="AE variant: rescale the omega init from the initial latent RMS",
    )
    p_run.add_argument(
        "--seeds", type=int, default=None, metavar="S",
        help="desmo/fourier: train S independently initialized models at once, packed (one read of X serves "
        "them all; the packed mega-kernel on a GPU), and keep the best; with a preset's period_multistart the "
        "Fourier seeds train the FFT period candidates",
    )
    p_run.add_argument("--seed-phi-sigma", type=float, default=None, metavar="SIGMA",
                       help="multi-seed: relative phi init jitter for seeds > 0 (default 0.02)")
    p_run.add_argument("--seed-omega-spread", type=float, default=None, metavar="DECADES",
                       help="multi-seed: omega init log-spread in decades for seeds > 0 (default 0)")
    p_run.add_argument(
        "--sweep-beta", default=None, metavar="B1,B2,...",
        help="hyperparameter multi-start: per-seed ortho weights; the cartesian product with --sweep-lam and "
        "--sweep-lr-scale is the combo grid, seed s trains combo s mod #combos (--seeds defaults to the grid "
        "size) and the winner is picked by rec",
    )
    p_run.add_argument("--sweep-lam", default=None, metavar="L1,L2,...",
                       help="hyperparameter multi-start: per-seed L1 sparsity weights")
    p_run.add_argument("--sweep-lr-scale", default=None, metavar="S1,S2,...",
                       help="hyperparameter multi-start: per-seed factors on the whole group-LR row")

    p_run.add_argument(
        "--period-multistart", type=int, default=None, metavar="N",
        help="Fourier variants: probe up to N FFT-informed candidate periods before training and keep the best "
        "(rescues a mismatched period_init)",
    )
    p_run.add_argument(
        "--holdout", type=float, default=0.0, metavar="F",
        help="Fourier variants: hold out the last F of the snapshots, train on the rest and score the trained "
        "series at the held-out times (both recentred on the training mean; forecast.json and a 'forecast' "
        "summary field)",
    )
    p_run.add_argument(
        "--pod-method", default=None, choices=POD_METHODS,
        help="POD initialization: host (default; np.linalg.svd, the reference's signs) or on the device under a "
        "canonical sign convention; evaluate a checkpoint with the same method",
    )

    p_pt = sub.add_parser("inspect-pt", help="list arrays in a .pt checkpoint")
    p_pt.add_argument("path")
    _device_flag(p_pt)

    p_pod = sub.add_parser("pod", help="standalone POD analysis")
    p_pod.add_argument("--preset", required=True, help="preset supplying the preprocessing flags")
    p_pod.add_argument("--rank", "-r", type=int, default=None, help="POD rank (default: preset r)")
    p_pod.add_argument(
        "--method", default="auto", choices=["auto", *POD_METHODS, "streaming"],
        help="auto (the method of snapshots when n > m), host (np.linalg.svd), snapshots, svd or randomized on "
        "the device; streaming is not ported yet",
    )
    p_pod.add_argument("--data-dir", default=None, help="directory of VTK snapshots")
    p_pod.add_argument("--filename", default="velocity_")
    p_pod.add_argument("--extension", default=".vtu")
    p_pod.add_argument("--array", default="velocity")
    p_pod.add_argument("--location", default="point", choices=["point", "cell"])
    p_pod.add_argument("--t-start", type=int, default=0)
    p_pod.add_argument("--t-end", type=int, default=None)
    p_pod.add_argument("--npz", default=None)
    p_pod.add_argument("--synthetic", action="store_true")
    p_pod.add_argument("--dim", type=int, default=None, choices=[2, 3])
    p_pod.add_argument("--oversample", type=int, default=8, help="randomized: sketch oversampling")
    p_pod.add_argument("--iters", type=int, default=2, help="randomized: power iterations")
    p_pod.add_argument("--save", default=None, metavar="NPZ", help="write modes/temporal/spectrum to an npz")
    p_pod.add_argument("--figures", default=None, metavar="DIR", help="not ported yet")
    _device_flag(p_pod)

    p_ev = sub.add_parser("evaluate", help="inference + error report from a .pt checkpoint")
    p_ev.add_argument("--preset", required=True)
    p_ev.add_argument("--checkpoint", required=True)
    p_ev.add_argument("--data-dir", default=None)
    p_ev.add_argument("--npz", default=None)
    p_ev.add_argument("--synthetic", action="store_true")
    p_ev.add_argument(
        "--pod-method", default=None, choices=POD_METHODS,
        help="rebuild the POD with this method: the one the checkpoint was trained under (default host)",
    )
    p_ev.add_argument(
        "--forecast-after", type=int, default=None, metavar="M",
        help="Fourier checkpoints trained on the data's first M snapshots: score the series at the held-out "
        "times beyond M (recentred on the training mean) and add a 'forecast' record",
    )
    p_ev.add_argument("--mesh", default=None, metavar="SPEC", help="not ported yet")
    p_ev.add_argument("--figures", default=None, metavar="DIR", help="not ported yet")
    _device_flag(p_ev)

    args = parser.parse_args(argv)
    return {
        "presets": cmd_presets,
        "run": cmd_run,
        "evaluate": cmd_evaluate,
        "inspect-pt": cmd_inspect_pt,
        "pod": cmd_pod,
    }[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
