#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``desmo_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch twin at the main path's shapes, trains the cylinder
preset at full width (n=3961, m=1001, r=4, P=3) on synthetic data through
``runner.run``, checks the run and that it went through the kernel, and times
the kernel against its twin. Each phase prints one line; any failure exits
non-zero. The second-to-last line is a JSON record of the kernels; the last
line is ``{"ok": true, "device": {...}}``. Exits non-zero without printing a
result when no CUDA device is available.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

SLICE_EPOCHS = 300
CPU_EPOCHS = 10
# kernel vs twin: fp32 FMA against cuBLAS fp32, both accumulating in fp32
CONTRACTION_RTOL = 5e-5
GRAD_RTOL = 2e-4


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {what}")


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA device", file=sys.stderr)
        return 1
    from desmo_tpu_torch import configs, device as device_mod, losses, runner
    from desmo_tpu_torch.kernels import _build, dual_gemm

    # 1. the card
    dev = device_mod.resolve("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    card = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(dev)
    print(f"[1 card] {kind} | nvidia-smi: {card} | torch {torch.__version__} CUDA {torch.version.cuda}")

    # 2. build from this checkout's sources
    t0 = time.perf_counter()
    lib_path = _build.build("dual_gemm")
    _build.load("dual_gemm")
    ptxas = [ln.strip() for ln in _build.build_log("dual_gemm").splitlines() if "Used" in ln]
    print(f"[2 build] {os.path.relpath(lib_path)} in {time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(ptxas)}")

    # 3. kernel vs its plain twin at the main path's shapes
    gen = torch.Generator().manual_seed(0)
    errs = {}
    for n, m, k in ((3961, 1001, 47), (700, 333, 50)):
        a, b, x = (torch.randn(shape, generator=gen).to(dev) for shape in ((n, k), (k, m), (n, m)))
        ax, xb = dual_gemm.dual_contractions(a, b, x)
        torch.cuda.synchronize()
        pax, pxb = dual_gemm.dual_contractions_plain(a, b, x)
        torch.cuda.synchronize()
        e_ax, e_xb = rel_err(ax, pax), rel_err(xb, pxb)
        ax2, xb2 = dual_gemm.dual_contractions(a, b, x)
        torch.cuda.synchronize()
        check(e_ax <= CONTRACTION_RTOL and e_xb <= CONTRACTION_RTOL,
              f"kernel vs twin at {(n, m, k)}: ax {e_ax:.2e}, xb {e_xb:.2e} > {CONTRACTION_RTOL}")
        check(torch.equal(ax, ax2) and torch.equal(xb, xb2), f"two launches differ at {(n, m, k)}")
        errs[(n, m, k)] = (e_ax, e_xb, max(float((ax - pax).abs().max()), float((xb - pxb).abs().max())))
        print(f"[3 kernel] (n, m, K)={(n, m, k)}: max|err|/max|ref| ax {e_ax:.2e}, xb {e_xb:.2e} "
              f"(limit {CONTRACTION_RTOL:.0e}); repeat launch bit-identical")
    cyl = (3961, 1001, 47)
    a, b, x = (torch.randn(shape, generator=gen).to(dev) * s
               for shape, s in (((cyl[0], cyl[2]), 0.3), ((cyl[2], cyl[1]), 0.3), ((cyl[0], cyl[1]), 1.0)))
    grads = []
    for fn in (lambda a_, b_: dual_gemm.factored_mse_fused(a_, b_, x, torch.sum(x * x)),
               lambda a_, b_: losses.factored_mse(a_, b_, x)):
        a_, b_ = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        val = fn(a_, b_)
        grads.append((val.detach(),) + torch.autograd.grad(val, (a_, b_)))
        torch.cuda.synchronize()
    e_val = abs(float(grads[0][0] - grads[1][0])) / abs(float(grads[1][0]))
    e_da, e_db = rel_err(grads[0][1], grads[1][1]), rel_err(grads[0][2], grads[1][2])
    check(e_val <= 1e-4 and e_da <= GRAD_RTOL and e_db <= GRAD_RTOL,
          f"FactoredMSEFused vs autograd of factored_mse: value {e_val:.2e}, dA {e_da:.2e}, dB {e_db:.2e}")
    print(f"[3 grad] FactoredMSEFused vs autograd(factored_mse) at {cyl}: value {e_val:.2e}, "
          f"dA {e_da:.2e}, dB {e_db:.2e} (limit {GRAD_RTOL:.0e} of max|g|)")

    # 4. the slice: cylinder at full width through runner.run
    cfg = dataclasses.replace(
        configs.get("cylinder"), chunk_method="scan", loss_method="fused",
        checkpoint_every=100, log_every=100,
    )
    x_np, _ = runner.load_data(cfg, synthetic=True)
    with tempfile.TemporaryDirectory() as tmp:
        dual_gemm.dual_contractions.launches = 0
        t0 = time.perf_counter()
        art = runner.run(cfg, x_np, out_dir=os.path.join(tmp, "gpu"), num_epochs=SLICE_EPOCHS, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dual_gemm.dual_contractions.launches
        hist = art.history
        check(all(hist[k].shape == (SLICE_EPOCHS,) for k in hist), "history length")
        check(all(bool(np.isfinite(hist[k]).all()) for k in hist), "non-finite loss in the history")
        check(hist["rec"][-1] < hist["rec"][0], f"rec did not fall: {hist['rec'][0]} -> {hist['rec'][-1]}")
        check(launches == SLICE_EPOCHS, f"dual kernel launched {launches} times in {SLICE_EPOCHS} loss evaluations")
        files = set(os.listdir(art.out_dir))
        check({"cylinder_r4_final.pt", "state_final.npz"} <= files, f"missing exports in {sorted(files)}")
        check(art.relative_error == art.relative_error and len(art.sweep) == 14, "error/sweep")
        print(f"[4 slice] cylinder n={art.config.n} m={art.config.m} r={cfg.r} P={cfg.poly_order} on {kind}: "
              f"{SLICE_EPOCHS} epochs in {wall:.1f} s (POD, sweep and exports included); rec "
              f"{hist['rec'][0]:.6e} -> {hist['rec'][-1]:.6e}; relative error {art.relative_error:.6f}; "
              f"dual kernel launches {launches} = loss evaluations {SLICE_EPOCHS}")

        cpu = runner.run(cfg, x_np, out_dir=os.path.join(tmp, "cpu"), num_epochs=CPU_EPOCHS,
                         echo=False, device="cpu")
    rel = abs(hist["total"][:CPU_EPOCHS] - cpu.history["total"]) / abs(cpu.history["total"])
    print(f"[4 cpu] |total_gpu - total_cpu|/|total_cpu| per epoch 0..{CPU_EPOCHS - 1}: "
          + " ".join(f"{v:.1e}" for v in rel))
    # omega starts at 1e4 and moves by lr_omega=1e3 a step, so the trig
    # arguments reach ~1e2-1e3 rad and fp32 rounding differences of sin/cos
    # grow about tenfold every one or two epochs; where the path lands after
    # epoch 3 hangs on the order of every sum. The JAX package against
    # itself, with X scaled by 1 + 2^-22, separates by 5e-2 by epoch 6
    # (tests/test_torch_runner.py). So the first 3 epochs are held to 1e-4
    # (H100 runs: at most 3.5e-6) and the first 10 to that reference
    # spread, 0.2 (H100 runs: at most 1.8e-2).
    check(bool((rel[:3] <= 1e-4).all() and (rel <= 0.2).all()), "GPU vs CPU totals disagree")

    # 5. times on the card, kernel and twin in turns
    a, b, x = (torch.randn(shape, generator=gen).to(dev) for shape in ((cyl[0], cyl[2]), (cyl[2], cyl[1]), cyl[:2]))
    kernel = lambda: dual_gemm.dual_contractions(a, b, x)  # noqa: E731
    twin = lambda: dual_gemm.dual_contractions_plain(a, b, x)  # noqa: E731
    k1, t1, t2, k2 = (time_ms(f, 200) for f in (kernel, twin, twin, kernel))
    k_ms, t_ms = (k1 + k2) / 2, (t1 + t2) / 2
    print(f"[5 time] {card}: dual_contractions at (n, m, K)={cyl}: kernel {k1 * 1e3:.1f}/{k2 * 1e3:.1f} us, "
          f"twin {t1 * 1e3:.1f}/{t2 * 1e3:.1f} us per call (kernel, twin, twin, kernel; 200 calls each); "
          f"eager training {art.steps_per_sec:.1f} steps/s over epochs 101-{SLICE_EPOCHS}")

    # 6. the records
    e_ax, e_xb, max_abs = errs[(3961, 1001, 47)]
    print(json.dumps({"kernels": [{
        "name": "dual_contractions",
        "route": "cuda",
        "source": "desmo_tpu_torch/csrc/dual_gemm.cu",
        "replaces": "desmo_tpu/pallas/dual_gemm.py:194",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": t_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
