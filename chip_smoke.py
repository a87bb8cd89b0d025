#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``desmo_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's four CUDA kernels from the sources in this checkout (one
``nvcc`` each, started together), holds each against its plain PyTorch
version at the main paths' shapes, and drives the training paths of four
presets at full width on synthetic data through ``runner.run``:

- cylinder (n=3961, m=1001, r=4, P=3): the eager loop
  (``chunk_method="scan"``) through the dual-contraction kernel, 300 epochs,
  and the preset as configured (``chunk_method="auto"``): the mega-kernel's
  desmo form, one launch per 2,000-epoch chunk, 10,000 epochs;
- fourier_cylinder (n=3961, m=1001, r=2, P=2, nF=10): the eager loop through
  the dual-contraction kernel, 100 epochs, and the preset as configured:
  the mega-kernel's Fourier form, one launch per 2,000-epoch chunk, 10,000
  epochs;
- the seed-packed ensemble (``n_seeds > 1``, ``ensemble.fit``): aneurysm
  (n=27000, m=1000, r=4, P=2) with 4 seeds through the packed eager loop
  (``chunk_method="scan"``, the dual-contraction kernel at the packed width
  K'=108), 100 epochs, and as configured through the packed mega-kernel,
  10,000 epochs; fourier_cylinder with 8 seeds (K'=96) as configured
  through the packed mega-kernel's Fourier form, 10,000 epochs;
- ae_cylinder (n=3961, m=1001, r=2, P=2, ae_beta=1e-3): as configured
  (``chunk_method="auto"``: the eager loop, its loss through the
  dual-contraction kernel), 100 epochs, and with ``chunk_method="megakernel"``
  through the AE kernel, one launch per 2,000-epoch chunk, 10,000 epochs;
- the space-sharded path (``runner.run(device_mesh=parallel.make_mesh(1))``,
  a one-rank NCCL group): cylinder and fourier_cylinder, 4,000 epochs each,
  through the sharded step kernel (``csrc/shard_step.cu``): one launch (the
  previous step's update, then this step's partials) and one all-reduce a
  step, the steps after a chunk's first replayed from a CUDA graph, and one
  more launch a chunk for its last update. Before it the step kernel is
  held against its plain version: the partials over all rows and
  over 2 and 3 uneven shards with their partials summed, and the update;
  and the sharded chunk against the mega-kernel;
- the space-sharded path with packed seeds (``runner.run`` with
  ``n_seeds`` over the same mesh, ``ensemble.fit(device_mesh=...)``):
  aneurysm with 4 seeds and fourier_cylinder with 8, 4,000 epochs each,
  through the step kernel's packed form; before it the packed step kernel
  is held against its plain version in float64 (the partials over 1-3
  shards, the update, the update alone, a NaN seed), and the sharded packed
  chunk against the packed mega-kernel; at aneurysm's reference init (B all
  ones), with 4 seeds and with one, the partials (AᵀX aside) and the
  mega-kernel's first-epoch sums (``train_chunk.epoch_sums``) within 5e-6
  of float64;
- resume: cylinder as configured (the mega-kernel), cylinder over the
  one-rank mesh (the step kernel) and ae_cylinder through the AE kernel,
  4,000 epochs straight against 2,000 and a ``runner.run(resume_from=...)``
  of ``state_epoch2000.npz`` for 2,000 more: the same state and metrics bit
  for bit; cylinder with the SIGTERM handler installed and a SIGTERM sent
  by a timer mid-run: it stops at a chunk boundary with ``preempted`` and
  ``state_final.npz``, and resumed to the end it gives the straight run's
  bits; a chunk boundary's host time with a checkpoint written on the
  worker thread against one written on the loop's thread;
- the large presets with one seed as configured through the mega-kernel,
  10,000 epochs each: channel (n=16384, m=1000, r=4, P=2, K=27, then its
  greedy pruning curve), aneurysm (n=27000, K=27) and fourier_aneurysm
  (n=27000, r=2, nF=30, K=12), each also held against its plain chunk and
  timed beside its bound;
- the Fourier run's extras at fourier_cylinder's full width: ``runner.run``
  with ``holdout=0.2`` (the fit at m=801) and ``period_multistart=4`` (four
  300-epoch probes, one launch each), 10,000 epochs through the mega-kernel,
  and the same without the multi-start; the ``evaluate`` subcommand with
  ``--forecast-after 801`` on the final ``.pt`` against ``forecast.json``;
  the probes through the kernel against its plain chunk at m=801; the
  device POD (snapshots, SVD, randomized) at aneurysm's size against the
  host POD, and a cylinder run with ``pod_method="snapshots"`` and the
  ``evaluate`` of its checkpoint with the same method, whose errors are
  equal.

Each path runs with every launch count set to 0 just before it and read just
after. The kernels build without spills (checked from ``-Xptxas -v``), and
the dual contraction is also held to float64 (5e-6 of max|ref|) at the
eager losses' three shapes, and gives the same bits on X as a view with
16-byte rows. Then it times each kernel (the dual contraction beside the
two cuBLAS products of its plain version, the mega-kernel in its four
forms, the AE kernel, the step kernel in its one-seed and packed forms)
against its plain version in turns, beside its bound (fp32, and 3xTF32 for
the kernels on the tensor cores), and splits the mega-kernel's and the AE
kernel's and the step kernel's time by phase with the kernels' own
clocks; the packed forms beside the single-seed kernel at the same preset;
the sharded path's step beside the mega-kernel's epoch, with its busy
share. Each phase prints its lines; any failed check exits non-zero. The second-to-last line is a JSON record of the
kernels; the last line is ``{"ok": true, "device": {...}}``. Exits non-zero
without printing a result when no CUDA device is available.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

EAGER_EPOCHS = 300
FOURIER_EAGER_EPOCHS = 100
PACKED_EAGER_EPOCHS = 100
CPU_EPOCHS = 10
SLICE_EPOCHS = 10_000
PARITY_STEPS = 200
STATE_STEPS = 30
TIMED_STEPS = 50
AE_EAGER_EPOCHS = 100
SHARDED_EPOCHS = 4_000
SHARDED_FOURIER_EPOCHS = 4_000
# the packed sharded slice: two of the presets' 2,000-epoch chunks, so that
# ensemble.fit times the second
PACKED_SHARDED_EPOCHS = 4_000
# the resume and preemption phases: two of the presets' 2,000-epoch chunks
RESUME_EPOCHS = 4_000
# the step kernel against its plain version evaluated in float64: the dual
# contraction's contract on every summed partial, and dl. The plain version
# in float32 is no yardstick here: cuBLAS sums AᵀX over n in one long chain,
# and the dictionary's constant column sums X's columns, whose terms cancel
# (measured on the H100: 6.4e-6 of max|AᵀX| at cylinder, 2.3e-5 at
# fourier_cylinder; the kernel 8.9e-7)
STEP_RTOL = 5e-6
STEP_DL_RTOL = 1e-5
# AᵀX of the step kernel at the reference init of aneurysm (n=27000): B is
# all ones there, so X·Bᵀ is X's row sums, which cancel to rounding; float32
# itself misses STEP_RTOL on AᵀX's constant row (the float32 plain version
# 1.9e-5 of max|AᵀX|, measured on the H100). Every other partial is held to
# STEP_RTOL there: gcoef and gomega sum each row tile as a pairwise tree
# (one fmaf chain over a block's ~205 rows reached 1.7e-5 on gomega)
STEP_INIT_RTOL = 5e-5
# kernel vs plain: 3xTF32 tiles against cuBLAS fp32, both accumulating in fp32
CONTRACTION_RTOL = 5e-5
# the dual contraction against float64 at the eager losses' shapes (cylinder,
# aneurysm with 4 packed seeds, fourier_cylinder and ae_cylinder), as phase
# 7c holds the mega-kernel's contractions
DUAL_SHAPES = ((3961, 1001, 47), (27000, 1000, 108), (3961, 1001, 12))
DUAL_F64_RTOL = 5e-6
GRAD_RTOL = 2e-4
# mega-kernel ortho vs plain: the absolute floor of tests/test_torch_train_chunk.py
ORTHO_ATOL = 1e-5
# the card's published peaks (H100 SXM, NVIDIA's data sheet): fp32 outside
# the tensor cores, TF32 on the tensor cores (dense), and HBM
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12


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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time for the work: operations at the fp32 peak or bytes at
    the memory rate, whichever is longer."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bound_3xtf32_ms(contraction_flops: float, other_flops: float, nbytes: float) -> float:
    """The least time with the products at fp32 grade on the tensor cores:
    ``contraction_flops`` as three TF32 passes, ``other_flops`` at the fp32
    rate, or the bytes at the memory rate, whichever is longer."""
    return 1e3 * max(3 * contraction_flops / PEAK_TF32 + other_flops / PEAK_FP32, nbytes / PEAK_BYTES)


def contraction_flops(n: int, m: int, k: int, seeds: int = 1) -> float:
    """Operations of one epoch's two contractions with X, AᵀX and XBᵀ, at the
    packed width K' = seeds k: 2nmK' each (the part of ``chunk_flops`` that
    runs on the tensor cores)."""
    return 2 * (2 * n * m * seeds * k)


def kernel_forms(log: str) -> list[tuple[str, int, int, int]]:
    """``(name, registers, bytes spilled, bytes of stack)`` of each kernel
    function in ``-Xptxas -v``'s report, the mega-kernel's, the step kernel's
    and the dual contraction's forms named by their KP (and form), registers
    -1 where the report gives none."""
    import re

    forms, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Function properties for (\S+)", line)
        if entry:
            mangled = entry.group(1)
            chunk = re.search(r"train_chunk_kernelILi(\d+)ELb([01])E", mangled)
            probe = re.search(r"contract_probe_kernelILi(\d+)E", mangled)
            step = re.search(r"step_kernelILi(\d+)ELb([01])ELb([01])E", mangled)
            dual = re.search(r"dual_kernelILi(\d+)E", mangled)
            other = re.search(r"(reduce_parts_kernel|ae_chunk_kernel)", mangled)
            name = (f"{'Fourier' if chunk.group(2) == '1' else 'desmo'} KP={chunk.group(1)}" if chunk
                    else f"step {'Fourier' if step.group(2) == '1' else 'desmo'}"
                         f"{' packed' if step.group(3) == '1' else ''} KP={step.group(1)}" if step
                    else f"probe KP={probe.group(1)}" if probe else f"dual KP={dual.group(1)}" if dual
                    else other.group(1) if other else mangled)
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            forms.append([name, int(spill.group(1)), int(spill.group(2)) + int(spill.group(3))])
        used = re.search(r"Used (\d+) registers", line)
        if used and forms and forms[-1][0] == name:
            forms[-1].append(int(used.group(1)))
            name = None
    return [(f[0], f[3] if len(f) > 3 else -1, f[2], f[1]) for f in forms]


def chunk_flops(n: int, m: int, k: int, nf: int = 0, seeds: int = 1) -> float:
    """Operations of one epoch of ``seeds`` packed models of K = k columns
    each (packed width K' = seeds k): AᵀX and XBᵀ (2nmK' each), A·gb and
    ga·B over each seed's own block (2nK'K and 2K'Km), and each seed's
    symmetric Grams AᵀA and BBᵀ, whose upper triangles need nK(K+1) and
    mK(K+1); the Fourier form adds its series forward and backward, 20
    operations per row, column and harmonic (the recurrence 6 and the sum 4
    forward; the recurrence, the two products and sums and the period's term
    backward)."""
    kp = seeds * k
    return (2 * (2 * n * m * kp) + 2 * n * kp * k + 2 * kp * k * m + seeds * (n * k * (k + 1) + m * k * (k + 1))
            + 20 * kp * m * nf)


def ae_flops(n: int, m: int, k: int) -> float:
    """Operations of one epoch of the AE kernel (r=2, the reference funnel,
    K = k dictionary columns): the four products with X (X·W0, X·V6ᵀ, D6ᵀX,
    Xᵀ·dpre1), 2nm·256 each; the narrow layers (256->...->2 and 2->...->256,
    84,304 weights a row) forward, backward and for their weight gradients,
    3 · 2n · 84,304; the symmetric D6ᵀD6 (n·256·257) and D6·VV (2n·256²);
    the symmetric V6V6ᵀ (m·256·257) and S_dd·V6 (2·256²·m); the dictionary's
    X·Bᵀ and AᵀX (2nmK each), A·gb (2nK²) and the symmetric Grams AᵀA and
    BBᵀ (nK(K+1) and mK(K+1))."""
    narrow = 84_304
    return (4 * 2 * n * m * 256 + 3 * 2 * n * narrow + n * 256 * 257 + 2 * n * 256 * 256 + m * 256 * 257
            + 2 * 256 * 256 * m + 4 * n * m * k + 2 * n * k * k + n * k * (k + 1) + m * k * (k + 1))


def step_flops(n: int, m: int, k: int, nf: int = 0, seeds: int = 1) -> float:
    """Operations of one launch of the step kernel over n rows for ``seeds``
    packed models of K = k columns each: the update and the partials of one
    step, the work of one mega-kernel epoch (``chunk_flops``): AᵀX and XBᵀ
    (2nmK' each), A·gb and ga·B over each seed's own block, each seed's
    symmetric AᵀA and BBᵀ, and the Fourier form's series forward and
    backward."""
    return chunk_flops(n, m, k, nf, seeds)


def step_bytes(n: int, m: int, k: int, r: int, nf: int = 0, seeds: int = 1) -> float:
    """Bytes one launch must move for ``seeds`` packed models of K = k
    columns and r latents each: X and the POD modes of its rows read once;
    the state read and written once (phi with its moments over its rows; B
    with its moments, or the Fourier form's series and periods with theirs
    and the t points read; c and omega with theirs; the scheduler vectors);
    the partial sums (each seed's diagonal Gram blocks), dl and the seeds'
    blocks of gb read and written once; a metrics row per seed and max_arg
    written."""
    kp, rp = seeds * k, seeds * r
    temporal = 3 * kp * (2 * nf + 1) + 3 * kp if nf else 3 * kp * m
    state = 3 * rp * n + temporal + 3 * kp + 9 * rp + 16 * seeds
    sums = seeds * (k * m + k * k + r * r + k + 3 * r)
    return 4 * (n * m + n * r + (m if nf else 0) + 2 * (state + sums + n * rp + seeds * k * k) + 4 * seeds + 1)


def rows_16b(x):
    """x as a view whose rows lie a multiple of 16 bytes apart (a zero-padded
    copy), as a caller may hand the dual contraction X."""
    import torch

    n, m = x.shape
    xv = torch.zeros((n, (m + 3) // 4 * 4), dtype=x.dtype, device=x.device)[:, :m]
    xv.copy_(x)
    return xv


def reset_launches(*counters) -> None:
    for fn in counters:
        fn.launches = 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA device", file=sys.stderr)
        return 1
    from desmo_tpu_torch import checkpoint, configs, device as device_mod, ensemble, losses, parallel, pod, runner, train
    from desmo_tpu_torch.kernels import _build, ae_chunk, dual_gemm, shard_step, train_chunk
    from desmo_tpu_torch.models import autoencoder, desmo, fourier

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

    # 2. build the kernels from this checkout's sources, one nvcc each, at once
    t0 = time.perf_counter()
    names = ("dual_gemm", "train_chunk", "ae_chunk", "shard_step")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(_build.build, names)))
    for name in libs:
        _build.load(name)
    print(f"[2 build] {', '.join(os.path.relpath(p) for p in libs.values())} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        report = [ln.split(":", 1)[-1].strip() for ln in _build.build_log(name).splitlines()
                  if "Used" in ln or "spill" in ln]
        print(f"[2 ptxas] {name}: {' | '.join(report)}")
    forms = kernel_forms(_build.build_log("train_chunk"))
    print("[2 ptxas] train_chunk by form: " + " | ".join(
        f"{name}: {regs} registers, {spill} bytes spilled, {stack} bytes of stack" for name, regs, spill, stack in forms))
    check(len(forms) == 12 and all(spill == 0 for _, _, spill, _ in forms),
          "the mega-kernel's forms (desmo and Fourier at KP=32/48/64/128, the probe) must build without spills")
    # the step kernel: desmo and Fourier, one seed and packed, at KP=32/48/64/128
    for name, count in (("dual_gemm", 6), ("ae_chunk", 1), ("shard_step", 16)):
        kforms = kernel_forms(_build.build_log(name))
        print(f"[2 ptxas] {name} by kernel: " + " | ".join(
            f"{kname}: {regs} registers, {spill} bytes spilled, {stack} bytes of stack"
            for kname, regs, spill, stack in kforms))
        check(len(kforms) == count and all(spill == 0 for _, _, spill, _ in kforms),
              f"{name}'s kernels must build without spills")

    counters = (dual_gemm.dual_contractions, train_chunk.fused_train_chunk, train_chunk.fused_ensemble_chunk,
                ae_chunk.fused_ae_chunk, shard_step.step)

    # 3. the dual contraction against its plain version at the main path's shapes
    gen = torch.Generator().manual_seed(0)
    errs = {}
    # the cylinder's width; the packed widths of the ensemble's eager loss at
    # aneurysm S=4 (K'=108) and fourier_cylinder S=8 (K'=96); the eager loss
    # of fourier_cylinder and ae_cylinder (K=12, the KP=16 build)
    for n, m, k in ((3961, 1001, 47), (700, 333, 50), (27000, 1000, 108), (3961, 1001, 96), (3961, 1001, 12)):
        a, b, x = (torch.randn(shape, generator=gen).to(dev) for shape in ((n, k), (k, m), (n, m)))
        ax, xb = dual_gemm.dual_contractions(a, b, x)
        torch.cuda.synchronize()
        pax, pxb = dual_gemm.dual_contractions_plain(a, b, x)
        torch.cuda.synchronize()
        e_ax, e_xb = rel_err(ax, pax), rel_err(xb, pxb)
        ax2, xb2 = dual_gemm.dual_contractions(a, b, x)
        torch.cuda.synchronize()
        check(e_ax <= CONTRACTION_RTOL and e_xb <= CONTRACTION_RTOL,
              f"dual kernel vs plain at {(n, m, k)}: ax {e_ax:.2e}, xb {e_xb:.2e} > {CONTRACTION_RTOL}")
        check(torch.equal(ax, ax2) and torch.equal(xb, xb2), f"two dual launches differ at {(n, m, k)}")
        errs[(n, m, k)] = max(float((ax - pax).abs().max()), float((xb - pxb).abs().max()))
        print(f"[3 dual] (n, m, K)={(n, m, k)}: max|err|/max|ref| ax {e_ax:.2e}, xb {e_xb:.2e} "
              f"(limit {CONTRACTION_RTOL:.0e}); repeat launch bit-identical")
        if (n, m, k) in DUAL_SHAPES:
            # X as a view with 16-byte rows: the same bits as contiguous X
            xv = rows_16b(x)
            axv, xbv = dual_gemm.dual_contractions(a, b, xv)
            rax, rxb = a.double().T @ x.double(), x.double() @ b.double().T
            e64 = (rel_err(ax.double(), rax), rel_err(xb.double(), rxb))
            e64_plain = (rel_err(pax.double(), rax), rel_err(pxb.double(), rxb))
            torch.cuda.synchronize()
            check(max(e64) <= DUAL_F64_RTOL, f"dual kernel vs float64 at {(n, m, k)}: ax, xb {e64} > {DUAL_F64_RTOL}")
            check(torch.equal(ax, axv) and torch.equal(xb, xbv),
                  f"dual kernel on X with 16-byte rows differs from contiguous X at {(n, m, k)}")
            print(f"[3 dual] (n, m, K)={(n, m, k)} vs float64: max|err|/max|ref| ax {e64[0]:.2e}, xb {e64[1]:.2e} "
                  f"(limit {DUAL_F64_RTOL:.0e}; the plain version in float32 {e64_plain[0]:.2e}, "
                  f"{e64_plain[1]:.2e}); X with {xv.stride(0)}-float rows: the same bits")
    cyl, k12 = DUAL_SHAPES[0], DUAL_SHAPES[2]
    for shape3 in (cyl, k12):
        a, b, x = (torch.randn(shape, generator=gen).to(dev) * s
                   for shape, s in (((shape3[0], shape3[2]), 0.3), ((shape3[2], shape3[1]), 0.3),
                                    ((shape3[0], shape3[1]), 1.0)))
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
              f"FactoredMSEFused vs autograd of factored_mse at {shape3}: value {e_val:.2e}, dA {e_da:.2e}, "
              f"dB {e_db:.2e}")
        print(f"[3 grad] FactoredMSEFused vs autograd(factored_mse) at {shape3}: value {e_val:.2e}, "
              f"dA {e_da:.2e}, dB {e_db:.2e} (limit {GRAD_RTOL:.0e} of max|g|)")

    preset = configs.get("cylinder")
    x_np, _ = runner.load_data(preset, synthetic=True)

    # 4. the eager path: chunk_method="scan", the fused loss through the dual kernel
    eager_cfg = dataclasses.replace(preset, chunk_method="scan", loss_method="fused",
                                    checkpoint_every=100, log_every=100)
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(*counters)
        t0 = time.perf_counter()
        art = runner.run(eager_cfg, x_np, out_dir=os.path.join(tmp, "gpu"), num_epochs=EAGER_EPOCHS, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dual_launches = dual_gemm.dual_contractions.launches
        chunk_launches = train_chunk.fused_train_chunk.launches
        hist = art.history
        check(all(hist[k].shape == (EAGER_EPOCHS,) for k in hist), "eager history length")
        check(all(bool(np.isfinite(hist[k]).all()) for k in hist), "non-finite loss in the eager history")
        check(hist["rec"][-1] < hist["rec"][0], f"eager rec did not fall: {hist['rec'][0]} -> {hist['rec'][-1]}")
        check(dual_launches == EAGER_EPOCHS,
              f"dual kernel launched {dual_launches} times in {EAGER_EPOCHS} loss evaluations")
        check(chunk_launches == 0, f"the eager path launched the mega-kernel {chunk_launches} times")
        files = set(os.listdir(art.out_dir))
        check({"cylinder_r4_final.pt", "state_final.npz"} <= files, f"missing exports in {sorted(files)}")
        check(art.relative_error == art.relative_error and len(art.sweep) == 14, "eager error/sweep")
        eager_sps = art.steps_per_sec
        print(f"[4 eager] cylinder n={art.config.n} m={art.config.m} r={preset.r} P={preset.poly_order}, "
              f"chunk_method=scan: {EAGER_EPOCHS} epochs in {wall:.1f} s (POD, sweep and exports included), "
              f"{eager_sps:.1f} steps/s over epochs 101-{EAGER_EPOCHS}; rec {hist['rec'][0]:.6e} -> "
              f"{hist['rec'][-1]:.6e}; dual kernel launches {dual_launches} = loss evaluations, mega-kernel 0")
        cpu = runner.run(eager_cfg, x_np, out_dir=os.path.join(tmp, "cpu"), num_epochs=CPU_EPOCHS,
                         echo=False, device="cpu")
    rel = abs(hist["total"][:CPU_EPOCHS] - cpu.history["total"]) / abs(cpu.history["total"])
    print(f"[4 cpu] |total_gpu - total_cpu|/|total_cpu| per epoch 0..{CPU_EPOCHS - 1}: "
          + " ".join(f"{v:.1e}" for v in rel))
    # omega starts at 1e4 and moves by lr_omega=1e3 a step, so the trig
    # arguments reach ~1e2-1e3 rad and fp32 rounding differences of sin/cos
    # grow about tenfold every one or two epochs. The JAX package against
    # itself, with X scaled by 1 + 2^-22, separates by 5e-2 by epoch 6
    # (tests/test_torch_runner.py). So the first 3 epochs are held to 1e-4
    # and the first 10 to that reference spread, 0.2.
    check(bool((rel[:3] <= 1e-4).all() and (rel <= 0.2).all()), "GPU vs CPU totals disagree")

    # 4f. the Fourier preset's eager path: the series loss through the dual kernel
    fpreset = configs.get("fourier_cylinder")
    fx_np, _ = runner.load_data(fpreset, synthetic=True)
    feager_cfg = dataclasses.replace(fpreset, chunk_method="scan", loss_method="fused",
                                     checkpoint_every=50, log_every=50)
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(*counters)
        t0 = time.perf_counter()
        art = runner.run(feager_cfg, fx_np, out_dir=tmp, num_epochs=FOURIER_EAGER_EPOCHS, echo=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dual_launches_f = dual_gemm.dual_contractions.launches
        chunk_launches_f = train_chunk.fused_train_chunk.launches
        hist = art.history
        check(all(bool(np.isfinite(hist[k]).all()) and hist[k].shape == (FOURIER_EAGER_EPOCHS,) for k in hist),
              "Fourier eager history")
        check(hist["rec"][-1] < hist["rec"][0], f"Fourier eager rec did not fall: {hist['rec'][0]} -> {hist['rec'][-1]}")
        check(dual_launches_f == FOURIER_EAGER_EPOCHS,
              f"dual kernel launched {dual_launches_f} times in {FOURIER_EAGER_EPOCHS} Fourier loss evaluations")
        check(chunk_launches_f == 0, f"the Fourier eager path launched the mega-kernel {chunk_launches_f} times")
        check("fourier_cylinder_r2_final.pt" in os.listdir(art.out_dir), "Fourier eager export")
        feager_sps = art.steps_per_sec
        print(f"[4f eager] fourier_cylinder n={art.config.n} m={art.config.m} r={fpreset.r} P={fpreset.poly_order} "
              f"nF={fpreset.n_fourier}, chunk_method=scan: {FOURIER_EAGER_EPOCHS} epochs in {wall:.1f} s, "
              f"{feager_sps:.1f} steps/s over epochs 51-{FOURIER_EAGER_EPOCHS}; rec {hist['rec'][0]:.6e} -> "
              f"{hist['rec'][-1]:.6e}; dual kernel launches {dual_launches_f} = loss evaluations, mega-kernel 0")

    # 4e. the seed-packed eager loop: aneurysm with 4 seeds, the packed loss
    # through the dual kernel at K'=108
    apreset = configs.get("aneurysm")
    ax_np, _ = runner.load_data(apreset, synthetic=True)
    packed_eager_cfg = dataclasses.replace(apreset, n_seeds=4, chunk_method="scan", loss_method="fused",
                                           checkpoint_every=50, log_every=50)
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(*counters)
        t0 = time.perf_counter()
        art = runner.run(packed_eager_cfg, ax_np, out_dir=tmp, num_epochs=PACKED_EAGER_EPOCHS, echo=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        packed_dual_launches = dual_gemm.dual_contractions.launches
        hist = art.history
        check(all(bool(np.isfinite(hist[k]).all()) and hist[k].shape == (PACKED_EAGER_EPOCHS,) for k in hist),
              "packed eager history")
        check(hist["rec"][-1] < hist["rec"][0], f"packed eager rec did not fall: {hist['rec'][0]} -> {hist['rec'][-1]}")
        check(packed_dual_launches == PACKED_EAGER_EPOCHS,
              f"dual kernel launched {packed_dual_launches} times in {PACKED_EAGER_EPOCHS} packed loss evaluations")
        check(train_chunk.fused_train_chunk.launches == train_chunk.fused_ensemble_chunk.launches == 0,
              "the packed eager path launched a mega-kernel")
        with open(os.path.join(art.out_dir, "ensemble.json")) as fh:
            record = json.load(fh)
        check(record["n_seeds"] == 4 and len(record["final_totals"]) == 4, f"packed eager ensemble.json: {record}")
        packed_eager_sps = record["seed_steps_per_sec"]
        print(f"[4e eager] aneurysm n={art.config.n} m={art.config.m} r={apreset.r} P={apreset.poly_order}, 4 seeds "
              f"(K'=108), chunk_method=scan: {PACKED_EAGER_EPOCHS} epochs in {wall:.1f} s, {packed_eager_sps} "
              f"seed-steps/s over epochs 51-{PACKED_EAGER_EPOCHS}; best seed {record['best_seed']}, rec "
              f"{hist['rec'][0]:.6e} -> {hist['rec'][-1]:.6e}; dual kernel launches {packed_dual_launches} = loss "
              "evaluations, mega-kernel 0")

    # 4a. the AE preset as configured: chunk_method="auto" keeps the eager
    # loop for the AE variant, its loss through the dual kernel at K=12
    aepreset = configs.get("ae_cylinder")
    aex_np, _ = runner.load_data(aepreset, synthetic=True)
    ae_eager_cfg = dataclasses.replace(aepreset, checkpoint_every=50, log_every=50)
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(*counters)
        t0 = time.perf_counter()
        art = runner.run(ae_eager_cfg, aex_np, out_dir=tmp, num_epochs=AE_EAGER_EPOCHS, echo=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ae_dual_launches = dual_gemm.dual_contractions.launches
        hist = art.history
        check(set(hist) == {"rec", "ortho", "l1", "ae", "total"}, f"AE eager history keys {sorted(hist)}")
        check(all(bool(np.isfinite(hist[k]).all()) and hist[k].shape == (AE_EAGER_EPOCHS,) for k in hist),
              "AE eager history")
        check(hist["rec"][-1] < hist["rec"][0], f"AE eager rec did not fall: {hist['rec'][0]} -> {hist['rec'][-1]}")
        check(ae_dual_launches == AE_EAGER_EPOCHS,
              f"dual kernel launched {ae_dual_launches} times in {AE_EAGER_EPOCHS} AE loss evaluations")
        check(ae_chunk.fused_ae_chunk.launches == train_chunk.fused_train_chunk.launches == 0,
              "the AE eager path launched a chunk kernel")
        check("ae_cylinder_r2_final.pt" in os.listdir(art.out_dir), "AE eager export")
        ae_eager_sps = art.steps_per_sec
        print(f"[4a eager] ae_cylinder n={art.config.n} m={art.config.m} r={aepreset.r} P={aepreset.poly_order} "
              f"as configured (chunk_method=auto: the eager loop): {AE_EAGER_EPOCHS} epochs in {wall:.1f} s, "
              f"{ae_eager_sps:.1f} steps/s over epochs 51-{AE_EAGER_EPOCHS}; rec {hist['rec'][0]:.6e} -> "
              f"{hist['rec'][-1]:.6e}, ae {hist['ae'][0]:.6e} -> {hist['ae'][-1]:.6e}; dual kernel launches "
              f"{ae_dual_launches} = loss evaluations, AE kernel 0")

    # 5. the mega-kernel against the plain chunk at full width
    pod_modes = pod.pod_host(x_np, preset.r, dev).modes
    batch = runner.prepare_batch(x_np, pod_modes, dev)
    K = desmo.DesmoSpec(preset.n, preset.m, preset.r, preset.poly_order).num_poly_terms + 3 * preset.r

    def start(cfg):
        spec = desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
        return spec, train.init_state(desmo.Desmo(spec, device=dev).params(), cfg)

    def exact_distances(state, batch_, spec_, cfg, mk, mp):
        """The largest distance over PARITY_STEPS epochs of the kernel's
        trace ``mk`` and of the plain chunk's ``mp`` from the float64 one
        (``shard_step.plain_trace``), as a share of it: rec, l1, total."""
        exact = shard_step.plain_trace(state, batch_, PARITY_STEPS, spec_, cfg)
        return {who: {k: trace_rel({k: m[k].double()}, exact, k, PARITY_STEPS) for k in ("rec", "l1", "total")}
                for who, m in (("kernel", mk), ("plain", mp))}

    def trace_rel(mk, mp, key, steps):
        return ((mk[key][:steps] - mp[key][:steps]).abs() / mp[key][:steps].abs()).max().item()

    # omega_init=1 with lr_omega=1: the trig arguments stay O(1)
    unit = dataclasses.replace(preset, omega_init=1.0, lr_omega=1.0)
    spec, st = start(unit)
    sk, mk = train_chunk.fused_train_chunk(st, batch, PARITY_STEPS, spec, unit)
    torch.cuda.synchronize()
    sp, mp = train_chunk.train_chunk_plain(st, batch, PARITY_STEPS, spec, unit)
    sk2, mk2 = train_chunk.fused_train_chunk(st, batch, PARITY_STEPS, spec, unit)
    torch.cuda.synchronize()
    identical = all(torch.equal(mk[k], mk2[k]) for k in mk) and all(
        torch.equal(sk.params[k], sk2.params[k]) for k in sk.params)
    check(identical, "two mega-kernel launches from the same state differ")
    eager_loss = desmo.build_loss(spec, unit.beta, unit.l1_lambda, method="factored")
    eager = train.make_train_chunk(eager_loss, desmo.param_groups(st.params), unit)
    se, _ = eager(st, batch, PARITY_STEPS)
    # the contraction probe's inputs (phase 7c): the dictionary and temporal
    # matrix of the kernel's state after PARITY_STEPS epochs, and X
    probe_inputs = {"cylinder": (desmo.spatial_dictionary(sk.params, batch["pod_modes"],
                                                          desmo.factor_tensor(spec, dev))[0].contiguous(),
                                 desmo.temporal_matrix(sk.params).contiguous(), batch["x"])}
    e_trace = {k: trace_rel(mk, mp, k, PARITY_STEPS) for k in ("rec", "l1", "total")}
    # reported, not held: the kernel's and the plain chunk's distance from
    # the exact trajectory (step_plain in float64 from the same state)
    e64 = exact_distances(st, batch, spec, unit, mk, mp)
    ortho_diff = (mk["ortho"][1:] - mp["ortho"][1:]).abs()
    e_ortho = (ortho_diff / mp["ortho"][1:].abs()).max().item()
    # every metric of one state: one epoch of each from the kernel's state
    _, mk1 = train_chunk.fused_train_chunk(sk, batch, 1, spec, unit)
    _, mp1 = train_chunk.train_chunk_plain(sk, batch, 1, spec, unit)
    e_one = {k: ((mk1[k] - mp1[k]).abs() / mp1[k].abs()).item() for k in train_chunk.METRICS}
    one_ok = all(bool((mk1[k] - mp1[k]).abs() <= 2e-4 * mp1[k].abs() + (ORTHO_ATOL if k == "ortho" else 0.0))
                 for k in train_chunk.METRICS)
    e_params = {k: rel_err(sk.params[k], sp.params[k]) for k in sk.params}
    e_kernel_eager = max(rel_err(sk.params[k], se.params[k]) for k in sk.params)
    e_eager_plain = max(rel_err(se.params[k], sp.params[k]) for k in sp.params)
    chunk_max_abs = max(float((sk.params[k] - sp.params[k]).abs().max()) for k in sk.params)
    print(f"[5 unit] mega-kernel vs plain chunk, omega_init=1 lr_omega=1, {PARITY_STEPS} epochs at "
          f"(n, m, K)=({preset.n}, {preset.m}, {K}): trace " + ", ".join(f"{k} {v:.2e}" for k, v in e_trace.items())
          + f", ortho over epochs 1-{PARITY_STEPS - 1} {e_ortho:.2e} (max abs {ortho_diff.max().item():.2e})"
          + "; params " + ", ".join(f"{k} {v:.2e}" for k, v in e_params.items())
          + f"; kernel vs eager loop {e_kernel_eager:.2e}, eager loop vs plain {e_eager_plain:.2e} of max|param|;"
          " two launches bit-identical")
    print(f"[5 unit] the trace against the step in float64 (step_plain) over the same {PARITY_STEPS} epochs: kernel "
          + ", ".join(f"{k} {v:.2e}" for k, v in e64["kernel"].items()) + "; the plain chunk in float32 "
          + ", ".join(f"{k} {v:.2e}" for k, v in e64["plain"].items()))
    print(f"[5 unit] one epoch from the kernel's state after {PARITY_STEPS}, kernel vs plain: "
          + ", ".join(f"{k} {v:.2e}" for k, v in e_one.items())
          + f" (limit 2e-4; ortho plus {ORTHO_ATOL:.0e} absolute)")
    sk30, _ = train_chunk.fused_train_chunk(st, batch, STATE_STEPS, spec, unit)
    sp30, _ = train_chunk.train_chunk_plain(st, batch, STATE_STEPS, spec, unit)
    e_params30 = max(rel_err(sk30.params[k], sp30.params[k]) for k in sp30.params)
    print(f"[5 unit] mega-kernel vs plain chunk after {STATE_STEPS} epochs: params {e_params30:.2e} of max|param|")
    # The trace is held to the JAX suite's 2e-4 over all 200 epochs, and the
    # params to its 5e-4 after its 30 epochs. Ortho is not held along the
    # trajectory: at epoch 0 it is the fp32 rounding of an orthonormal POD
    # Gram (6e-8), whose sign steers phi's ortho gradient, so the two
    # trajectories' ortho rows part (3.6e-3 over epochs 1-199, measured on
    # the H100). Every metric, ortho included, is held to 2e-4 (ortho plus
    # the CPU suite's 1e-5 absolute) on one epoch from one state. After 200 the
    # params are held to 1e-2: correct implementations of the step drift
    # apart there, since Adamax divides each gradient by its running maximum
    # and an entry whose gradient is near zero steps by +-lr on rounding
    # alone. Measured on the H100: the eager loop and the plain chunk 9.4e-4
    # apart (the line above), two versions of this kernel that differ only
    # in summation order 1.8e-3 (scripts/torch_ab_train_chunk.py), the
    # kernel and the eager loop up to 4.6e-3.
    check(max(e_trace.values()) <= 2e-4, f"mega-kernel trace vs plain beyond 2e-4: {e_trace}")
    check(one_ok, f"mega-kernel metrics of one state vs plain beyond 2e-4: {e_one}")
    check(e_params30 <= 5e-4, f"mega-kernel params vs plain after {STATE_STEPS} epochs beyond 5e-4: {e_params30}")
    check(max(e_params.values()) <= 1e-2, f"mega-kernel params vs plain beyond 1e-2: {e_params}")

    # the preset's omega_init=1e4: chaotic after a few epochs (phase 4)
    spec, st = start(preset)
    sk, mk = train_chunk.fused_train_chunk(st, batch, 10, spec, preset)
    sp, mp = train_chunk.train_chunk_plain(st, batch, 10, spec, preset)
    e3, e10 = trace_rel(mk, mp, "total", 3), trace_rel(mk, mp, "total", 10)
    print(f"[5 preset] mega-kernel vs plain chunk, omega_init=1e4: total over epochs 0-2 {e3:.2e} "
          f"(limit 1e-4), over 0-9 {e10:.2e} (limit 0.2)")
    check(e3 <= 1e-4 and e10 <= 0.2, "mega-kernel vs plain at the preset's omega")

    # 5f. the Fourier form against its plain chunk at fourier_cylinder's full width
    fpod = pod.pod_host(fx_np, fpreset.r, dev).modes
    fbatch = runner.prepare_batch(fx_np, fpod, dev)

    def fstart(cfg):
        spec = fourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier,
                                   cfg.period_init)
        return spec, train.init_state(fourier.Fourier(spec, device=dev).params(), cfg)

    funit = dataclasses.replace(fpreset, omega_init=1.0, lr_omega=1.0)
    fspec, fst = fstart(funit)
    fK = fspec.num_poly_terms + 3 * fspec.r
    sk, mk = train_chunk.fused_train_chunk(fst, fbatch, PARITY_STEPS, fspec, funit)
    torch.cuda.synchronize()
    sp, mp = train_chunk.train_chunk_plain(fst, fbatch, PARITY_STEPS, fspec, funit)
    sk2, mk2 = train_chunk.fused_train_chunk(fst, fbatch, PARITY_STEPS, fspec, funit)
    torch.cuda.synchronize()
    check(all(torch.equal(mk[k], mk2[k]) for k in mk) and all(torch.equal(sk.params[k], sk2.params[k]) for k in sk.params),
          "two Fourier mega-kernel launches from the same state differ")
    fe_trace = {k: trace_rel(mk, mp, k, PARITY_STEPS) for k in ("rec", "l1", "total")}
    fe_l1_30 = trace_rel(mk, mp, "l1", STATE_STEPS)
    sk1, mk1 = train_chunk.fused_train_chunk(sk, fbatch, 1, fspec, funit)
    sp1, mp1 = train_chunk.train_chunk_plain(sk, fbatch, 1, fspec, funit)
    fe_one = {k: ((mk1[k] - mp1[k]).abs() / mp1[k].abs()).item() for k in train_chunk.METRICS}
    fone_ok = all(bool((mk1[k] - mp1[k]).abs() <= 2e-4 * mp1[k].abs() + (ORTHO_ATOL if k == "ortho" else 0.0))
                  for k in train_chunk.METRICS)
    fe_one_params = {k: rel_err(sk1.params[k], sp1.params[k]) for k in sk1.params}
    fourier_max_abs = max(float((sk1.params[k] - sp1.params[k]).abs().max()) for k in sk1.params)
    fe_params = {k: rel_err(sk.params[k], sp.params[k]) for k in sk.params}
    sk30, _ = train_chunk.fused_train_chunk(fst, fbatch, STATE_STEPS, fspec, funit)
    sp30, _ = train_chunk.train_chunk_plain(fst, fbatch, STATE_STEPS, fspec, funit)
    fe_params30 = {k: rel_err(sk30.params[k], sp30.params[k]) for k in sp30.params}
    # the spread of two correct implementations: the plain chunk on the CPU
    cpu_batch = runner.prepare_batch(fx_np, fpod.cpu(), torch.device("cpu"))
    fst_cpu = train.init_state(fourier.Fourier(fspec).params(), funit)
    sc30, _ = train_chunk.train_chunk_plain(fst_cpu, cpu_batch, STATE_STEPS, fspec, funit)
    sc, mc = train_chunk.train_chunk_plain(fst_cpu, cpu_batch, PARITY_STEPS, fspec, funit)
    fe_spread30 = max(rel_err(sp30.params[k].cpu(), sc30.params[k]) for k in sc30.params)
    fe_spread = max(rel_err(sp.params[k].cpu(), sc.params[k]) for k in sc.params)
    fe_trace_spread = {k: float(((mp[k].cpu() - mc[k]).abs() / mc[k].abs()).max()) for k in ("rec", "l1", "total")}
    fe64 = exact_distances(fst, fbatch, fspec, funit, mk, mp)  # reported, as in phase 5
    print(f"[5f unit] Fourier mega-kernel vs plain chunk, omega_init=1 lr_omega=1, {PARITY_STEPS} epochs at "
          f"(n, m, K, nF)=({fpreset.n}, {fpreset.m}, {fK}, {fpreset.n_fourier}): trace "
          + ", ".join(f"{k} {v:.2e}" for k, v in fe_trace.items())
          + f" (l1 over epochs 0-{STATE_STEPS - 1} {fe_l1_30:.2e}); params "
          + ", ".join(f"{k} {v:.2e}" for k, v in fe_params.items()) + " of max|param|; two launches bit-identical")
    print(f"[5f unit] the plain chunk on the GPU vs on the CPU over the same {PARITY_STEPS} epochs: trace "
          + ", ".join(f"{k} {v:.2e}" for k, v in fe_trace_spread.items()) + f"; params {fe_spread:.2e} of max|param|")
    print(f"[5f unit] the trace against the step in float64 (step_plain) over the same {PARITY_STEPS} epochs: "
          "kernel " + ", ".join(f"{k} {v:.2e}" for k, v in fe64["kernel"].items()) + "; the plain chunk in float32 "
          + ", ".join(f"{k} {v:.2e}" for k, v in fe64["plain"].items()))
    print(f"[5f unit] one epoch from the kernel's state after {PARITY_STEPS}, kernel vs plain: metrics "
          + ", ".join(f"{k} {v:.2e}" for k, v in fe_one.items())
          + f" (limit 2e-4; ortho plus {ORTHO_ATOL:.0e} absolute); params "
          + ", ".join(f"{k} {v:.2e}" for k, v in fe_one_params.items()) + " of max|param| (limit 1e-5)")
    print(f"[5f unit] after {STATE_STEPS} epochs: kernel vs plain chunk, params "
          + ", ".join(f"{k} {v:.2e}" for k, v in fe_params30.items())
          + f" of max|param|; the plain chunk on the GPU vs on the CPU {fe_spread30:.2e}")
    # Every metric and every parameter of one epoch from one state are held
    # to 2e-4 and 1e-5, rec and total over 200 epochs to 2e-4, and l1 over
    # the JAX suite's 30. Along the trajectory the lat1*lat2 term's series
    # row and coefficient have near-zero gradients, which Adamax steps by
    # +-lr on rounding alone, so even the plain chunk on the GPU and on the
    # CPU part there (the lines above print by how much): l1 over 200 epochs
    # is held to 1e-3 and the parameters, after 30 epochs as after 200, to
    # 1e-2.
    check(fe_trace["rec"] <= 2e-4 and fe_trace["total"] <= 2e-4 and fe_l1_30 <= 2e-4 and fe_trace["l1"] <= 1e-3,
          f"Fourier mega-kernel trace vs plain beyond its limits: {fe_trace}, l1 over {STATE_STEPS}: {fe_l1_30}")
    check(fone_ok, f"Fourier mega-kernel metrics of one state vs plain beyond 2e-4: {fe_one}")
    check(max(fe_one_params.values()) <= 1e-5, f"Fourier params of one epoch from one state beyond 1e-5: {fe_one_params}")
    check(max(fe_params30.values()) <= 1e-2 and max(fe_params.values()) <= 1e-2,
          f"Fourier mega-kernel params vs plain beyond 1e-2: {fe_params30}, {fe_params}")

    fspec, fst = fstart(fpreset)
    sk, mk = train_chunk.fused_train_chunk(fst, fbatch, 3, fspec, fpreset)
    sp, mp = train_chunk.train_chunk_plain(fst, fbatch, 3, fspec, fpreset)
    fe3 = trace_rel(mk, mp, "total", 3)
    print(f"[5f preset] Fourier mega-kernel vs plain chunk, omega_init=1e4: total over epochs 0-2 {fe3:.2e} "
          "(limit 1e-4)")
    check(fe3 <= 1e-4, "Fourier mega-kernel vs plain at the preset's omega")

    # 5e/5ef. the packed form against its plain chunk at the ensemble cells'
    # full width (aneurysm S=4, K'=108; fourier_cylinder S=8, K'=96), with
    # omega_init=1 and lr_omega=1, the seeds jittered as ensemble.fit jitters
    # them
    packed_checks = {}
    for tag, preset_cfg, data, seeds, make_spec in (
        ("5e", apreset, ax_np, 4, lambda c: desmo.DesmoSpec(c.n, c.m, c.r, c.poly_order, c.omega_init)),
        ("5ef", fpreset, fx_np, 8, lambda c: fourier.FourierSpec(c.n, c.m, c.r, c.poly_order, c.omega_init,
                                                                 c.n_fourier, c.period_init)),
    ):
        cfg = dataclasses.replace(preset_cfg, omega_init=1.0, lr_omega=1.0)
        spec = make_spec(cfg)
        pbatch = runner.prepare_batch(data, pod.pod_host(data, cfg.r, dev).modes, dev)

        def packed_state(cfg, spec, seeds):
            params = ensemble.init_params(spec, seeds, seed=cfg.seed, phi_sigma=cfg.seed_phi_sigma,
                                          omega_spread=cfg.seed_omega_spread, device=dev)
            return ensemble.init_state(params, cfg, seeds)

        pst = packed_state(cfg, spec, seeds)
        sk, mk = train_chunk.fused_ensemble_chunk(pst, pbatch, PARITY_STEPS, spec, cfg)
        torch.cuda.synchronize()
        if tag == "5e":  # the packed columns of the seeds, for the contraction probe (phase 7c)
            seeds_p = [train_chunk.seed_view(sk, s_).params for s_ in range(seeds)]
            factors = desmo.factor_tensor(spec, dev)
            probe_inputs[f"{cfg.name} S={seeds}"] = (
                torch.cat([desmo.spatial_dictionary(q, pbatch["pod_modes"], factors)[0] for q in seeds_p], 1).contiguous(),
                torch.cat([desmo.temporal_matrix(q) for q in seeds_p], 0).contiguous(), pbatch["x"])
        sp, mp = train_chunk.train_chunk_plain_packed(pst, pbatch, PARITY_STEPS, spec, cfg)
        sk2, mk2 = train_chunk.fused_ensemble_chunk(pst, pbatch, PARITY_STEPS, spec, cfg)
        torch.cuda.synchronize()
        identical = all(torch.equal(mk[k], mk2[k]) for k in mk) and all(
            torch.equal(sk.params[k], sk2.params[k]) for k in sk.params)
        e_trace = {k: float(((mk[k] - mp[k]).abs() / mp[k].abs()).max()) for k in ("rec", "total_s")}
        # every metric and parameter of one epoch from the kernel's state
        sk1, mk1 = train_chunk.fused_ensemble_chunk(sk, pbatch, 1, spec, cfg)
        sp1, mp1 = train_chunk.train_chunk_plain_packed(sk, pbatch, 1, spec, cfg)
        e_one = {k: float(((mk1[k] - mp1[k]).abs() / mp1[k].abs()).max()) for k in train_chunk.SEED_METRICS}
        one_ok = all(bool(((mk1[k] - mp1[k]).abs() <= 1e-5 * mp1[k].abs() + (ORTHO_ATOL if k == "ortho" else 0.0)).all())
                     for k in train_chunk.SEED_METRICS)
        e_one_params = max(rel_err(sk1.params[k], sp1.params[k]) for k in sk1.params)
        one_max_abs = max(float((sk1.params[k] - sp1.params[k]).abs().max()) for k in sk1.params)
        # each seed against the single-seed kernel run alone from its state
        e_alone = 0.0
        for s_ in range(seeds):
            so, mo = train_chunk.fused_train_chunk(train_chunk.seed_view(pst, s_), pbatch, PARITY_STEPS, spec, cfg)
            e_alone = max(e_alone, float(((mk["total_s"][:, s_] - mo["total"]).abs() / mo["total"].abs()).max()),
                          max(rel_err(sk.params[k][s_], so.params[k]) for k in so.params))
        # per-seed beta, lambda and LR scale
        betas = np.geomspace(cfg.beta, 10.0 * cfg.beta, seeds).astype(np.float32)
        lams = np.geomspace(cfg.l1_lambda, 10.0 * cfg.l1_lambda, seeds).astype(np.float32)
        hst = ensemble.init_state(pst.params, cfg, seeds, lr_scales=np.where(np.arange(seeds) % 2, 0.5, 1.0))
        _, mh = train_chunk.fused_ensemble_chunk(hst, pbatch, STATE_STEPS, spec, cfg, betas, lams)
        _, mhp = train_chunk.train_chunk_plain_packed(hst, pbatch, STATE_STEPS, spec, cfg, betas, lams)
        e_hyper = max(float(((mh[k] - mhp[k]).abs() / mhp[k].abs()).max()) for k in ("rec", "l1", "total_s"))
        # seed 1 poisoned: its metrics go non-finite, every other seed's stay finite
        bad = ensemble.init_state({**pst.params, "phi": pst.params["phi"].clone()}, cfg, seeds)
        bad.params["phi"][1] = float("nan")
        _, mb = train_chunk.fused_ensemble_chunk(bad, pbatch, 3, spec, cfg)
        others = [s_ for s_ in range(seeds) if s_ != 1]
        isolated = all(not bool(torch.isfinite(mb[k][:, 1]).any()) and bool(torch.isfinite(mb[k][:, others]).all())
                       for k in ("rec", "ortho", "total_s"))
        packed_checks[tag] = dict(max_abs=one_max_abs, batch=pbatch, make_spec=make_spec, start=packed_state)
        print(f"[{tag} packed] {cfg.name} {seeds} seeds (K'={seeds * (spec.num_poly_terms + 3 * spec.r)}), "
              f"omega_init=1 lr_omega=1, phi jitter {cfg.seed_phi_sigma}: kernel vs plain over {PARITY_STEPS} epochs, "
              f"per-seed trace " + ", ".join(f"{k} {v:.2e}" for k, v in e_trace.items())
              + f" (limit 2e-4); one epoch from the kernel's state: metrics "
              + ", ".join(f"{k} {v:.2e}" for k, v in e_one.items())
              + f" (limit 1e-5; ortho plus {ORTHO_ATOL:.0e} absolute), params {e_one_params:.2e} of max|param| "
              f"(limit 1e-5); each seed against the single-seed kernel alone {e_alone:.2e} (limit 2e-5); per-seed "
              f"beta, lambda and LR scale over {STATE_STEPS} epochs {e_hyper:.2e} (limit 2e-4); seed 1 poisoned: "
              f"others finite {isolated}; two launches bit-identical {identical}")
        check(identical, f"{tag}: two packed launches from the same state differ")
        check(max(e_trace.values()) <= 2e-4, f"{tag}: packed trace vs plain beyond 2e-4: {e_trace}")
        check(one_ok and e_one_params <= 1e-5, f"{tag}: one epoch from one state beyond 1e-5: {e_one}, {e_one_params}")
        check(e_alone <= 2e-5, f"{tag}: a packed seed differs from the seed run alone by {e_alone}")
        check(e_hyper <= 2e-4, f"{tag}: per-seed hypers vs plain beyond 2e-4: {e_hyper}")
        check(isolated, f"{tag}: a poisoned seed reached another seed's metrics")

    # 5a. the AE kernel against its plain chunk at ae_cylinder's full width,
    # from the live init (the reference init's decoder is dead: every MLP
    # weight's gradient is 0.0), omega_init=1 and tame LRs (at 1e4 a 1-ulp
    # latent difference flips the signs of sin)
    ae_batch = runner.prepare_batch(aex_np, None, dev)
    aeK = autoencoder.AESpec(aepreset.n, aepreset.m, aepreset.r, aepreset.poly_order).num_poly_terms + 3 * aepreset.r

    def ae_start(cfg, live=True):
        spec = autoencoder.AESpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
        init = autoencoder.init_params_live if live else autoencoder.init_params
        return spec, train.init_state(init(spec, seed=cfg.seed, device=dev), cfg)

    ae_unit = dataclasses.replace(aepreset, omega_init=1.0, lr_coef=1e-3, lr_z=1e-3, lr_omega=1e-2)
    aspec, ast = ae_start(ae_unit)
    sk, mk = ae_chunk.fused_ae_chunk(ast, ae_batch, STATE_STEPS, aspec, ae_unit)
    torch.cuda.synchronize()
    sp, mp = ae_chunk.ae_chunk_plain(ast, ae_batch, STATE_STEPS, aspec, ae_unit)
    sk2, mk2 = ae_chunk.fused_ae_chunk(ast, ae_batch, STATE_STEPS, aspec, ae_unit)
    torch.cuda.synchronize()
    ae_identical = all(torch.equal(mk[k], mk2[k]) for k in mk) and all(
        torch.equal(sk.params[k], sk2.params[k]) for k in sk.params)
    ae_trace = {k: trace_rel(mk, mp, k, STATE_STEPS) for k in ae_chunk.METRICS}
    ae_params = max(rel_err(sk.params[k], sp.params[k]) for k in sk.params)
    print(f"[5a unit] AE kernel vs plain chunk, live init, omega_init=1, {STATE_STEPS} epochs at (n, m, K)="
          f"({aepreset.n}, {aepreset.m}, {aeK}): trace " + ", ".join(f"{k} {v:.2e}" for k, v in ae_trace.items())
          + f"; params {ae_params:.2e} of max|param|; two launches bit-identical {ae_identical}")
    print("[5a unit] metrics over the epochs, kernel: " + "; ".join(
        f"{k} " + " ".join(f"{v:.6e}" for v in mk[k][::6].tolist()) for k in ("rec", "ae", "total")))
    sk1, mk1 = ae_chunk.fused_ae_chunk(sk, ae_batch, 1, aspec, ae_unit)
    sp1, mp1 = ae_chunk.ae_chunk_plain(sk, ae_batch, 1, aspec, ae_unit)
    ae_one = {k: ((mk1[k] - mp1[k]).abs() / mp1[k].abs()).item() for k in ae_chunk.METRICS}
    ae_one_params = {k: rel_err(sk1.params[k], sp1.params[k]) for k in sk1.params}
    ae_max_abs = max(float((sk1.params[k] - sp1.params[k]).abs().max()) for k in sk1.params)
    worst = sorted(ae_one_params.items(), key=lambda kv: -kv[1])[:4]
    print(f"[5a unit] one epoch from the kernel's state after {STATE_STEPS}, kernel vs plain: metrics "
          + ", ".join(f"{k} {v:.2e}" for k, v in ae_one.items()) + " (limit 2e-4); params: largest "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst) + " of max|param| (limit 1e-5)")
    aspec_p, ast_p = ae_start(aepreset, live=False)
    _, mkp = ae_chunk.fused_ae_chunk(ast_p, ae_batch, 3, aspec_p, aepreset)
    _, mpp = ae_chunk.ae_chunk_plain(ast_p, ae_batch, 3, aspec_p, aepreset)
    ae_e0, ae_e3 = trace_rel(mkp, mpp, "total", 1), trace_rel(mkp, mpp, "total", 3)
    print(f"[5a preset] AE kernel vs plain chunk, the preset's init and omega_init=1e4: total at epoch 0 "
          f"{ae_e0:.2e}, over epochs 0-2 {ae_e3:.2e} (unchecked: at 1e4 a 1-ulp latent difference flips the "
          "signs of sin)")
    check(ae_identical, "two AE kernel launches from the same state differ")
    check(max(ae_one.values()) <= 2e-4, f"AE kernel metrics of one state vs plain beyond 2e-4: {ae_one}")
    check(max(ae_one_params.values()) <= 1e-5, f"AE params of one epoch from one state beyond 1e-5: {worst}")
    check(max(ae_trace.values()) <= 5e-4, f"AE kernel trace vs plain beyond 5e-4: {ae_trace}")

    # 6. the slice: the preset as configured, through the mega-kernel
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(*counters)
        t0 = time.perf_counter()
        art = runner.run(preset, x_np, out_dir=tmp, num_epochs=SLICE_EPOCHS, echo=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chunk_launches = train_chunk.fused_train_chunk.launches
        slice_dual = dual_gemm.dual_contractions.launches
        hist = art.history
        n_chunks = SLICE_EPOCHS // preset.checkpoint_every
        check(all(hist[k].shape == (SLICE_EPOCHS,) for k in hist), "slice history length")
        check(all(bool(np.isfinite(hist[k]).all()) for k in hist), "non-finite loss in the slice history")
        check(hist["rec"][-1] < hist["rec"][0], f"slice rec did not fall: {hist['rec'][0]} -> {hist['rec'][-1]}")
        check(chunk_launches == n_chunks, f"mega-kernel launched {chunk_launches} times for {n_chunks} chunks")
        check(slice_dual == 0, f"the mega-kernel path launched the dual kernel {slice_dual} times")
        files = set(os.listdir(art.out_dir))
        want = {"cylinder_r4_final.pt", "state_final.npz"} | {
            f"state_epoch{e}.npz" for e in range(preset.checkpoint_every, SLICE_EPOCHS + 1, preset.checkpoint_every)}
        check(want <= files, f"missing exports in {sorted(files)}")
        check(art.relative_error == art.relative_error and len(art.sweep) == 14, "slice error/sweep")
        slice_sps = art.steps_per_sec
        print(f"[6 slice] cylinder as configured (chunk_method=auto): {SLICE_EPOCHS} epochs in {wall:.1f} s "
              f"(POD, sweep and exports included), {slice_sps:.1f} steps/s over chunks 2-{n_chunks}; rec "
              f"{hist['rec'][0]:.6e} -> {hist['rec'][-1]:.6e}; relative error {art.relative_error:.6f}; "
              f"mega-kernel launches {chunk_launches} = chunks, dual kernel 0")

    # 6f. the Fourier preset as configured, through the mega-kernel's Fourier form
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(*counters)
        t0 = time.perf_counter()
        art = runner.run(fpreset, fx_np, out_dir=tmp, num_epochs=SLICE_EPOCHS, echo=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fourier_launches = train_chunk.fused_train_chunk.launches
        fslice_dual = dual_gemm.dual_contractions.launches
        hist = art.history
        n_chunks = SLICE_EPOCHS // fpreset.checkpoint_every
        check(all(bool(np.isfinite(hist[k]).all()) and hist[k].shape == (SLICE_EPOCHS,) for k in hist),
              "Fourier slice history")
        check(hist["rec"][-1] < hist["rec"][0], f"Fourier slice rec did not fall: {hist['rec'][0]} -> {hist['rec'][-1]}")
        check(fourier_launches == n_chunks, f"Fourier mega-kernel launched {fourier_launches} times for {n_chunks} chunks")
        check(fslice_dual == 0, f"the Fourier mega-kernel path launched the dual kernel {fslice_dual} times")
        files = set(os.listdir(art.out_dir))
        want = {"fourier_cylinder_r2_final.pt", "state_final.npz"} | {
            f"state_epoch{e}.npz" for e in range(fpreset.checkpoint_every, SLICE_EPOCHS + 1, fpreset.checkpoint_every)}
        check(want <= files, f"missing Fourier exports in {sorted(files)}")
        sd = torch.load(os.path.join(art.out_dir, "fourier_cylinder_r2_final.pt"), weights_only=True)
        check({"period_list.0", "trig_period_list.5"} <= set(sd) and tuple(sd["z_list.0"].shape) == (21,),
              "Fourier export keys")
        check(art.relative_error == art.relative_error and len(art.sweep) == 14, "Fourier slice error/sweep")
        fslice_sps = art.steps_per_sec
        print(f"[6f slice] fourier_cylinder as configured (chunk_method=auto): {SLICE_EPOCHS} epochs in {wall:.1f} s "
              f"(POD, sweep and exports included), {fslice_sps:.1f} steps/s over chunks 2-{n_chunks}; rec "
              f"{hist['rec'][0]:.6e} -> {hist['rec'][-1]:.6e}; relative error {art.relative_error:.6f}, POD(r) "
              f"{art.pod_error_r:.6f}; periods {sd['period_list.0'].item():.4f} ...; mega-kernel launches "
              f"{fourier_launches} = chunks, dual kernel 0")

    # 6e/6ef. the ensemble cells: runner.run as configured with n_seeds, the
    # packed mega-kernel one launch per 2,000-epoch chunk
    ensemble_runs = {}
    for tag, preset_cfg, data, seeds in (("6e", apreset, ax_np, 4), ("6ef", fpreset, fx_np, 8)):
        cfg = dataclasses.replace(preset_cfg, n_seeds=seeds)
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches(*counters)
            t0 = time.perf_counter()
            art = runner.run(cfg, data, out_dir=tmp, num_epochs=SLICE_EPOCHS, echo=False, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = train_chunk.fused_ensemble_chunk.launches
            hist = art.history
            n_chunks = SLICE_EPOCHS // cfg.checkpoint_every
            check(all(bool(np.isfinite(hist[k]).all()) and hist[k].shape == (SLICE_EPOCHS,) for k in hist),
                  f"{tag} history")
            check(hist["rec"][-1] < hist["rec"][0], f"{tag} rec did not fall: {hist['rec'][0]} -> {hist['rec'][-1]}")
            check(launches == n_chunks, f"{tag}: packed mega-kernel launched {launches} times for {n_chunks} chunks")
            check(dual_gemm.dual_contractions.launches == train_chunk.fused_train_chunk.launches == 0,
                  f"{tag}: the packed path launched another kernel")
            files = set(os.listdir(art.out_dir))
            check({"ensemble.json", "term_stability.json", "state_final.npz", f"{cfg.name}_r{cfg.r}_final.pt"} <= files,
                  f"{tag}: missing records in {sorted(files)}")
            with open(os.path.join(art.out_dir, "ensemble.json")) as fh:
                record = json.load(fh)
            finals = record["final_totals"]
            check(len(finals) == seeds and record["diverged_seeds"] == [] and all(v is not None for v in finals),
                  f"{tag}: ensemble.json {record}")
            check(record["best_seed"] == int(np.argmin(finals)), f"{tag}: best seed {record['best_seed']} of {finals}")
            check(np.isfinite(art.relative_error) and len(art.sweep) == 14, f"{tag}: error/sweep")
            ensemble_runs[tag] = dict(launches=launches, sps=record["seed_steps_per_sec"])
            print(f"[{tag} ensemble] {cfg.name} n={art.config.n} m={art.config.m} as configured with n_seeds={seeds} "
                  f"(chunk_method=auto): {SLICE_EPOCHS} epochs in {wall:.1f} s (POD, sweep and exports included), "
                  f"{record['seed_steps_per_sec']:.1f} seed-steps/s over chunks 2-{n_chunks}; best seed "
                  f"{record['best_seed']}, final totals {', '.join(f'{v:.6e}' for v in finals)}; rec "
                  f"{hist['rec'][0]:.6e} -> {hist['rec'][-1]:.6e}; relative error {art.relative_error:.6f}, POD(r) "
                  f"{art.pod_error_r:.6f}; packed mega-kernel launches {launches} = chunks, other kernels 0")

    # 6a. the AE slice: runner.run on ae_cylinder through the AE kernel, one
    # launch per 2,000-epoch chunk
    ae_slice_cfg = dataclasses.replace(aepreset, chunk_method="megakernel")
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(*counters)
        t0 = time.perf_counter()
        art = runner.run(ae_slice_cfg, aex_np, out_dir=tmp, num_epochs=SLICE_EPOCHS, echo=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ae_launches = ae_chunk.fused_ae_chunk.launches
        hist = art.history
        n_chunks = SLICE_EPOCHS // aepreset.checkpoint_every
        check(set(hist) == {"rec", "ortho", "l1", "total", "ae"}, f"AE slice history keys {sorted(hist)}")
        check(all(bool(np.isfinite(hist[k]).all()) and hist[k].shape == (SLICE_EPOCHS,) for k in hist),
              "AE slice history")
        check(hist["rec"][-1] < hist["rec"][0], f"AE slice rec did not fall: {hist['rec'][0]} -> {hist['rec'][-1]}")
        check(ae_launches == n_chunks, f"AE kernel launched {ae_launches} times for {n_chunks} chunks")
        check(sum(fn.launches for fn in counters) == ae_launches, "the AE kernel path launched another kernel")
        files = set(os.listdir(art.out_dir))
        want = {"ae_cylinder_r2_final.pt", "state_final.npz"} | {
            f"state_epoch{e}.npz" for e in range(aepreset.checkpoint_every, SLICE_EPOCHS + 1, aepreset.checkpoint_every)}
        check(want <= files, f"missing AE exports in {sorted(files)}")
        sd = torch.load(os.path.join(art.out_dir, "ae_cylinder_r2_final.pt"), weights_only=True)
        check(autoencoder.is_ae_state_dict(sd) and tuple(sd["temporal_ae.encoder.0.weight"].shape) == (256, 1001),
              "AE export keys")
        check(np.isfinite(art.relative_error) and len(art.sweep) == 14, "AE slice error/sweep")
        ae_slice_sps = art.steps_per_sec
        print(f"[6a slice] ae_cylinder with chunk_method=megakernel: {SLICE_EPOCHS} epochs in {wall:.1f} s "
              f"(POD, sweep and exports included), {ae_slice_sps:.1f} steps/s over chunks 2-{n_chunks}; rec "
              f"{hist['rec'][0]:.6e} -> {hist['rec'][-1]:.6e}, ae {hist['ae'][0]:.6e} -> {hist['ae'][-1]:.6e}; "
              f"relative error {art.relative_error:.6f}, POD(2) {art.pod_error_r:.6f}, POD(4) "
              f"{art.pod_error_2r:.6f}; sweep {len(art.sweep)} rows; AE kernel launches {ae_launches} = chunks, "
              "other kernels 0")

    # 7. times on the card, each kernel and its plain version in turns; the
    # dual contraction's plain version is the two cuBLAS fp32 products, its
    # library yardstick (no one call computes both)
    dual_times = {}
    for shape3, what in zip(DUAL_SHAPES, ("the cylinder eager loss'", "the packed eager loss'",
                                          "the fourier_cylinder and ae_cylinder eager losses'")):
        n, m, k = shape3
        a, b, x = (torch.randn(shape, generator=gen).to(dev) for shape in ((n, k), (k, m), (n, m)))
        kernel = lambda: dual_gemm.dual_contractions(a, b, x)  # noqa: E731
        plain = lambda: dual_gemm.dual_contractions_plain(a, b, x)  # noqa: E731
        iters = 50 if n > 10_000 else 200
        k1, p1, p2, k2 = (time_ms(f, iters) for f in (kernel, plain, plain, kernel))
        # where m is not a multiple of 4, X's rows take 4-byte copies: the
        # same call on a view with 16-byte rows, for the cost of that
        xv = rows_16b(x) if m % 4 else None
        k16 = time_ms(lambda: dual_gemm.dual_contractions(a, b, xv), iters) if m % 4 else None
        nbytes = 4 * (2 * n * k + 2 * k * m + n * m)
        bound, by = bound_ms(2 * (2 * n * m * k), nbytes)
        bound3 = bound_3xtf32_ms(2 * (2 * n * m * k), 0, nbytes)
        dual_times[shape3] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": bound, "bound_by": by,
                              "bound_3xtf32_ms": bound3}
        print(f"[7 time] {card}: dual_contractions at {what} (n, m, K)={shape3}: kernel {k1 * 1e3:.1f}/{k2 * 1e3:.1f} "
              f"us, the cuBLAS pair (plain version, the library yardstick) {p1 * 1e3:.1f}/{p2 * 1e3:.1f} us per call "
              f"(kernel, plain, plain, kernel; {iters} calls each); bound {bound * 1e3:.1f} us ({by}, fp32), "
              f"{bound3 * 1e3:.1f} us (3xTF32)" + ("" if k16 is None else
                                                    f"; X with 16-byte rows: kernel {k16 * 1e3:.1f} us"))
    cyl, aneurysm_dual, k12 = DUAL_SHAPES
    n, m, k = cyl

    spec, st = start(preset)
    kernel = lambda: train_chunk.fused_train_chunk(st, batch, TIMED_STEPS, spec, preset)  # noqa: E731
    plain = lambda: train_chunk.train_chunk_plain(st, batch, TIMED_STEPS, spec, preset)  # noqa: E731
    k1, p1, p2, k2 = (time_ms(f, 3) for f in (kernel, plain, plain, kernel))
    chunk_ms, chunk_plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    long_ms = time_ms(lambda: train_chunk.fused_train_chunk(st, batch, preset.checkpoint_every, spec, preset), 2)
    split = train_chunk.phase_split(st, batch, preset.checkpoint_every, spec, preset)
    split_total = sum(split.values())
    state_bytes = 4 * 2 * (3 * preset.r * n + 3 * K * m + 3 * K + 9 * preset.r + train_chunk.SVEC)
    chunk_bytes = 4 * (n * m + n * preset.r + TIMED_STEPS * len(train_chunk.METRICS)) + state_bytes
    chunk_bound, chunk_by = bound_ms(TIMED_STEPS * chunk_flops(n, m, K), chunk_bytes)
    chunk_bound3 = bound_3xtf32_ms(TIMED_STEPS * contraction_flops(n, m, K),
                                   TIMED_STEPS * (chunk_flops(n, m, K) - contraction_flops(n, m, K)), chunk_bytes)
    loss_fn = desmo.build_loss(spec, preset.beta, preset.l1_lambda, method="fused")
    eager = train.make_train_chunk(loss_fn, desmo.param_groups(st.params), preset)
    eager_ms = time_ms(lambda: eager(st, batch, TIMED_STEPS), 2) / TIMED_STEPS
    per_epoch = 1e3 / TIMED_STEPS
    print(f"[7 time] {card}: mega-kernel {long_ms * 1e3 / preset.checkpoint_every:.1f} us/epoch over a "
          f"{preset.checkpoint_every}-epoch chunk; over {TIMED_STEPS}-epoch chunks in turns: kernel "
          f"{k1 * per_epoch:.1f}/{k2 * per_epoch:.1f} us/epoch, plain chunk {p1 * per_epoch:.1f}/"
          f"{p2 * per_epoch:.1f} us/epoch; eager step {eager_ms * 1e3:.1f} us; bound "
          f"{chunk_bound * per_epoch:.1f} us/epoch ({chunk_by}; 3xTF32: {chunk_bound3 * per_epoch:.1f}); "
          f"slice {slice_sps:.1f} steps/s, "
          f"eager path {eager_sps:.1f} steps/s")

    phases: dict[str, float] = {}
    for k, v in split.items():
        phases[k.split(".")[0]] = phases.get(k.split(".")[0], 0.0) + v
    per_epoch_us = 1e6 / preset.checkpoint_every
    print(f"[7 split] {card}: mega-kernel over a {preset.checkpoint_every}-epoch chunk (kernel clock, "
          f"block 0): prologue {split['prologue'] * 1e6:.1f} us once; "
          + ", ".join(f"{k} {v * per_epoch_us:.1f} us/epoch ({v / split_total:.1%})"
                      for k, v in phases.items() if k != "prologue")
          + "; by part " + ", ".join(f"{k} {v * per_epoch_us:.1f}" for k, v in split.items() if "." in k)
          + " us/epoch")

    fspec, fst = fstart(fpreset)
    kernel = lambda: train_chunk.fused_train_chunk(fst, fbatch, TIMED_STEPS, fspec, fpreset)  # noqa: E731
    plain = lambda: train_chunk.train_chunk_plain(fst, fbatch, TIMED_STEPS, fspec, fpreset)  # noqa: E731
    k1, p1, p2, k2 = (time_ms(f, 3) for f in (kernel, plain, plain, kernel))
    fourier_ms, fourier_plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    flong_ms = time_ms(lambda: train_chunk.fused_train_chunk(fst, fbatch, fpreset.checkpoint_every, fspec, fpreset), 2)
    fsplit = train_chunk.phase_split(fst, fbatch, fpreset.checkpoint_every, fspec, fpreset)
    nc, fr = 2 * fpreset.n_fourier + 1, fpreset.r
    fstate_bytes = 4 * 2 * (3 * fr * n + 3 * fK * nc + 3 * fK + 3 * fK + 9 * fr + train_chunk.SVEC)
    fchunk_bytes = 4 * (n * m + n * fr + m + TIMED_STEPS * len(train_chunk.METRICS)) + fstate_bytes
    fourier_bound, fourier_by = bound_ms(TIMED_STEPS * chunk_flops(n, m, fK, fpreset.n_fourier), fchunk_bytes)
    fourier_bound3 = bound_3xtf32_ms(
        TIMED_STEPS * contraction_flops(n, m, fK),
        TIMED_STEPS * (chunk_flops(n, m, fK, fpreset.n_fourier) - contraction_flops(n, m, fK)), fchunk_bytes)
    print(f"[7f time] {card}: Fourier mega-kernel at (n, m, K, nF)=({n}, {m}, {fK}, {fpreset.n_fourier}): "
          f"{flong_ms * 1e3 / fpreset.checkpoint_every:.1f} us/epoch over a {fpreset.checkpoint_every}-epoch chunk; "
          f"over {TIMED_STEPS}-epoch chunks in turns: kernel {k1 * per_epoch:.1f}/{k2 * per_epoch:.1f} us/epoch, "
          f"plain chunk {p1 * per_epoch:.1f}/{p2 * per_epoch:.1f} us/epoch; bound "
          f"{fourier_bound * per_epoch:.1f} us/epoch ({fourier_by}; 3xTF32: {fourier_bound3 * per_epoch:.1f}); "
          f"slice {fslice_sps:.1f} steps/s, "
          f"eager path {feager_sps:.1f} steps/s")
    fsplit_total = sum(fsplit.values())
    print(f"[7f split] {card}: Fourier mega-kernel over a {fpreset.checkpoint_every}-epoch chunk (kernel clock, "
          f"block 0): prologue {fsplit['prologue'] * 1e6:.1f} us once; "
          + ", ".join(f"{k} {v * per_epoch_us:.1f} us/epoch ({v / fsplit_total:.1%})"
                      for k, v in fsplit.items() if k != "prologue") + "")

    # 7c. the mega-kernel's two contractions alone (train_chunk.contract_probe:
    # the kernel's own X·Bᵀ and AᵀX routines, one launch) against the plain
    # version evaluated in float64, at cylinder and at aneurysm S=4 (K'=108),
    # on the dictionaries and temporal matrices of phases 5 and 5e: the step
    # kernel's contract, STEP_RTOL of max|ref|; two launches bit-identical
    for name, (pa, pb, px) in probe_inputs.items():
        xb, ax = train_chunk.contract_probe(pa, pb, px)
        xb2, ax2 = train_chunk.contract_probe(pa, pb, px)
        torch.cuda.synchronize()
        same = torch.equal(xb, xb2) and torch.equal(ax, ax2)
        rxb, rax = px.double() @ pb.double().T, pa.double().T @ px.double()
        e_xb, e_ax = rel_err(xb.double(), rxb), rel_err(ax.double(), rax)
        fxb, fax = train_chunk.contract_probe_plain(pa, pb, px)
        probe_ms = time_ms(lambda: train_chunk.contract_probe(pa, pb, px), 20)
        n, k = pa.shape
        print(f"[7c probe] {card}: contractions at {name} (n, m, K)=({n}, {px.shape[1]}, {k}) against float64: "
              f"X·Bᵀ {e_xb:.2e}, AᵀX {e_ax:.2e} of max|ref| (limit {STEP_RTOL:.0e}); the float32 plain version "
              f"{rel_err(fxb.double(), rxb):.2e}, {rel_err(fax.double(), rax):.2e}; repeat launch bit-identical "
              f"{same}; {probe_ms * 1e3:.1f} us per probe launch (both products and the A copy)")
        check(e_xb <= STEP_RTOL and e_ax <= STEP_RTOL and same,
              f"contraction probe at {name}: X·Bᵀ {e_xb:.2e}, AᵀX {e_ax:.2e} > {STEP_RTOL} or launches differ")

    # 7e/7ef. the packed kernel and the single-seed kernel at the same preset,
    # in turns over a 2,000-epoch chunk, with the packed form's phase split
    packed_times = {}
    for tag, pc_tag, cfg, seeds in (("7e", "5e", apreset, 4), ("7ef", "5ef", fpreset, 8)):
        pc = packed_checks[pc_tag]
        spec, pbatch = pc["make_spec"](cfg), pc["batch"]
        pst = pc["start"](cfg, spec, seeds)
        one = train_chunk.seed_view(pst, 0)
        E = cfg.checkpoint_every
        kernel = lambda: train_chunk.fused_ensemble_chunk(pst, pbatch, E, spec, cfg)  # noqa: E731
        single = lambda: train_chunk.fused_train_chunk(one, pbatch, E, spec, cfg)  # noqa: E731
        k1, s1, s2, k2 = (time_ms(f, 1) * 1e3 / E for f in (kernel, single, single, kernel))
        short = lambda: train_chunk.fused_ensemble_chunk(pst, pbatch, TIMED_STEPS, spec, cfg)  # noqa: E731
        plain = lambda: train_chunk.train_chunk_plain_packed(pst, pbatch, TIMED_STEPS, spec, cfg)  # noqa: E731
        q1, p1, p2, q2 = (time_ms(f, 1) for f in (short, plain, plain, short))
        split = train_chunk.phase_split(pst, pbatch, E, spec, cfg)
        single_split = train_chunk.phase_split(one, pbatch, E, spec, cfg)
        n, m = pbatch["x"].shape
        ks, r, nf = spec.num_poly_terms + 3 * spec.r, spec.r, train_chunk.n_fourier(spec, cfg)
        kp = seeds * ks
        width = 2 * nf + 1 if nf else m
        state_bytes = 4 * 2 * (3 * seeds * r * n + 3 * kp * width + 3 * kp * (2 if nf else 1) + 9 * seeds * r
                               + seeds * train_chunk.SVEC)
        nbytes = 4 * (n * m + n * r + (m if nf else 0) + TIMED_STEPS * seeds * len(train_chunk.METRICS)) + state_bytes
        bound, by = bound_ms(TIMED_STEPS * chunk_flops(n, m, ks, nf, seeds), nbytes)
        bound3 = bound_3xtf32_ms(TIMED_STEPS * contraction_flops(n, m, ks, seeds),
                                 TIMED_STEPS * (chunk_flops(n, m, ks, nf, seeds) - contraction_flops(n, m, ks, seeds)),
                                 nbytes)
        single_bound, _ = bound_ms(TIMED_STEPS * chunk_flops(n, m, ks, nf), 4 * n * m)
        packed_us, single_us = (k1 + k2) / 2, (s1 + s2) / 2
        # the record's times are of one TIMED_STEPS-epoch chunk, as phases 7 and 7f's
        packed_times[tag] = dict(ms=(q1 + q2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound, bound_by=by,
                                 bound_3xtf32_ms=bound3)
        print(f"[{tag} time] {card}: {cfg.name} {seeds} seeds (K'={kp}) as configured: packed kernel "
              f"{k1:.1f}/{k2:.1f} us/epoch, single-seed kernel {s1:.1f}/{s2:.1f} us/epoch (packed, single, single, "
              f"packed; {E}-epoch chunks); bounds {bound * 1e3 / TIMED_STEPS:.1f} us/epoch packed ({by}; "
              f"3xTF32: {bound3 * 1e3 / TIMED_STEPS:.1f}), "
              f"{single_bound * 1e3 / TIMED_STEPS:.1f} single; over {TIMED_STEPS}-epoch chunks in turns: packed "
              f"kernel {q1 * 1e3 / TIMED_STEPS:.1f}/{q2 * 1e3 / TIMED_STEPS:.1f} us/epoch, plain packed chunk "
              f"{p1 * 1e3 / TIMED_STEPS:.1f}/{p2 * 1e3 / TIMED_STEPS:.1f} us/epoch; cost_vs_single_x "
              f"{packed_us / single_us:.3f}, seed_throughput_x {seeds * single_us / packed_us:.3f}; end to end "
              f"{ensemble_runs['6e' if tag == '7e' else '6ef']['sps']:.1f} seed-steps/s")
        for name, sp in (("packed", split), ("single-seed", single_split)):
            sp_total = sum(sp.values())
            print(f"[{tag} split] {card}: {name} kernel over a {E}-epoch chunk (kernel clock, block 0): "
                  + ", ".join(f"{k} {v * 1e6 / E:.1f} us/epoch ({v / sp_total:.1%})"
                              for k, v in sp.items() if k != "prologue"))

    # 7a. the AE kernel: its plain version in turns over TIMED_STEPS-epoch
    # chunks, a 2,000-epoch chunk, the eager step and the phase split
    aspec, ast = ae_start(aepreset, live=False)
    kernel = lambda: ae_chunk.fused_ae_chunk(ast, ae_batch, TIMED_STEPS, aspec, aepreset)  # noqa: E731
    plain = lambda: ae_chunk.ae_chunk_plain(ast, ae_batch, TIMED_STEPS, aspec, aepreset)  # noqa: E731
    k1, p1, p2, k2 = (time_ms(f, 2) for f in (kernel, plain, plain, kernel))
    ae_ms, ae_plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    E = aepreset.checkpoint_every
    ae_long_ms = time_ms(lambda: ae_chunk.fused_ae_chunk(ast, ae_batch, E, aspec, aepreset), 1)
    ae_split = ae_chunk.phase_split(ast, ae_batch, E, aspec, aepreset)
    n, m = aepreset.n, aepreset.m
    mlp = ae_chunk.mlp_size(m)
    ae_state_bytes = 4 * 2 * (3 * mlp + 3 * aeK * m + 3 * aeK + 18 + train_chunk.SVEC)
    ae_bytes = 4 * (n * m + m + TIMED_STEPS * len(ae_chunk.METRICS)) + ae_state_bytes
    ae_bound, ae_by = bound_ms(TIMED_STEPS * ae_flops(n, m, aeK), ae_bytes)
    # every product of the epoch (ae_flops counts products only) as three
    # TF32 passes on the tensor cores: all of them are fp32-grade work the
    # card can do at that rate
    ae_bound3 = bound_3xtf32_ms(TIMED_STEPS * ae_flops(n, m, aeK), 0, ae_bytes)
    ae_loss = autoencoder.build_loss(aspec, aepreset.beta, aepreset.l1_lambda, aepreset.ae_beta, method="fused")
    ae_eager = train.make_train_chunk(ae_loss, autoencoder.param_groups(ast.params), aepreset)
    ae_eager_ms = time_ms(lambda: ae_eager(ast, ae_batch, TIMED_STEPS), 1) / TIMED_STEPS
    print(f"[7a time] {card}: AE kernel at (n, m, K)=({n}, {m}, {aeK}): {ae_long_ms * 1e3 / E:.1f} us/epoch over a "
          f"{E}-epoch chunk; over {TIMED_STEPS}-epoch chunks in turns: kernel {k1 * per_epoch:.1f}/{k2 * per_epoch:.1f} "
          f"us/epoch, plain chunk {p1 * per_epoch:.1f}/{p2 * per_epoch:.1f} us/epoch; eager step "
          f"{ae_eager_ms * 1e3:.1f} us; bound {ae_bound * per_epoch:.1f} us/epoch ({ae_by}, "
          f"{ae_flops(n, m, aeK) / 1e9:.2f} GFLOP an epoch; all of it in 3xTF32 on the tensor cores: "
          f"{ae_bound3 * per_epoch:.1f}); slice {ae_slice_sps:.1f} steps/s, eager path {ae_eager_sps:.1f} steps/s")
    ae_split_total = sum(ae_split.values())
    ae_columns = sum(ae_split[k] for k in ("encoder.columns", "encoder.barrier", "columns.weights", "weights.barrier",
                                            "columns.v6", "columns.barrier"))
    print(f"[7a split] {card}: AE kernel over a {E}-epoch chunk (kernel clock, block 0): prologue "
          f"{ae_split['prologue'] * 1e6:.1f} us once; "
          + ", ".join(f"{k} {v * 1e6 / E:.1f} us/epoch ({v / ae_split_total:.1%})"
                      for k, v in ae_split.items() if k != "prologue")
          + f"; the column phases with their barriers {ae_columns * 1e6 / E:.1f} us/epoch; bound "
          f"{ae_bound * per_epoch:.1f} us/epoch (fp32), {ae_bound3 * per_epoch:.1f} (3xTF32)")

    # 8a. the step kernel against its plain version at cylinder (K=47) and
    # fourier_cylinder (K=12), from one state (omega_init=1): the partials
    # alone (step_partials: the counter at 0) over all rows in one launch and
    # over 2 and 3 uneven shards with their partials summed, as the ranks of
    # a mesh would sum them, against the plain version in float64; then the
    # prologue: from the kernel's state after one step, the update of that
    # step followed by the next step's partials, against step_plain in
    # float64 on the same state and sums
    def step_args(cfg, st):
        cs = train_chunk.pack_seeds(train_chunk.stack_seed(st), [cfg.beta], [cfg.l1_lambda])
        if cs.series is None:
            b = cs.b[0]
        else:
            tw = torch.as_tensor(fourier.TWO_PI * fourier.t_points(cfg.m), device=dev)
            b = train_chunk.series_forward(cs.series[0], cs.periods[0], tw)[0]
        return (batch_of[cfg.name]["pod_modes"], batch_of[cfg.name]["x"], cs.phi[0], b, b @ b.T, cs.coef[0],
                cs.omega[0])

    batch_of = {preset.name: batch, fpreset.name: fbatch}
    parts = ("ax", "ga", "latg", "gcoef", "gomega")
    step_checks = {}
    for cfg, make in ((unit, start), (funit, fstart)):
        spec_s, st_s = make(cfg)
        args = step_args(cfg, st_s)
        n, m, r = cfg.n, cfg.m, cfg.r
        k = spec_s.num_poly_terms + 3 * r
        ref32 = shard_step.step_partials_plain(*args, spec_s, n)
        ref = shard_step.step_partials_plain(*(a.double() for a in args), spec_s, n)
        got = shard_step.step_partials(*args, spec_s, n)
        again = shard_step.step_partials(*args, spec_s, n)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, b) for a, b in zip(got, again))
        plain_err = {"dl": rel_err(ref32[0].double(), ref[0])}
        plain_err.update({name: rel_err(g.double(), w) for name, g, w in zip(
            parts, shard_step.split_sums(ref32[1], k, m, r), shard_step.split_sums(ref[1], k, m, r))})
        worst = {}
        for d in (1, 2, 3):
            spans = [parallel.row_range(n, d, rank) for rank in range(d)]
            outs = [shard_step.step_partials(args[0][lo:hi].contiguous(), args[1][lo:hi].contiguous(),
                                             args[2][:, lo:hi].contiguous(), *args[3:], spec_s, n) for lo, hi in spans]
            torch.cuda.synchronize()
            e = {"dl": rel_err(torch.cat([o[0] for o in outs]).double(), ref[0])}
            summed = shard_step.split_sums(sum(o[1] for o in outs), k, m, r)
            e.update({name: rel_err(g.double(), w)
                      for name, g, w in zip(parts, summed, shard_step.split_sums(ref[1], k, m, r))})
            same_max = float(max(o[2] for o in outs)) == float(ref32[2])
            worst = {key: max(v, worst.get(key, 0.0)) for key, v in e.items()}
            check(e["dl"] <= STEP_DL_RTOL and all(e[name] <= STEP_RTOL for name in parts) and same_max,
                  f"{cfg.name}: step kernel over {d} shard(s) vs plain beyond its limits: {e}, max_arg equal {same_max}")
        check(identical, f"{cfg.name}: two step kernel launches from the same state differ")
        step_checks[cfg.name] = dict(max_abs=max(float((g.double() - w).abs().max()) for g, w in zip(got, ref)),
                                     args=args, spec=spec_s, shape=(n, m, k, r))
        print(f"[8a step] {cfg.name} (n, m, K)=({n}, {m}, {k}), omega_init=1: step kernel over all rows and over 2 and "
              f"3 uneven shards (partials summed) vs the plain version over all rows in float64, worst of the three: "
              + ", ".join(f"{key} {v:.2e}" for key, v in worst.items())
              + f" of max|ref| (limits: dl {STEP_DL_RTOL:.0e}, the sums {STEP_RTOL:.0e}); the plain version in float32 "
              "vs float64: " + ", ".join(f"{key} {v:.2e}" for key, v in plain_err.items())
              + f"; max_arg equal to the float32 plain's; two launches bit-identical; max |kernel - plain (float64)| "
              f"{step_checks[cfg.name]['max_abs']:.3e}")
        buf = shard_step.make_buffers(train_chunk.pack_seeds(train_chunk.stack_seed(st_s), [cfg.beta], [cfg.l1_lambda]),
                                      batch_of[cfg.name], 2, spec_s, cfg, n)
        shard_step.step(buf, spec_s)  # step 0's partials; on one rank they are the summed ones
        ref = buf.to("cpu", torch.float64)
        twice = [buf.clone(), buf.clone()]
        for run in twice:
            shard_step.step(run, spec_s)
        torch.cuda.synchronize()
        shard_step.step_plain(ref, spec_s)
        got = twice[0]
        fields = ("sums", "dl", "gb", "met", "max_arg", "count")
        same = all(torch.equal(getattr(twice[0], f), getattr(twice[1], f)) for f in fields) and all(
            torch.equal(getattr(twice[0].cs, f), getattr(twice[1].cs, f)) for f in ("phi", "coef", "omega", "svec"))
        params = ("phi", "coef", "omega") + (("series", "periods") if got.nf else ("b",))
        e_met = {key: abs(float(got.met[0, 0, i]) - float(ref.met[0, 0, i])) / abs(float(ref.met[0, 0, i]))
                 for i, key in enumerate(shard_step.ROW_METRICS)}
        met_ok = all(abs(float(got.met[0, 0, i]) - float(ref.met[0, 0, i])) <= 2e-4 * abs(float(ref.met[0, 0, i]))
                     + (ORTHO_ATOL if key == "ortho" else 0.0) for i, key in enumerate(shard_step.ROW_METRICS))
        e_par = {f: rel_err(getattr(got.cs, f)[0].double().cpu(), getattr(ref.cs, f)[0]) for f in params}
        e_next = {"dl": rel_err(got.dl.double().cpu(), ref.dl)}
        e_next.update({name: rel_err(g.double().cpu(), w) for name, g, w in zip(
            parts, shard_step.split_sums(got.sums, k, m, r), shard_step.split_sums(ref.sums, k, m, r))})
        same_lrs = torch.equal(got.cs.svec[0, :5].double().cpu(), ref.cs.svec[0, :5].to(torch.float32).double())
        print(f"[8a prologue] {cfg.name}: the update of step 0 and the partials of step 1 in one launch vs step_plain "
              f"in float64 from the kernel's state: metrics row 0 " + ", ".join(f"{key} {v:.2e}" for key, v in e_met.items())
              + f" (limit 2e-4; ortho plus {ORTHO_ATOL:.0e} absolute); params " + ", ".join(
                  f"{key} {v:.2e}" for key, v in e_par.items()) + " of max|param| (limit 1e-5); the next partials "
              + ", ".join(f"{key} {v:.2e}" for key, v in e_next.items())
              + f" (limits: dl {STEP_DL_RTOL:.0e}, the sums {STEP_RTOL:.0e}); LRs equal {same_lrs}; two launches "
              f"bit-identical {same}")
        check(met_ok and max(e_par.values()) <= 1e-5 and same and same_lrs and e_next["dl"] <= STEP_DL_RTOL
              and all(e_next[name] <= STEP_RTOL for name in parts),
              f"{cfg.name}: step kernel's prologue vs step_plain beyond its limits: metrics {e_met}, params {e_par}, "
              f"next partials {e_next}, LRs equal {same_lrs}, launches identical {same}")

    # 8b. the sharded chunk on a one-rank NCCL group against the mega-kernel
    mesh = parallel.make_mesh(1, device=dev)
    for cfg, make, param_limit in ((unit, start, 5e-4), (funit, fstart, 1e-2)):
        spec_s, st_s = make(cfg)
        chunk = shard_step.make_sharded_fused_chunk(spec_s, cfg, mesh)
        local = parallel.shard_batch(batch_of[cfg.name], mesh)
        s1, m1 = chunk(st_s, local, 1)
        k1, mk1 = train_chunk.fused_train_chunk(st_s, batch_of[cfg.name], 1, spec_s, cfg)
        e_one = {key: float(((m1[key] - mk1[key]).abs() / mk1[key].abs()).max()) for key in train_chunk.METRICS}
        one_ok = all(bool(((m1[key] - mk1[key]).abs() <= 2e-4 * mk1[key].abs()
                           + (ORTHO_ATOL if key == "ortho" else 0.0)).all()) for key in train_chunk.METRICS)
        e_one_params = max(rel_err(s1.params[key], k1.params[key]) for key in s1.params)
        s25, m25 = chunk(st_s, local, 25)
        k25, mk25 = train_chunk.fused_train_chunk(st_s, batch_of[cfg.name], 25, spec_s, cfg)
        e_trace = {key: trace_rel(m25, mk25, key, 25) for key in ("rec", "l1", "total")}
        e_params = max(rel_err(s25.params[key], k25.params[key]) for key in s25.params)
        print(f"[8b sharded] {cfg.name}, space=1 (NCCL), omega_init=1, against the mega-kernel: one epoch from one "
              f"state, metrics " + ", ".join(f"{key} {v:.2e}" for key, v in e_one.items())
              + f" (limit 2e-4; ortho plus {ORTHO_ATOL:.0e} absolute), params {e_one_params:.2e} of max|param| (limit "
              f"1e-5); 25 epochs, trace " + ", ".join(f"{key} {v:.2e}" for key, v in e_trace.items())
              + f" (limit 2e-4), params {e_params:.2e} (limit {param_limit:.0e})")
        check(one_ok and e_one_params <= 1e-5, f"{cfg.name}: sharded chunk, one epoch from one state: {e_one}, "
              f"params {e_one_params}")
        check(max(e_trace.values()) <= 2e-4 and e_params <= param_limit,
              f"{cfg.name}: sharded chunk over 25 epochs: {e_trace}, params {e_params}")

    # 8c. the slice over the mesh: runner.run through the sharded step kernel
    sharded_runs = {}
    for cfg, data, epochs in ((preset, x_np, SHARDED_EPOCHS), (fpreset, fx_np, SHARDED_FOURIER_EPOCHS)):
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches(*counters)
            t0 = time.perf_counter()
            art = runner.run(cfg, data, out_dir=tmp, num_epochs=epochs, echo=False, device=dev, device_mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = shard_step.step.launches
            chunks = -(-epochs // cfg.checkpoint_every)
            others = sum(fn.launches for fn in counters) - launches
            hist = art.history
            check(all(bool(np.isfinite(hist[key]).all()) and hist[key].shape == (epochs,) for key in hist),
                  f"sharded {cfg.name} history")
            check(hist["rec"][-1] < hist["rec"][0], f"sharded {cfg.name} rec did not fall: {hist['rec'][0]} -> "
                  f"{hist['rec'][-1]}")
            check(launches == epochs + chunks and others == 0,
                  f"sharded {cfg.name}: step kernel launched {launches} times in {epochs} epochs of {chunks} chunks "
                  f"(one more launch a chunk), other kernels {others}")
            files = set(os.listdir(art.out_dir))
            want = {f"{cfg.name}_r{cfg.r}_final.pt", "state_final.npz"} | {
                f"state_epoch{e}.npz" for e in range(cfg.checkpoint_every, epochs + 1, cfg.checkpoint_every)}
            check(want <= files, f"missing sharded exports in {sorted(files)}")
            check(art.state.params["phi"].shape == (cfg.r, cfg.n), "sharded export's phi is not whole")
            check(np.isfinite(art.relative_error) and len(art.sweep) == 14, f"sharded {cfg.name} error/sweep")
            sharded_runs[cfg.name] = dict(launches=launches, sps=art.steps_per_sec)
            print(f"[8c sharded] {cfg.name} n={art.config.n} m={art.config.m} as configured over space=1 (NCCL): "
                  f"{epochs} epochs in {wall:.1f} s (POD, sweep and exports included), {art.steps_per_sec:.1f} steps/s "
                  f"over chunks 2-{epochs // cfg.checkpoint_every}; rec {hist['rec'][0]:.6e} -> {hist['rec'][-1]:.6e}; "
                  f"relative error {art.relative_error:.6f}, POD(r) {art.pod_error_r:.6f}; sweep {len(art.sweep)} rows; "
                  f"step kernel launches {launches} = epochs + chunks ({epochs} + {chunks}), other kernels 0")

    # 8d. times at cylinder and fourier_cylinder as configured: the step
    # kernel (one launch: a step's update and partials) and its plain version
    # (step_plain) in turns, beside the bounds (fp32; 3xTF32 for the two
    # contractions with X); the kernel's clock by part over a 500-step chunk;
    # the sharded step over space=1 as the chunk (make_sharded_fused_chunk,
    # its set-up and capture included) in turns with the mega-kernel's epoch,
    # and, on buffers built beforehand, the loop of launch and all-reduce in
    # turns with the replays of a CUDA graph of one step
    step_times, sharded_steps = {}, {}
    timed_steps = 500
    for name, iters in ((preset.name, 200), (fpreset.name, 200)):
        n, m, k, r = step_checks[name]["shape"]
        cfg = preset if name == preset.name else fpreset
        spec_s, st_s = (start if name == preset.name else fstart)(cfg)
        nf = train_chunk.n_fourier(spec_s, cfg)
        local = parallel.shard_batch(batch_of[name], mesh)

        def buffers(steps):
            cs = train_chunk.pack_seeds(train_chunk.stack_seed(st_s), [cfg.beta], [cfg.l1_lambda])
            return shard_step.make_buffers(cs, local, steps, spec_s, cfg, n)

        kbuf = buffers(4 * iters + 8)
        pbuf = kbuf.clone()
        k1, p1, p2, k2 = (time_ms(f, iters) for f in (lambda: shard_step.step(kbuf, spec_s),
                                                       lambda: shard_step.step_plain(pbuf, spec_s),
                                                       lambda: shard_step.step_plain(pbuf, spec_s),
                                                       lambda: shard_step.step(kbuf, spec_s)))
        flops, nbytes = step_flops(n, m, k, nf), step_bytes(n, m, k, r, nf)
        bound, by = bound_ms(flops, nbytes)
        bound3 = bound_3xtf32_ms(contraction_flops(n, m, k), flops - contraction_flops(n, m, k), nbytes)
        launch_ms = (k1 + k2) / 2
        step_times[name] = dict(ms=launch_ms, plain_ms=(p1 + p2) / 2, bound_ms=bound, bound_by=by,
                                bound_3xtf32_ms=bound3)
        split = shard_step.phase_split(spec_s, cfg, mesh, st_s, local, timed_steps)
        per_launch = {key: v * 1e6 / (timed_steps + 1) for key, v in split.items()}
        flat = torch.zeros_like(kbuf.sums)
        ar_ms = time_ms(lambda: mesh.all_reduce(flat, "sum"), iters)
        lbuf, rbuf = buffers(8 * timed_steps + 8), buffers(8 * timed_steps + 8)

        def loop(steps=timed_steps, lbuf=lbuf, spec_s=spec_s):
            for _ in range(steps):
                shard_step.step(lbuf, spec_s)
                mesh.all_reduce(lbuf.sums, "sum")

        shard_step.step(rbuf, spec_s)
        mesh.all_reduce(rbuf.sums, "sum")
        graph = shard_step.capture(rbuf, spec_s, mesh)

        def replay(steps=timed_steps, graph=graph):
            for _ in range(steps):
                graph.replay()

        chunk = shard_step.make_sharded_fused_chunk(spec_s, cfg, mesh)
        whole = lambda: chunk(st_s, local, timed_steps)  # noqa: E731
        mega = lambda: train_chunk.fused_train_chunk(st_s, batch_of[name], timed_steps, spec_s, cfg)  # noqa: E731
        c1, g1, g2, c2 = (time_ms(f, 3) * 1e3 / timed_steps for f in (whole, mega, mega, whole))
        # the loop against the replays: 10 rounds of loop, replays, replays,
        # loop; a pair is a round's first or second half
        rounds = [[time_ms(f, 1) * 1e3 / timed_steps for f in (loop, replay, replay, loop)] for _ in range(10)]
        loops = [t for rd in rounds for t in (rd[0], rd[3])]
        replays = [t for rd in rounds for t in (rd[1], rd[2])]
        won = sum(r < u for r, u in zip(replays, loops))
        # the busy share: the kernel's own clock (each launch from its entry
        # to its end) over the wall time, both in one window of the loop and
        # one of the replays
        busy = {}
        for how, fn, b in (("the loop", loop, lbuf), ("the replays", replay, rbuf)):
            torch.cuda.synchronize()
            before = sum(shard_step.clock(b, spec_s).values())
            t0 = time.perf_counter()
            fn()
            kernel_s = sum(shard_step.clock(b, spec_s).values()) - before  # synchronizes
            busy[how] = (kernel_s * 1e6 / timed_steps, (time.perf_counter() - t0) * 1e6 / timed_steps)
        sharded_steps[name] = dict(chunk=chunk, state=st_s, local=local)
        contractions = per_launch["rows.xb"] + per_launch["ax"]
        print(f"[8d time] {card}: {name} (n, m, K)=({n}, {m}, {k}): step kernel {k1 * 1e3:.1f}/{k2 * 1e3:.1f} us per "
              f"launch (a step's update and partials), plain version (step_plain) {p1 * 1e3:.1f}/{p2 * 1e3:.1f} us "
              f"(kernel, plain, plain, kernel; {iters} calls each); bound {bound * 1e3:.1f} us ({by}, fp32, "
              f"{flops / 1e9:.3f} GFLOP), {bound3 * 1e3:.1f} us (3xTF32); the launch at {launch_ms / bound:.1f}x "
              f"and {launch_ms / bound3:.1f}x")
        print(f"[8d clock] {card}: {name} step kernel over a {timed_steps}-step chunk ({timed_steps + 1} launches; "
              f"kernel clock, block 0), us per launch: " + ", ".join(f"{key} {v:.1f}" for key, v in per_launch.items())
              + f"; X·Bᵀ + AᵀX (rows.xb + ax) {contractions:.1f} us")
        print(f"[8d step] {card}: {name} sharded step over space=1, us per step over {timed_steps}-step runs: the "
              f"chunk as train.fit calls it (set-up and capture included) {c1:.1f}/{c2:.1f} in turns with the "
              f"mega-kernel's epoch {g1:.1f}/{g2:.1f} (chunk, mega, mega, chunk; 3 runs each); on buffers built "
              f"beforehand, in 10 rounds of loop, replays, replays, loop (2 runs each): the loop of launch and "
              f"all-reduce median {statistics.median(loops):.1f} (" + "/".join(f"{t:.1f}" for t in loops)
              + f"), the replays of a CUDA graph of one step median {statistics.median(replays):.1f} ("
              + "/".join(f"{t:.1f}" for t in replays) + f"), the replays faster in {won} of {len(loops)} pairs; "
              f"alone: the kernel {launch_ms * 1e3:.1f}, the all-reduce {ar_ms * 1e3:.1f} (one rank: the host's "
              f"time); end to end {sharded_runs[name]['sps']:.1f} steps/s (8c) against the mega-kernel path's "
              f"{slice_sps if name == preset.name else fslice_sps:.1f}")
        print(f"[8d busy] {card}: {name} sharded step over {timed_steps} steps, the step kernel by its own clock "
              "against the wall time, us a step: " + ", ".join(
                  f"{how} {k_us:.1f} in {w_us:.1f}, a busy share of {k_us / w_us:.1%}" for how, (k_us, w_us)
                  in busy.items()))
    # 8f. the step kernel's packed form against its plain version at the
    # ensemble cells' full width, aneurysm S=4 (K'=108) and fourier_cylinder
    # S=8 (K'=96), omega_init=1, the seeds jittered as ensemble.fit jitters
    # them, each with its own beta, lambda and LR scale, from two states:
    # after PARITY_STEPS epochs of the packed mega-kernel (STEP_RTOL) and at
    # the reference init (STEP_INIT_RTOL). From each: the partials alone over
    # all rows and over 2 and 3 uneven shards (summed), against step_plain in
    # float64; from the kernel's state after that step, the update with the
    # next partials and the update alone (rows=0), against step_plain in
    # float64 on the same state and sums. Then a state with seed 1's phi NaN,
    # whose metrics go non-finite while every other seed's stay finite.
    def packed_rows_buffers(cfg, spec_s, batch, state, lo, hi, steps, betas=None, lams=None):
        """The packed step's buffers over rows [lo, hi) of the stacked
        ``state`` and ``batch``, as a rank holding those rows builds them."""
        cs = train_chunk.pack_seeds(state, *train_chunk.seed_hypers(cfg, state.params["phi"].shape[0], betas, lams))
        cs.phi = cs.phi[:, :, lo:hi].contiguous()
        local = {"x": batch["x"][lo:hi].contiguous(), "pod_modes": batch["pod_modes"][lo:hi].contiguous(),
                 "x_sq": batch["x_sq"]}
        return shard_step.make_buffers(cs, local, steps, spec_s, cfg, cfg.n)

    def check_packed_step(name, seeds, cfg, spec_s, pbatch, state, betas, lams, label, limits):
        """The agreement checks of one state, each summed partial to its
        limit in ``limits``, and the mega-kernel's first-epoch sums of that
        state (``train_chunk.epoch_sums``) to the same limits; returns max
        |kernel - float64| over the partials of all rows."""
        n, m, r = cfg.n, cfg.m, cfg.r
        k = spec_s.num_poly_terms + 3 * r
        whole = packed_rows_buffers(cfg, spec_s, pbatch, state, 0, n, 2, betas, lams)
        ref = whole.to(dev, torch.float64)
        shard_step.step_plain(ref, spec_s)  # the partials alone
        ref32 = whole.to(dev, torch.float32)
        shard_step.step_plain(ref32, spec_s)
        plain_err = {part: rel_err(g.double(), w) for part, g, w in zip(
            parts, shard_step.split_seed_sums(ref32.sums, k, m, r, seeds),
            shard_step.split_seed_sums(ref.sums, k, m, r, seeds))}
        worst, same_max = {}, True
        for d in (1, 2, 3):
            runs = [whole] if d == 1 else [packed_rows_buffers(cfg, spec_s, pbatch, state, lo, hi, 2, betas, lams)
                                           for lo, hi in (parallel.row_range(n, d, q) for q in range(d))]
            for run in runs:
                shard_step.step(run, spec_s)
            torch.cuda.synchronize()
            e = {"dl": rel_err(torch.cat([run.dl for run in runs]).double(), ref.dl)}
            e.update({part: rel_err(g.double(), w) for part, g, w in zip(
                parts, shard_step.split_seed_sums(sum(run.sums for run in runs), k, m, r, seeds),
                shard_step.split_seed_sums(ref.sums, k, m, r, seeds))})
            same_max &= max(float(run.max_arg[0]) for run in runs) == float(ref32.max_arg[0])
            worst = {key: max(v, worst.get(key, 0.0)) for key, v in e.items()}
        max_abs = max(float((whole.sums.double() - ref.sums).abs().max()), float((whole.dl.double() - ref.dl).abs().max()))
        check(worst["dl"] <= STEP_DL_RTOL and all(worst[part] <= limits[part] for part in parts) and same_max,
              f"{name} S={seeds} {label}: packed step kernel over 1-3 shards vs plain beyond its limits: {worst} "
              f"(limits {limits}), max_arg equal {same_max}")
        mega = train_chunk.epoch_sums(state, pbatch, spec_s, cfg, betas, lams)
        want = dict(zip(parts, shard_step.split_seed_sums(ref.sums, k, m, r, seeds)))
        e_mega = {part: rel_err(mega[part].double(), want[part]) for part in ("ga", "latg", "gcoef", "gomega")}
        same_bits = all(torch.equal(mega[part], g) for part, g in zip(
            ("gcoef", "gomega"), shard_step.split_seed_sums(whole.sums, k, m, r, seeds)[3:]))
        print(f"[8f mega-kernel] {name} {seeds} seed(s) {label}: the mega-kernel's first-epoch sums "
              "(train_chunk.epoch_sums) vs float64: " + ", ".join(f"{key} {v:.2e}" for key, v in e_mega.items())
              + f" of max|ref|; gcoef and gomega the step kernel's bits {same_bits}")
        check(all(v <= limits[part] for part, v in e_mega.items()),
              f"{name} S={seeds} {label}: the mega-kernel's sums vs float64 beyond their limits: {e_mega}")
        # the update of that step and the next partials, twice from the same buffers; the update alone
        ref = whole.to(dev, torch.float64)
        twice = [whole.clone(), whole.clone()]
        for run in twice:
            shard_step.step(run, spec_s)
        alone = whole.clone()
        shard_step.step(alone, spec_s, rows=False)
        torch.cuda.synchronize()
        shard_step.step_plain(ref, spec_s)
        ref_alone = whole.to(dev, torch.float64)
        shard_step.step_plain(ref_alone, spec_s, rows=False)
        got = twice[0]
        fields = ("sums", "dl", "gb", "met", "max_arg", "count")
        same = all(torch.equal(getattr(twice[0], f), getattr(twice[1], f)) for f in fields) and all(
            torch.equal(getattr(twice[0].cs, f), getattr(twice[1].cs, f)) for f in ("phi", "coef", "omega", "svec"))
        params = ("phi", "coef", "omega") + (("series", "periods") if got.nf else ("b",))
        met_err = (got.met[0].double() - ref.met[0]).abs() - 2e-4 * ref.met[0].abs()
        met_err[:, 1] -= ORTHO_ATOL
        e_met = {key: float(((got.met[0, :, i].double() - ref.met[0, :, i]).abs() / ref.met[0, :, i].abs()).max())
                 for i, key in enumerate(shard_step.ROW_METRICS)}
        e_par = {f: max(rel_err(getattr(run.cs, f)[0].double(), getattr(want.cs, f)[0]) for run, want in
                        ((got, ref), (alone, ref_alone))) for f in params}
        e_next = {"dl": rel_err(got.dl.double(), ref.dl)}
        e_next.update({part: rel_err(g.double(), w) for part, g, w in zip(
            parts, shard_step.split_seed_sums(got.sums, k, m, r, seeds),
            shard_step.split_seed_sums(ref.sums, k, m, r, seeds))})
        same_lrs = all(torch.equal(run.cs.svec[:, :5].double(), want.cs.svec[:, :5].float().double())
                       for run, want in ((got, ref), (alone, ref_alone)))
        alone_ok = torch.equal(alone.met[0], got.met[0]) and int(alone.count) == 1
        print(f"[8f packed step] {name} {seeds} seeds (n, m, K')=({n}, {m}, {seeds * k}) {label}, omega_init=1, "
              f"per-seed beta, lambda and LR scale: the partials over all rows and over 2 and 3 uneven shards "
              f"(summed) vs the plain version in float64, worst of the three: "
              + ", ".join(f"{key} {v:.2e}" for key, v in worst.items())
              + f" of max|ref| (limits: dl {STEP_DL_RTOL:.0e}, " + ", ".join(f"{part} {v:.0e}" for part, v in
                                                                    limits.items()) + "); the plain version in float32 vs "
              "float64: " + ", ".join(f"{key} {v:.2e}" for key, v in plain_err.items())
              + f"; max_arg equal to the float32 plain's {same_max}; the update and the next partials vs step_plain "
              "in float64: metrics rows 0 " + ", ".join(f"{key} {v:.2e}" for key, v in e_met.items())
              + f" (limit 2e-4; ortho plus {ORTHO_ATOL:.0e} absolute); params (with the update alone) "
              + ", ".join(f"{key} {v:.2e}" for key, v in e_par.items()) + " of max|param| (limit 1e-5); the next "
              "partials " + ", ".join(f"{key} {v:.2e}" for key, v in e_next.items())
              + f"; LRs equal {same_lrs}; the update alone writes the same metrics rows {alone_ok}; two launches "
              f"bit-identical {same}")
        check(bool((met_err <= 0).all()) and max(e_par.values()) <= 1e-5 and same and same_lrs and alone_ok
              and e_next["dl"] <= STEP_DL_RTOL and all(e_next[part] <= limits[part] for part in parts),
              f"{name} S={seeds} {label}: packed step kernel's update vs step_plain beyond its limits: metrics "
              f"{e_met}, params {e_par}, next partials {e_next}, LRs equal {same_lrs}, the update alone {alone_ok}, "
              f"launches identical {same}")
        return max_abs

    packed_steps = {}
    init_limits = {**dict.fromkeys(parts, STEP_RTOL), "ax": STEP_INIT_RTOL}
    for name, pc_tag, preset_cfg, seeds in (("aneurysm", "5e", apreset, 4), ("fourier_cylinder", "5ef", fpreset, 8)):
        pc = packed_checks[pc_tag]
        cfg = dataclasses.replace(preset_cfg, omega_init=1.0, lr_omega=1.0)
        spec_s, pbatch = pc["make_spec"](cfg), pc["batch"]
        n, r = cfg.n, cfg.r
        k = spec_s.num_poly_terms + 3 * r
        betas = np.geomspace(cfg.beta, 10.0 * cfg.beta, seeds).astype(np.float32)
        lams = np.geomspace(cfg.l1_lambda, 10.0 * cfg.l1_lambda, seeds).astype(np.float32)
        hst = ensemble.init_state(pc["start"](cfg, spec_s, seeds).params, cfg, seeds,
                                  lr_scales=np.where(np.arange(seeds) % 2, 0.5, 1.0))
        trained = train_chunk.fused_ensemble_chunk(hst, pbatch, PARITY_STEPS, spec_s, cfg, betas, lams)[0]
        max_abs = check_packed_step(name, seeds, cfg, spec_s, pbatch, trained, betas, lams,
                                    f"after {PARITY_STEPS} epochs", dict.fromkeys(parts, STEP_RTOL))
        check_packed_step(name, seeds, cfg, spec_s, pbatch, hst, betas, lams, "at the reference init", init_limits)
        if name == "aneurysm":  # one seed from the reference init, the one-seed forms of both kernels
            one = train_chunk.stack_seed(train.init_state(desmo.Desmo(spec_s, device=dev).params(), cfg))
            check_packed_step(name, 1, cfg, spec_s, pbatch, one, None, None, "at the reference init", init_limits)
        bad = ensemble.init_state({**hst.params, "phi": hst.params["phi"].clone()}, cfg, seeds)
        bad.params["phi"][1] = float("nan")
        bbuf = packed_rows_buffers(cfg, spec_s, pbatch, bad, 0, n, 3)
        for _ in range(3):
            shard_step.step(bbuf, spec_s)
        torch.cuda.synchronize()
        others = [q for q in range(seeds) if q != 1]
        isolated = (not bool(torch.isfinite(bbuf.met[:2, 1][:, [0, 1, 3]]).any())
                    and bool(torch.isfinite(bbuf.met[:2, others]).all())
                    and all(bool(torch.isfinite(shard_step.packed_seed(bbuf.cs, q, r, k).phi).all()) for q in others))
        print(f"[8f packed step] {name}: seed 1's phi NaN: its rec, ortho and total non-finite over two updates, "
              f"every other seed's metrics and state finite {isolated}")
        check(isolated, f"{name} S={seeds}: a NaN seed reached another seed in the packed step kernel")
        packed_steps[name] = dict(cfg=cfg, spec=spec_s, batch=pbatch, state=hst, betas=betas, lams=lams, seeds=seeds,
                                  max_abs=max_abs, shape=(n, cfg.m, k, r), preset=preset_cfg, pc=pc)

    # 8g. the sharded packed chunk on one rank against the packed mega-kernel
    # (fused_ensemble_chunk) from the same state, over 1 and 25 epochs
    for name, ps in packed_steps.items():
        cfg, spec_s, pbatch, hst = ps["cfg"], ps["spec"], ps["batch"], ps["state"]
        chunk = shard_step.make_sharded_fused_ensemble_chunk(spec_s, cfg, mesh, ps["seeds"], ps["betas"], ps["lams"])
        local = parallel.shard_batch(pbatch, mesh)
        report = []
        for steps in (1, 25):
            s1, m1 = chunk(hst, local, steps)
            k1, mk1 = train_chunk.fused_ensemble_chunk(hst, pbatch, steps, spec_s, cfg, ps["betas"], ps["lams"])
            torch.cuda.synchronize()
            bits = all(torch.equal(m1[key], mk1[key]) for key in mk1) and all(
                torch.equal(s1.params[key], k1.params[key]) for key in k1.params) and torch.equal(
                s1.sched.lrs, k1.sched.lrs)
            if not bits:
                e = {key: float(((m1[key] - mk1[key]).abs() / mk1[key].abs()).max()) for key in ("rec", "total_s")}
                e["params"] = max(rel_err(s1.params[key], k1.params[key]) for key in k1.params)
                report.append(f"{steps} epoch(s): not bit for bit, " + ", ".join(f"{key} {v:.2e}" for key, v in e.items()))
                check(steps > 1 or (max(e["rec"], e["total_s"]) <= 2e-4 and e["params"] <= 1e-5),
                      f"{name}: sharded packed chunk, one epoch from one state: {e}")
            else:
                report.append(f"{steps} epoch(s): bit for bit (metrics, params, LRs)")
        print(f"[8g sharded packed] {name} {ps['seeds']} seeds, space=1 (NCCL), omega_init=1, against the packed "
              f"mega-kernel: " + "; ".join(report))

    # 8h. the slice over the mesh with packed seeds: runner.run of aneurysm
    # with 4 seeds and fourier_cylinder with 8, as configured, through
    # ensemble.fit and the sharded packed chunk
    packed_runs = {}
    for name, preset_cfg, data, seeds in (("aneurysm", apreset, ax_np, 4), ("fourier_cylinder", fpreset, fx_np, 8)):
        cfg = dataclasses.replace(preset_cfg, n_seeds=seeds)
        epochs = PACKED_SHARDED_EPOCHS
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches(*counters)
            t0 = time.perf_counter()
            art = runner.run(cfg, data, out_dir=tmp, num_epochs=epochs, echo=False, device=dev, device_mesh=mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = shard_step.step.launches
            chunks = -(-epochs // cfg.checkpoint_every)
            others = sum(fn.launches for fn in counters) - launches
            hist = art.history
            check(all(bool(np.isfinite(hist[key]).all()) and hist[key].shape == (epochs,) for key in hist),
                  f"sharded packed {name} history")
            check(hist["rec"][-1] < hist["rec"][0], f"sharded packed {name} rec did not fall")
            check(launches == epochs + chunks and others == 0,
                  f"sharded packed {name}: step kernel launched {launches} times in {epochs} epochs of {chunks} "
                  f"chunks, other kernels {others}")
            files = set(os.listdir(art.out_dir))
            check({"ensemble.json", "term_stability.json", "state_final.npz", f"{cfg.name}_r{cfg.r}_final.pt"} <= files,
                  f"sharded packed {name}: missing records in {sorted(files)}")
            with open(os.path.join(art.out_dir, "ensemble.json")) as fh:
                record = json.load(fh)
            finals = record["final_totals"]
            check(len(finals) == seeds and record["diverged_seeds"] == [] and record["best_seed"] == int(np.argmin(finals)),
                  f"sharded packed {name}: ensemble.json {record}")
            check(art.state.params["phi"].shape == (cfg.r, cfg.n) and np.isfinite(art.relative_error)
                  and len(art.sweep) == 14, f"sharded packed {name}: export, error or sweep")
            packed_runs[name] = dict(launches=launches, sps=record["seed_steps_per_sec"])
            print(f"[8h sharded packed] {name} n={art.config.n} m={art.config.m} with {seeds} seeds as configured over "
                  f"space=1 (NCCL): {epochs} epochs in {wall:.1f} s (POD, sweep and exports included), "
                  f"{record['seed_steps_per_sec']:.1f} seed-steps/s over chunks 2-{chunks}; best seed "
                  f"{record['best_seed']}, its relative error {art.relative_error:.6f} (POD(r) {art.pod_error_r:.6f}), "
                  f"rec {hist['rec'][0]:.6e} -> {hist['rec'][-1]:.6e}; step kernel launches {launches} = epochs + "
                  f"chunks ({epochs} + {chunks}), other kernels 0")

    # 8i. times of the packed step as configured: a launch by CUDA events in
    # turns with its plain version on built buffers, beside its bounds (fp32;
    # 3xTF32 for the two contractions with X); the kernel's clock by part over
    # a 500-step chunk; the chunk in turns with the packed mega-kernel's
    # epoch; the busy share over a graph's replays by the kernel's clock
    packed_step_times = {}
    for name, ps in packed_steps.items():
        cfg, seeds = ps["preset"], ps["seeds"]
        spec_s = ps["pc"]["make_spec"](cfg)
        st = ps["pc"]["start"](cfg, spec_s, seeds)
        n, m, k, r = ps["shape"]
        nf = train_chunk.n_fourier(spec_s, cfg)
        local = parallel.shard_batch(ps["batch"], mesh)
        iters = 50
        kbuf = packed_rows_buffers(cfg, spec_s, ps["batch"], st, 0, n, 4 * iters + 8)
        pbuf = kbuf.clone()
        k1, p1, p2, k2 = (time_ms(f, iters) for f in (lambda: shard_step.step(kbuf, spec_s),
                                                       lambda: shard_step.step_plain(pbuf, spec_s),
                                                       lambda: shard_step.step_plain(pbuf, spec_s),
                                                       lambda: shard_step.step(kbuf, spec_s)))
        flops, nbytes = step_flops(n, m, k, nf, seeds), step_bytes(n, m, k, r, nf, seeds)
        bound, by = bound_ms(flops, nbytes)
        cflops = contraction_flops(n, m, k, seeds)
        bound3 = bound_3xtf32_ms(cflops, flops - cflops, nbytes)
        launch_ms = (k1 + k2) / 2
        packed_step_times[name] = dict(ms=launch_ms, plain_ms=(p1 + p2) / 2, bound_ms=bound, bound_by=by,
                                  bound_3xtf32_ms=bound3)
        split = shard_step.phase_split(spec_s, cfg, mesh, st, local, timed_steps)
        per_launch = {key: v * 1e6 / (timed_steps + 1) for key, v in split.items()}
        chunk = shard_step.make_sharded_fused_ensemble_chunk(spec_s, cfg, mesh, seeds)
        whole_chunk = lambda: chunk(st, local, timed_steps)  # noqa: E731
        mega = lambda: train_chunk.fused_ensemble_chunk(st, ps["batch"], timed_steps, spec_s, cfg)  # noqa: E731
        c1, g1, g2, c2 = (time_ms(f, 2) * 1e3 / timed_steps for f in (whole_chunk, mega, mega, whole_chunk))
        rbuf = packed_rows_buffers(cfg, spec_s, ps["batch"], st, 0, n, 2 * timed_steps + 8)
        shard_step.step(rbuf, spec_s)
        mesh.all_reduce(rbuf.sums, "sum")
        graph = shard_step.capture(rbuf, spec_s, mesh)
        torch.cuda.synchronize()
        before = sum(shard_step.clock(rbuf, spec_s).values())
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            graph.replay()
        kernel_s = sum(shard_step.clock(rbuf, spec_s).values()) - before  # synchronizes
        busy_k, busy_w = kernel_s * 1e6 / timed_steps, (time.perf_counter() - t0) * 1e6 / timed_steps
        contractions = per_launch["rows.xb"] + per_launch["ax"]
        print(f"[8i time] {card}: {name} {seeds} seeds (n, m, K')=({n}, {m}, {seeds * k}) as configured: packed step "
              f"kernel {k1 * 1e3:.1f}/{k2 * 1e3:.1f} us per launch (a step's update and partials), plain version "
              f"(step_plain) {p1 * 1e3:.1f}/{p2 * 1e3:.1f} us (kernel, plain, plain, kernel; {iters} calls each); "
              f"bound {bound * 1e3:.1f} us ({by}, fp32, {flops / 1e9:.3f} GFLOP, of which the contractions "
              f"{cflops / 1e9:.3f}), {bound3 * 1e3:.1f} us (3xTF32); the launch at {launch_ms / bound:.1f}x and "
              f"{launch_ms / bound3:.1f}x")
        print(f"[8i clock] {card}: {name} packed step kernel over a {timed_steps}-step chunk ({timed_steps + 1} "
              f"launches; kernel clock, block 0), us per launch: " + ", ".join(f"{key} {v:.1f}" for key, v in
                                                                             per_launch.items())
              + f"; the launch by the clock {sum(per_launch.values()):.1f}; X·Bᵀ + AᵀX (rows.xb + ax) "
              f"{contractions:.1f} us")
        print(f"[8i step] {card}: {name} sharded packed step over space=1, us per step over {timed_steps}-step runs: "
              f"the chunk as ensemble.fit calls it (set-up and capture included) {c1:.1f}/{c2:.1f} in turns with the "
              f"packed mega-kernel's epoch {g1:.1f}/{g2:.1f} (chunk, mega, mega, chunk; 2 runs each); the replays of "
              f"a CUDA graph of one step: the kernel by its clock {busy_k:.1f} in {busy_w:.1f}, a busy share of "
              f"{busy_k / busy_w:.1%}; end to end {packed_runs[name]['sps']:.1f} seed-steps/s (8h)")

    # 10. resume, bit for bit: each run as configured for RESUME_EPOCHS
    # (two 2,000-epoch chunks) straight, against one chunk and then
    # runner.run(resume_from=its state_epoch2000.npz) for the other; the
    # final state files and the resumed run's metrics equal. Cylinder through
    # the mega-kernel, over space=1 through the step kernel (the resumed
    # chunk builds its buffers and captures its CUDA graph anew), and
    # ae_cylinder through the AE kernel.
    def resume_check(tag, cfg, data, counter, **kw):
        half = RESUME_EPOCHS // 2
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches(*counters)
            t0 = time.perf_counter()
            straight = runner.run(cfg, data, out_dir=os.path.join(tmp, "straight"), num_epochs=RESUME_EPOCHS,
                                  echo=False, device=dev, **kw)
            first = runner.run(cfg, data, out_dir=os.path.join(tmp, "first"), num_epochs=half, echo=False,
                               device=dev, **kw)
            resumed = runner.run(cfg, data, out_dir=os.path.join(tmp, "resumed"), num_epochs=RESUME_EPOCHS - half,
                                 echo=False, device=dev, resume_from=os.path.join(first.out_dir,
                                                                                  f"state_epoch{half}.npz"), **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, others = counter.launches, sum(fn.launches for fn in counters) - counter.launches
            want = dict(np.load(os.path.join(straight.out_dir, "state_final.npz")))
            got = dict(np.load(os.path.join(resumed.out_dir, "state_final.npz")))
        same_state = set(got) == set(want) and all(np.array_equal(got[key], want[key]) for key in want)
        same_metrics = all(np.array_equal(resumed.history[key], straight.history[key][half:]) for key in
                           straight.history)
        expected = 2 * (RESUME_EPOCHS + 2) if counter is shard_step.step else 4
        print(f"[10 resume] {tag}: {RESUME_EPOCHS} epochs straight against {half} and then resume_from "
              f"state_epoch{half}.npz for {RESUME_EPOCHS - half} ({wall:.1f} s for the three runs): final state "
              f"files equal bit for bit {same_state}, the resumed run's metrics equal epochs {half}-"
              f"{RESUME_EPOCHS - 1} of the straight run's {same_metrics}; relative error {resumed.relative_error:.6f} "
              f"and {straight.relative_error:.6f}; {counter.__name__} launches {launches} (expected {expected}), "
              f"other kernels {others}")
        check(same_state and same_metrics and resumed.relative_error == straight.relative_error,
              f"{tag}: the resumed run differs from the straight one")
        check(launches == expected and others == 0, f"{tag}: {launches} launches of {counter.__name__}, "
              f"{others} of other kernels, in the three runs")
        return dict(launches=launches, state=want)

    resumes = {
        "cylinder": resume_check("cylinder as configured (the mega-kernel)", preset, x_np,
                                 train_chunk.fused_train_chunk),
        "cylinder over space=1": resume_check("cylinder as configured over space=1 (the step kernel)", preset,
                                              x_np, shard_step.step, device_mesh=mesh),
        "ae_cylinder": resume_check("ae_cylinder with chunk_method=megakernel (the AE kernel)", ae_slice_cfg,
                                    aex_np, ae_chunk.fused_ae_chunk),
    }

    # 10p. preemption: cylinder as configured for RESUME_EPOCHS, with the
    # SIGTERM handler installed and a timer that sends SIGTERM 50 ms after
    # the first chunk is launched: the run stops at the next chunk boundary,
    # with preempted=True and state_final.npz; resumed from that file to the
    # end, it ends on the bits of the straight run of phase 10
    prev_handler = signal.getsignal(signal.SIGTERM)
    select = train_chunk.select_chunk

    def signalled_select(spec, cfg, device):
        chunk = select(spec, cfg, device)
        calls = []

        def run_chunk(state, batch_, num_steps):
            calls.append(num_steps)
            out = chunk(state, batch_, num_steps)
            if len(calls) == 1:
                timers.append(threading.Timer(0.05, os.kill, (os.getpid(), signal.SIGTERM)))
                timers[-1].start()
            return out

        return run_chunk

    timers = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            train.install_preemption_handler()
            train_chunk.select_chunk = signalled_select
            reset_launches(*counters)
            stopped = runner.run(preset, x_np, out_dir=os.path.join(tmp, "stopped"), num_epochs=RESUME_EPOCHS,
                                 echo=False, device=dev)
        finally:
            train_chunk.select_chunk = select
            for timer in timers:
                timer.join()
            signal.signal(signal.SIGTERM, prev_handler)
        stop_launches = train_chunk.fused_train_chunk.launches
        files = set(os.listdir(stopped.out_dir))
        rest = RESUME_EPOCHS - stopped.state.epoch
        resumed = runner.run(preset, x_np, out_dir=os.path.join(tmp, "resumed"), num_epochs=rest, echo=False,
                             device=dev, resume_from=os.path.join(stopped.out_dir, "state_final.npz"))
        torch.cuda.synchronize()
        got = dict(np.load(os.path.join(resumed.out_dir, "state_final.npz")))
    want = resumes["cylinder"]["state"]
    same = set(got) == set(want) and all(np.array_equal(got[key], want[key]) for key in want)
    print(f"[10p preempt] cylinder as configured, {RESUME_EPOCHS} epochs, SIGTERM 50 ms after the first launch: "
          f"preempted {stopped.preempted} at epoch {stopped.state.epoch} after {stop_launches} launch(es); "
          f"state_final.npz written {'state_final.npz' in files}, the sweep skipped {stopped.sweep == []}; resumed "
          f"for {rest} epochs: the final state equals the straight run's bit for bit {same}")
    check(stopped.preempted and 0 < stopped.state.epoch < RESUME_EPOCHS
          and stopped.state.epoch % preset.checkpoint_every == 0 and "state_final.npz" in files
          and stopped.sweep == [] and not train.preemption_requested(),
          f"the SIGTERM did not stop the run at a chunk boundary: preempted {stopped.preempted} at "
          f"{stopped.state.epoch}, files {sorted(files)}")
    check(same, "the run resumed after a SIGTERM differs from the straight run")

    # 10c. a chunk boundary's host cost: train.fit of cylinder as configured,
    # SLICE_EPOCHS epochs through the mega-kernel with a checkpoint every
    # 2,000 (the runner's state_*.npz and .pt), written by fit's worker
    # thread (async), or on the loop's thread before each next launch and
    # after the last chunk (sync: a chunk that writes the state it is handed
    # first), against no checkpoint, in turns; the cost a boundary is the
    # wall time over the run without checkpoints, over the SLICE_EPOCHS /
    # 2,000 boundaries
    cspec, cst = start(preset)
    cchunk = train_chunk.select_chunk(cspec, preset, dev)
    boundaries = SLICE_EPOCHS // preset.checkpoint_every
    with tempfile.TemporaryDirectory() as tmp:
        def export(state, epoch):
            checkpoint.save_state(os.path.join(tmp, f"state_epoch{epoch}.npz"), state)
            checkpoint.save_pt(os.path.join(tmp, f"cylinder_r4_epoch{epoch}.pt"),
                               checkpoint.state_dict_from_params(state.params))

        def writing_chunk(state, batch_, num_steps):
            if state.epoch > cst.epoch:
                export(state, state.epoch)
            return cchunk(state, batch_, num_steps)

        def fit_wall(mode):
            t0 = time.perf_counter()
            res = train.fit(None, {}, preset, None, batch, num_epochs=SLICE_EPOCHS, log=None, state=cst,
                            chunk=writing_chunk if mode == "sync" else cchunk,
                            checkpoint_fn=export if mode == "async" else None)
            if mode == "sync":
                export(res.state, res.state.epoch)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        fit_wall("none")
        walls = {}
        for mode in ("none", "sync", "async", "async", "sync", "none"):
            walls.setdefault(mode, []).append(fit_wall(mode))
    base = statistics.mean(walls["none"])
    per_boundary = {mode: (statistics.mean(w) - base) / boundaries for mode, w in walls.items() if mode != "none"}
    print(f"[10c checkpoint] {card}: cylinder, {SLICE_EPOCHS} epochs of 2,000-epoch mega-kernel chunks, wall "
          "seconds (none, sync, async, async, sync, none): " + ", ".join(
              f"{mode} " + "/".join(f"{w:.4f}" for w in ws) for mode, ws in walls.items())
          + f"; host seconds a chunk boundary over the run without checkpoints: synchronous write "
          f"{per_boundary['sync']:.4f}, on the worker {per_boundary['async']:.4f}")

    # 11. the large presets as configured, one seed, through the mega-kernel,
    # SLICE_EPOCHS each: channel (n=16384, m=1000, r=4, P=2, K=27; then its
    # greedy curve), aneurysm (n=27000, K=27) and fourier_aneurysm (n=27000,
    # r=2, nF=30, K=12). Then, at each, the kernel against its plain chunk:
    # one epoch from the kernel's state after PARITY_STEPS epochs at
    # omega_init=1 (metrics to 2e-4, parameters to 1e-5), and both in turns
    # over TIMED_STEPS-epoch chunks beside the bounds
    large = {}
    for name in ("channel", "aneurysm", "fourier_aneurysm"):
        cfg = configs.get(name)
        data = ax_np if name == "aneurysm" else runner.load_data(cfg, synthetic=True)[0]
        cfg = dataclasses.replace(cfg, n=data.shape[0], m=data.shape[1])
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches(*counters)
            t0 = time.perf_counter()
            art = runner.run(cfg, data, out_dir=tmp, num_epochs=SLICE_EPOCHS, echo=False, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = train_chunk.fused_train_chunk.launches
        others = sum(fn.launches for fn in counters) - launches
        hist = art.history
        n_chunks = SLICE_EPOCHS // cfg.checkpoint_every
        check(all(bool(np.isfinite(hist[key]).all()) and hist[key].shape == (SLICE_EPOCHS,) for key in hist),
              f"{name} history")
        check(hist["rec"][-1] < hist["rec"][0], f"{name} rec did not fall: {hist['rec'][0]} -> {hist['rec'][-1]}")
        check(launches == n_chunks and others == 0,
              f"{name}: the mega-kernel launched {launches} times for {n_chunks} chunks, other kernels {others}")
        check(np.isfinite(art.relative_error) and len(art.sweep) == 14, f"{name}: error/sweep")
        nf = cfg.n_fourier if cfg.variant == "fourier" else 0
        spec_l = (fourier.FourierSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init, nf, cfg.period_init)
                  if nf else desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init))
        k = spec_l.num_poly_terms + 3 * cfg.r
        if cfg.run_greedy_prune:
            steps = [e.nonzero_terms for e in art.greedy]
            check(len(steps) == k + 1 and steps[0] <= k and steps[-1] == 0 and steps == sorted(steps, reverse=True)
                  and all(np.isfinite(e.error) for e in art.greedy) and abs(art.greedy[-1].error - 1.0) < 1e-4,
                  f"{name}: greedy curve {art.greedy}")
            print(f"[11 greedy] {name}: greedy pruning, {len(art.greedy)} steps (terms left: error): "
                  + ", ".join(f"{e.nonzero_terms}: {e.error:.6f}" for e in art.greedy))
        lbatch = runner.prepare_batch(data, pod.pod_host(data, cfg.r, dev).modes, dev)
        model = fourier.Fourier if nf else desmo.Desmo
        lunit = dataclasses.replace(cfg, omega_init=1.0, lr_omega=1.0)
        spec_u = dataclasses.replace(spec_l, omega_init=1.0)
        ust = train.init_state(model(spec_u, device=dev).params(), lunit)
        sk, _ = train_chunk.fused_train_chunk(ust, lbatch, PARITY_STEPS, spec_u, lunit)
        sk1, mk1 = train_chunk.fused_train_chunk(sk, lbatch, 1, spec_u, lunit)
        sp1, mp1 = train_chunk.train_chunk_plain(sk, lbatch, 1, spec_u, lunit)
        e_one = {key: ((mk1[key] - mp1[key]).abs() / mp1[key].abs()).item() for key in train_chunk.METRICS}
        one_ok = all(bool((mk1[key] - mp1[key]).abs() <= 2e-4 * mp1[key].abs() + (ORTHO_ATOL if key == "ortho"
                                                                                  else 0.0))
                     for key in train_chunk.METRICS)
        e_params = {key: rel_err(sk1.params[key], sp1.params[key]) for key in sk1.params}
        max_abs = max(float((sk1.params[key] - sp1.params[key]).abs().max()) for key in sk1.params)
        check(one_ok and max(e_params.values()) <= 1e-5,
              f"{name}: one epoch of the mega-kernel vs plain beyond 2e-4 / 1e-5: {e_one}, {e_params}")
        lst = train.init_state(model(spec_l, device=dev).params(), cfg)
        kernel = lambda: train_chunk.fused_train_chunk(lst, lbatch, TIMED_STEPS, spec_l, cfg)  # noqa: E731
        plain = lambda: train_chunk.train_chunk_plain(lst, lbatch, TIMED_STEPS, spec_l, cfg)  # noqa: E731
        k1, p1, p2, k2 = (time_ms(f, 3) for f in (kernel, plain, plain, kernel))
        n, m, r = cfg.n, cfg.m, cfg.r
        width = 2 * nf + 1 if nf else m
        state_bytes = 4 * 2 * (3 * r * n + 3 * k * width + (3 * k if nf else 0) + 3 * k + 9 * r + train_chunk.SVEC)
        nbytes = 4 * (n * m + n * r + (m if nf else 0) + TIMED_STEPS * len(train_chunk.METRICS)) + state_bytes
        flops = TIMED_STEPS * chunk_flops(n, m, k, nf)
        bound, by = bound_ms(flops, nbytes)
        cflops = TIMED_STEPS * contraction_flops(n, m, k)
        bound3 = bound_3xtf32_ms(cflops, flops - cflops, nbytes)
        per_epoch = 1e3 / TIMED_STEPS
        large[name] = dict(launches=launches, max_abs=max_abs, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                           bound_ms=bound, bound_by=by, bound_3xtf32_ms=bound3)
        print(f"[11 large] {card}: {name} as configured (n, m, r, P, K{', nF' if nf else ''})=({n}, {m}, {r}, "
              f"{cfg.poly_order}, {k}{f', {nf}' if nf else ''}): {SLICE_EPOCHS} epochs in {wall:.1f} s (POD, sweep"
              f"{', greedy pruning' if cfg.run_greedy_prune else ''} and exports included), {art.steps_per_sec:.1f} "
              f"steps/s over chunks 2-{n_chunks} ({1e6 / art.steps_per_sec:.1f} us an epoch); relative error "
              f"{art.relative_error:.6f} (POD(r) {art.pod_error_r:.6f}); rec {hist['rec'][0]:.6e} -> "
              f"{hist['rec'][-1]:.6e}; mega-kernel launches {launches} = chunks, other kernels 0")
        print(f"[11 large] {card}: {name} over {TIMED_STEPS}-epoch chunks in turns: kernel {k1 * per_epoch:.1f}/"
              f"{k2 * per_epoch:.1f} us/epoch, plain chunk {p1 * per_epoch:.1f}/{p2 * per_epoch:.1f} us/epoch; "
              f"bound {bound * per_epoch:.1f} us/epoch ({by}, fp32), {bound3 * per_epoch:.1f} (3xTF32); one epoch "
              f"from the kernel's state after {PARITY_STEPS} at omega_init=1, kernel vs plain: metrics "
              + ", ".join(f"{key} {v:.2e}" for key, v in e_one.items()) + "; params "
              + ", ".join(f"{key} {v:.2e}" for key, v in e_params.items()) + " of max|param|")

    # 12. the Fourier run's extras at fourier_cylinder's full width (n=3961,
    # m=1001): runner.run with a 0.2 holdout (the fit at m=801) and the
    # period multi-start (4 candidates of period_probe_epochs=300, one launch
    # a probe), SLICE_EPOCHS epochs through the mega-kernel's Fourier form,
    # the same run without the multi-start, and one started at the
    # spectrum's first candidate period (reported); the evaluate subcommand on
    # the final .pt with --forecast-after 801 against the run's
    # forecast.json. Then the mega-kernel at m=801 against its plain chunk:
    # the probes at omega_init=1 and lr_omega=1 (as 5f: the same candidates,
    # each probe's rec within 5f's 2e-4, the same pick or a near-tie
    # printed), 200 epochs and one epoch from one state (5f's limits), both
    # in turns over TIMED_STEPS-epoch chunks beside the bounds; the probes
    # at the preset's omega_init=1e4 are printed, not held (5f holds the
    # preset's first 3 epochs only: two roundings part after a few)
    from desmo_tpu_torch.__main__ import main as cli_main

    m_train = int(round(fpreset.m * 0.8))
    probe_line = re.compile(r"candidate (\S+) -> rec (\S+)")
    keep_line = re.compile(r"keeping period (\S+) \(rec (\S+)\)")

    def probe_recs(lines):
        """[(candidate, rec)] and the kept candidate of a multi-start's log."""
        recs = [(float(c), float(r)) for c, r in (probe_line.search(ln).groups() for ln in lines
                                                  if probe_line.search(ln))]
        kept = keep_line.search(lines[-1])
        return recs, (float(kept.group(1)) if kept else None)

    multistart = runner.fourier_period_multistart
    probe_runs = []

    def timed_multistart(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lines = []
        out = multistart(*args, **{**kw, "log": lines.append})
        torch.cuda.synchronize()
        probe_runs.append((time.perf_counter() - t0, lines))
        return out

    xtr, _ = runner.split_holdout(fx_np, m_train)
    fft_period = fourier.period_candidates(xtr, fpreset.period_init, n_candidates=4,
                                           pod_modes=pod.pod_host(xtr, fpreset.r, "cpu").modes.numpy())[1]
    holdout_runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, cfg in (("multistart", dataclasses.replace(fpreset, period_multistart=4)), ("single", fpreset),
                         ("fft period", dataclasses.replace(fpreset, period_init=fft_period))):
            reset_launches(*counters)
            probe_runs.clear()
            runner.fourier_period_multistart = timed_multistart
            try:
                t0 = time.perf_counter()
                art = runner.run(cfg, fx_np, out_dir=os.path.join(tmp, tag), num_epochs=SLICE_EPOCHS, echo=False,
                                 device=dev, holdout=0.2)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                runner.fourier_period_multistart = multistart
            launches = train_chunk.fused_train_chunk.launches
            others = sum(fn.launches for fn in counters) - launches
            probe_s, lines = probe_runs[0] if probe_runs else (0.0, [])
            recs, kept = probe_recs(lines) if lines else ([], None)
            n_chunks = SLICE_EPOCHS // cfg.checkpoint_every
            hist = art.history
            with open(os.path.join(art.out_dir, "forecast.json")) as fh:
                record = json.load(fh)
            check(all(bool(np.isfinite(hist[k]).all()) and hist[k].shape == (SLICE_EPOCHS,) for k in hist),
                  f"12 {tag}: history")
            check(launches == len(recs) + n_chunks and others == 0,
                  f"12 {tag}: {launches} mega-kernel launches for {len(recs)} probes and {n_chunks} chunks, other "
                  f"kernels {others}")
            check(art.state.epoch == SLICE_EPOCHS + (cfg.period_probe_epochs if recs else 0),
                  f"12 {tag}: the fit ended at epoch {art.state.epoch}")
            check(record == art.forecast and record["m_train"] == m_train
                  and record["m_holdout"] == fpreset.m - m_train and np.isfinite(record["holdout_error"])
                  and record["train_error"] == art.relative_error and len(art.sweep) == 14,
                  f"12 {tag}: the forecast record {dict((k, v) for k, v in record.items() if 'per' not in k)}")
            holdout_runs[tag] = dict(art=art, launches=launches, wall=wall, probe_s=probe_s, recs=recs, kept=kept)
            if tag == "multistart":
                check(len(recs) >= 2 and kept in [c for c, _ in recs], f"12: the multi-start probed {recs}")
                pt = os.path.join(art.out_dir, "fourier_cylinder_r2_final.pt")
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = cli_main(["evaluate", "--preset", "fourier_cylinder", "--synthetic", "--checkpoint", pt,
                                   "--forecast-after", str(m_train)])
                eval_s = time.perf_counter() - t0
                summary = json.loads(buf.getvalue().strip().splitlines()[-1])
                ev = runner.evaluate(fpreset, fx_np, pt, echo=False, device=dev, forecast_after=m_train)["forecast"]
                scalars = ("train_error", "holdout_error", "baseline_zero_error", "baseline_last_error")
                ev_err = {k: abs(summary["forecast"][k] - record[k]) / abs(record[k]) for k in scalars}
                ev_vec = max(max(abs(a - b) for a, b in zip(ev[k], record[k])) / max(record[k])
                             for k in ("per_snapshot_train_error", "per_snapshot_holdout_error"))
                check(rc == 0 and summary["forecast"]["m_train"] == m_train and max(ev_err.values()) <= 1e-5
                      and ev_vec <= 1e-5 and abs(summary["relative_error"] - art.relative_error)
                      <= 1e-5 * art.relative_error,
                      f"12: evaluate --forecast-after {m_train} against forecast.json: {ev_err}, vectors {ev_vec}")
    for tag, h in holdout_runs.items():
        a = h["art"]
        how = {"multistart": " --period-multistart 4", "single": "",
               "fft period": f", period_init={fft_period:.4f} (the spectrum's candidate)"}[tag]
        print(f"[12 holdout] {card}: fourier_cylinder as configured with --holdout 0.2{how}: trained on {a.config.m} "
              f"of {fpreset.m} "
              f"snapshots, {SLICE_EPOCHS} epochs through the mega-kernel in {h['wall']:.1f} s (the probes "
              f"{h['probe_s']:.2f} s, the rest {h['wall'] - h['probe_s']:.1f} s: POD, the fit, scoring, sweep and "
              f"exports), {a.steps_per_sec:.1f} steps/s over chunks 2-{SLICE_EPOCHS // fpreset.checkpoint_every}; "
              f"relative error {a.relative_error:.6f} (POD(r) {a.pod_error_r:.6f}), held-out error "
              f"{a.forecast['holdout_error']:.6f} (zero predictor {a.forecast['baseline_zero_error']:.6f}, last "
              f"snapshot {a.forecast['baseline_last_error']:.6f}); mega-kernel launches {h['launches']}"
              + (f" = {len(h['recs'])} probes + {SLICE_EPOCHS // fpreset.checkpoint_every} chunks; probes (period: "
                 "rec) " + ", ".join(f"{c:.4f}: {r:.6f}" for c, r in h["recs"]) + f", kept {h['kept']:.4f}; period "
                 f"after the fit {float(a.state.params['period'][0]):.4f}" if h["recs"] else " = chunks"))
    print(f"[12 evaluate] {card}: the evaluate subcommand on the multi-start run's final .pt with --forecast-after "
          f"{m_train} ({eval_s:.1f} s): scalars against forecast.json " + ", ".join(
              f"{k} {v:.2e}" for k, v in ev_err.items()) + f", per-snapshot vectors {ev_vec:.2e} of their largest "
          "(limit 1e-5)")

    hbatch = runner.prepare_batch(xtr, pod.pod_host(xtr, fpreset.r, dev).modes, dev)

    def hstart(cfg):
        spec = fourier.FourierSpec(cfg.n, m_train, cfg.r, cfg.poly_order, cfg.omega_init, cfg.n_fourier,
                                   cfg.period_init)
        return spec, fourier.Fourier(spec, device=dev).params()

    def probe_both(cfg):
        """The multi-start at m=801 through the kernel and its plain chunk:
        {route: (recs, kept, seconds)}."""
        cfg = dataclasses.replace(cfg, m=m_train, period_multistart=4)
        spec, params = hstart(cfg)
        loss_fn = fourier.build_loss(spec, cfg.beta, cfg.l1_lambda, method="factored")
        out = {}
        for route, chunk in (("kernel", train_chunk.make_chunk(spec, cfg)),
                             ("plain", lambda s, b, n: train_chunk.train_chunk_plain(s, b, n, spec, cfg))):
            lines = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            multistart(cfg, params, hbatch, loss_fn, fourier.param_groups(params), chunk=chunk, log=lines.append)
            torch.cuda.synchronize()
            out[route] = (*probe_recs(lines), time.perf_counter() - t0)
        return out

    hunit = dataclasses.replace(fpreset, omega_init=1.0, lr_omega=1.0)
    unit_probes = probe_both(hunit)
    (krecs, kkept, ks), (precs, pkept, ps) = unit_probes["kernel"], unit_probes["plain"]
    probe_err = max(abs(a - b) / abs(b) for (_, a), (_, b) in zip(krecs, precs))
    rec_of = dict(precs)
    near_tie = kkept != pkept and abs(rec_of[kkept] - rec_of[pkept]) <= 2e-4 * abs(rec_of[pkept])
    check([c for c, _ in krecs] == [c for c, _ in precs] and len(krecs) >= 2 and probe_err <= 2e-4
          and (kkept == pkept or near_tie),
          f"12: the probes at m={m_train} through the kernel {krecs} (kept {kkept}) against the plain chunk {precs} "
          f"(kept {pkept})")
    preset_probes = probe_both(fpreset)
    print(f"[12 probes] {card}: the multi-start at (n, m, nF)=({fpreset.n}, {m_train}, {fpreset.n_fourier}), "
          f"omega_init=1 lr_omega=1, {fpreset.period_probe_epochs} epochs a probe: kernel "
          + ", ".join(f"{c:.4f}: {r:.6f}" for c, r in krecs) + f" (kept {kkept:.4f}, {ks:.2f} s), plain chunk "
          + ", ".join(f"{c:.4f}: {r:.6f}" for c, r in precs) + f" (kept {pkept:.4f}, {ps:.2f} s); recs within "
          f"{probe_err:.2e} (limit 2e-4); " + ("the same pick" if kkept == pkept else "a near-tie: the picks' recs "
                                                "lie within 2e-4"))
    (krecs_p, kkept_p, _), (precs_p, pkept_p, _) = preset_probes["kernel"], preset_probes["plain"]
    print(f"[12 probes] {card}: the same at the preset's omega_init=1e4 (reported, not held): kernel "
          + ", ".join(f"{c:.4f}: {r:.6f}" for c, r in krecs_p) + f" (kept {kkept_p:.4f}), plain chunk "
          + ", ".join(f"{c:.4f}: {r:.6f}" for c, r in precs_p) + f" (kept {pkept_p:.4f})")

    hspec, hparams = hstart(hunit)
    hst = train.init_state(hparams, hunit)
    sk, mk = train_chunk.fused_train_chunk(hst, hbatch, PARITY_STEPS, hspec, hunit)
    sp, mp = train_chunk.train_chunk_plain(hst, hbatch, PARITY_STEPS, hspec, hunit)
    h_trace = {k: trace_rel(mk, mp, k, PARITY_STEPS) for k in ("rec", "l1", "total")}
    sk1, mk1 = train_chunk.fused_train_chunk(sk, hbatch, 1, hspec, hunit)
    sp1, mp1 = train_chunk.train_chunk_plain(sk, hbatch, 1, hspec, hunit)
    h_one = {k: ((mk1[k] - mp1[k]).abs() / mp1[k].abs()).item() for k in train_chunk.METRICS}
    h_one_ok = all(bool((mk1[k] - mp1[k]).abs() <= 2e-4 * mp1[k].abs() + (ORTHO_ATOL if k == "ortho" else 0.0))
                   for k in train_chunk.METRICS)
    h_params = {k: rel_err(sk1.params[k], sp1.params[k]) for k in sk1.params}
    h_max_abs = max(float((sk1.params[k] - sp1.params[k]).abs().max()) for k in sk1.params)
    check(h_trace["rec"] <= 2e-4 and h_trace["total"] <= 2e-4 and h_trace["l1"] <= 1e-3 and h_one_ok
          and max(h_params.values()) <= 1e-5,
          f"12: the mega-kernel at m={m_train} against its plain chunk: trace {h_trace}, one epoch {h_one}, "
          f"params {h_params}")
    hspec_p, hparams_p = hstart(fpreset)
    hst_p = train.init_state(hparams_p, fpreset)
    kernel = lambda: train_chunk.fused_train_chunk(hst_p, hbatch, TIMED_STEPS, hspec_p, fpreset)  # noqa: E731
    plain = lambda: train_chunk.train_chunk_plain(hst_p, hbatch, TIMED_STEPS, hspec_p, fpreset)  # noqa: E731
    hk1, hp1, hp2, hk2 = (time_ms(f, 3) for f in (kernel, plain, plain, kernel))
    n, nf, r, k = fpreset.n, fpreset.n_fourier, fpreset.r, hspec_p.num_poly_terms + 3 * fpreset.r
    state_bytes = 4 * 2 * (3 * r * n + 3 * k * (2 * nf + 1) + 3 * k + 3 * k + 9 * r + train_chunk.SVEC)
    nbytes = 4 * (n * m_train + n * r + m_train + TIMED_STEPS * len(train_chunk.METRICS)) + state_bytes
    flops = TIMED_STEPS * chunk_flops(n, m_train, k, nf)
    h_bound, h_by = bound_ms(flops, nbytes)
    cflops = TIMED_STEPS * contraction_flops(n, m_train, k)
    h_bound3 = bound_3xtf32_ms(cflops, flops - cflops, nbytes)
    per_epoch = 1e3 / TIMED_STEPS
    holdout_kernel = dict(launches=holdout_runs["multistart"]["launches"], max_abs=h_max_abs, ms=(hk1 + hk2) / 2,
                          plain_ms=(hp1 + hp2) / 2, bound_ms=h_bound, bound_by=h_by, bound_3xtf32_ms=h_bound3)
    # the kernel clock's split over a 2,000-epoch chunk at m=801 and at the
    # preset's m=1001, from the preset's init (reported)
    splits = {}
    for mm, bt in ((m_train, hbatch), (fpreset.m, fbatch)):
        if mm == m_train:
            sspec, sparams = hstart(fpreset)
            sst = train.init_state(sparams, fpreset)
        else:
            sspec, sst = fstart(fpreset)
        splits[mm] = train_chunk.phase_split(sst, bt, fpreset.checkpoint_every, sspec, fpreset)
    print(f"[12 split] {card}: the Fourier mega-kernel's clock, us an epoch over a {fpreset.checkpoint_every}-epoch "
          f"chunk at m={m_train} / m={fpreset.m}: " + ", ".join(
              f"{ph} {1e6 * splits[m_train][ph] / fpreset.checkpoint_every:.1f}/"
              f"{1e6 * splits[fpreset.m][ph] / fpreset.checkpoint_every:.1f}" for ph in splits[m_train])
          + f"; the epoch {1e6 * sum(splits[m_train].values()) / fpreset.checkpoint_every:.1f}/"
          f"{1e6 * sum(splits[fpreset.m].values()) / fpreset.checkpoint_every:.1f}")
    print(f"[12 m={m_train}] {card}: the Fourier mega-kernel at (n, m, K, nF)=({n}, {m_train}, {k}, {nf}) against its "
          f"plain chunk, omega_init=1 lr_omega=1: {PARITY_STEPS}-epoch trace " + ", ".join(
              f"{key} {v:.2e}" for key, v in h_trace.items()) + " (limits rec and total 2e-4, l1 1e-3); one epoch "
          "from the kernel's state: metrics " + ", ".join(f"{key} {v:.2e}" for key, v in h_one.items())
          + "; params " + ", ".join(f"{key} {v:.2e}" for key, v in h_params.items()) + " of max|param| (limit "
          f"1e-5); over {TIMED_STEPS}-epoch chunks as configured, in turns: kernel {hk1 * per_epoch:.1f}/"
          f"{hk2 * per_epoch:.1f} us/epoch, plain chunk {hp1 * per_epoch:.1f}/{hp2 * per_epoch:.1f}; bound "
          f"{h_bound * per_epoch:.1f} us/epoch ({h_by}, fp32), {h_bound3 * per_epoch:.1f} (3xTF32)")

    # 12p. the device POD at aneurysm's size (n=27000, m=1000): the method of
    # snapshots, the SVD and the randomized range finder, each under the
    # canonical signs, against pod_host (canonical signs applied for the
    # comparison) at rank 2r as the runner computes it; the leading r modes
    # (the training's) within eps s_1 / gap of max|mode|, at least 1e-4 (the
    # synthetic wake's modes come in pairs whose singular values lie 0.1-0.15%
    # apart, which fix each mode of a pair only to about eps s_1 / gap in
    # float32), 1e-3
    # for the randomized sketch (tests/test_pod.py's), their singular values
    # within 1e-5, the rank-r error 1e-5; two calls on the card give the same bits; the
    # seconds each takes (X on the card, after a warm-up call). Then a
    # cylinder run with pod_method="snapshots" through the mega-kernel (2,000
    # epochs, one launch) and evaluate of its final .pt with the same method:
    # the same errors and sweep
    ar = apreset.r
    axd = torch.as_tensor(ax_np, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = pod.pod_host(ax_np, 2 * ar, dev)
    torch.cuda.synchronize()
    pod_secs = {"host": time.perf_counter() - t0}
    hc = pod.truncate(pod.canonical_signs(host), ar)
    host_err = pod.pod_relative_error(axd, hc)
    sv = host.singular_values[: ar + 1].double()
    pair_limit = max(1e-4, 2.0 ** -23 * float(sv[0]) / float((sv[:-1] - sv[1:]).min()))
    pod_checks = {}
    for method in ("snapshots", "svd", "randomized"):
        pod.pod(axd, 2 * ar, method=method)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p2 = pod.canonical_signs(pod.pod(axd, 2 * ar, method=method))
        torch.cuda.synchronize()
        pod_secs[method] = time.perf_counter() - t0
        again = pod.canonical_signs(pod.pod(axd, 2 * ar, method=method))
        same = torch.equal(again.modes, p2.modes) and torch.equal(again.temporal, p2.temporal)
        p = pod.truncate(p2, ar)
        mode_err = rel_err(p.modes, hc.modes)
        sv_err = float(((p.singular_values - hc.singular_values).abs() / hc.singular_values).max())
        err = pod.pod_relative_error(axd, p)
        mode_limit = 1e-3 if method == "randomized" else pair_limit
        pod_checks[method] = dict(modes=mode_err, sv=sv_err, err=err, same=same, limit=mode_limit)
        check(same and mode_err <= mode_limit and sv_err <= 1e-5 and abs(err - host_err) <= 1e-5 * host_err,
              f"12p: {method} POD against pod_host: modes {mode_err:.2e}, singular values {sv_err:.2e}, rank-{ar} "
              f"error {err} against {host_err}, two calls the same bits {same}")
    print(f"[12p pod] {card}: aneurysm (n, m)=({apreset.n}, {apreset.m}), rank {2 * ar} with canonical signs, "
          f"against pod_host ({pod_secs['host']:.3f} s, rank-{ar} error {host_err:.6f}): " + "; ".join(
              f"{method} {pod_secs[method]:.4f} s, leading {ar} modes {c['modes']:.2e} of max|mode| (limit "
              f"{c['limit']:.1e}), singular values "
              f"{c['sv']:.2e}, rank-{ar} error {c['err']:.6f}, two calls bit-identical {c['same']}"
              for method, c in pod_checks.items()))
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(preset, pod_method="snapshots")
        reset_launches(*counters)
        art = runner.run(cfg, x_np, out_dir=tmp, num_epochs=preset.checkpoint_every, echo=False, device=dev)
        torch.cuda.synchronize()
        rt_launches = train_chunk.fused_train_chunk.launches
        rt_others = sum(fn.launches for fn in counters) - rt_launches
        rep = runner.evaluate(cfg, x_np, os.path.join(art.out_dir, "cylinder_r4_final.pt"), echo=False, device=dev)
        host_rep = runner.evaluate(preset, x_np, os.path.join(art.out_dir, "cylinder_r4_final.pt"), echo=False,
                                   device=dev)
    same_sweep = [e[1:] for e in rep["sweep"]] == [(e.error, e.nonzero_terms) for e in art.sweep]
    check(rt_launches == 1 and rt_others == 0, f"12p: the round trip's run launched the mega-kernel {rt_launches} "
          f"times, other kernels {rt_others}")
    check(rep["relative_error"] == art.relative_error and rep["pod_error_r"] == art.pod_error_r and same_sweep,
          f"12p: evaluate with pod_method=snapshots gave {rep['relative_error']}, the run {art.relative_error}")
    print(f"[12p round trip] {card}: cylinder with pod_method=snapshots, {preset.checkpoint_every} epochs through the "
          f"mega-kernel ({rt_launches} launch): relative error {art.relative_error!r}; evaluate of its final .pt with "
          f"the same method {rep['relative_error']!r} (equal {rep['relative_error'] == art.relative_error}, the sweep "
          f"equal {same_sweep}); with pod_method=host instead {host_rep['relative_error']!r}")

    # the sharded chunk by the device's work: in one profiler window of a
    # 200-step chunk, the step kernel's launches the profiler saw against
    # those ``step.launches`` counted, and the time of the device events by
    # kind (the step kernel, NCCL's all-reduce, the rest) and the window's
    # wall time, both a step, the profiler's own host time included. After
    # every timing: the profiler's tracing can stay attached.
    window_steps = 200
    for name, sh in sharded_steps.items():
        sh["chunk"](sh["state"], sh["local"], 10)
        torch.cuda.synchronize()
        counted = shard_step.step.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sh["chunk"](sh["state"], sh["local"], window_steps)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / window_steps
        counted = shard_step.step.launches - counted
        work_by = {"the step kernel": 0.0, "the all-reduce": 0.0, "the rest": 0.0}
        seen = 0
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0:
                what = ("the step kernel" if "step_kernel" in e.key else
                        "the all-reduce" if "nccl" in e.key.lower() else "the rest")
                work_by[what] += e.self_device_time_total / window_steps
                seen += e.count if what == "the step kernel" else 0
        device_us = sum(work_by.values())
        print(f"[8d work] {card}: {name} sharded chunk of {window_steps} steps under the profiler: step kernel "
              f"launches seen {seen}, counted {counted}; " + (
                  "device time not measured (the profiler saw no device event)" if device_us <= 0 else
                  f"{device_us:.1f} us of device time a step (" + ", ".join(f"{k} {v:.1f}" for k, v in work_by.items())
                  + f") in {wall_us:.1f} us of wall time a step with the profiler attached"))
        check(device_us <= 0 or seen == counted == window_steps + 1,
              f"{name}: the profiler saw {seen} step kernel launches, step.launches counted {counted}, in a "
              f"{window_steps}-step chunk")
    torch.distributed.destroy_process_group()

    # 8e. the dual contraction's device time per call beside the cuBLAS
    # pair's, at phase 7's shapes and in turns: the kernels' own time in a
    # profiler window of 50 calls (phase 7's CUDA events over back-to-back
    # calls take in the host's share of a call where the host is the slower).
    # After every timing, as the profiled windows above.
    for shape3 in DUAL_SHAPES:
        n, m, k = shape3
        a, b, x = (torch.randn(shape, generator=gen).to(dev) for shape in ((n, k), (k, m), (n, m)))
        xv = rows_16b(x)
        turns = []
        for fn in (lambda: dual_gemm.dual_contractions(a, b, x), lambda: dual_gemm.dual_contractions_plain(a, b, x),
                   lambda: dual_gemm.dual_contractions(a, b, xv)) * 2:
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
            turns.append(sum(e.self_device_time_total for e in prof.key_averages()
                             if str(e.device_type).endswith("CUDA")) / 50)
        dual_times[shape3]["device_us"] = (turns[0] + turns[3]) / 2
        print(f"[8e dual] {card}: dual_contractions at (n, m, K)={shape3}, device time per call: kernel "
              f"{turns[0]:.1f}/{turns[3]:.1f} us, the cuBLAS pair {turns[1]:.1f}/{turns[4]:.1f} us, the kernel on "
              f"X with 16-byte rows {turns[2]:.1f}/{turns[5]:.1f} us (in turns, 50 calls each)" if min(turns) > 0
              else "device time not measured (the profiler saw no device event)")

    # 9. the records
    print(json.dumps({"kernels": [
        {
            "name": "dual_contractions",
            "route": "cuda",
            "source": "desmo_tpu_torch/csrc/dual_gemm.cu",
            "replaces": "desmo_tpu/pallas/dual_gemm.py:194",
            "launches": dual_launches,
            "max_abs_err": errs[cyl],
            **dual_times[cyl],
            "library_ms": None,
        },
        {
            "name": "fused_train_chunk",
            "route": "cuda",
            "source": "desmo_tpu_torch/csrc/train_chunk.cu",
            "replaces": "desmo_tpu/pallas/train_chunk.py:356",
            "launches": chunk_launches,
            "max_abs_err": chunk_max_abs,
            "ms": chunk_ms,
            "plain_ms": chunk_plain_ms,
            "bound_ms": chunk_bound,
            "bound_by": chunk_by,
            "bound_3xtf32_ms": chunk_bound3,
            "library_ms": None,
        },
        {
            "name": "fused_train_chunk (Fourier form)",
            "route": "cuda",
            "source": "desmo_tpu_torch/csrc/train_chunk.cu",
            "replaces": "desmo_tpu/pallas/train_chunk.py:356 (nf>0)",
            "launches": fourier_launches,
            "max_abs_err": fourier_max_abs,
            "ms": fourier_ms,
            "plain_ms": fourier_plain_ms,
            "bound_ms": fourier_bound,
            "bound_by": fourier_by,
            "bound_3xtf32_ms": fourier_bound3,
            "library_ms": None,
        },
        {
            "name": "dual_contractions (packed eager loss, K'=108)",
            "route": "cuda",
            "source": "desmo_tpu_torch/csrc/dual_gemm.cu",
            "replaces": "desmo_tpu/pallas/dual_gemm.py:71",
            "launches": packed_dual_launches,
            "max_abs_err": errs[aneurysm_dual],
            **dual_times[aneurysm_dual],
            "library_ms": None,
        },
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "desmo_tpu_torch/csrc/dual_gemm.cu",
            "replaces": "desmo_tpu/pallas/dual_gemm.py:71",
            "launches": launches,
            "max_abs_err": errs[k12],
            **dual_times[k12],
            "library_ms": None,
        }
        for name, launches in (
            ("dual_contractions (Fourier eager loss, K=12)", dual_launches_f),
            ("dual_contractions (AE eager loss, K=12)", ae_dual_launches),
        )
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "desmo_tpu_torch/csrc/train_chunk.cu",
            "replaces": "desmo_tpu/pallas/train_chunk.py:356 (n_seeds>1, make_fused_ensemble_chunk :1801)",
            "launches": ensemble_runs[run]["launches"],
            "max_abs_err": packed_checks[check_tag]["max_abs"],
            **packed_times[time_tag],
            "library_ms": None,
        }
        for name, run, check_tag, time_tag in (
            ("fused_ensemble_chunk (aneurysm, 4 seeds)", "6e", "5e", "7e"),
            ("fused_ensemble_chunk (Fourier form, fourier_cylinder, 8 seeds)", "6ef", "5ef", "7ef"),
        )
    ] + [
        {
            "name": "fused_ae_chunk",
            "route": "cuda",
            "source": "desmo_tpu_torch/csrc/ae_chunk.cu",
            "replaces": "desmo_tpu/pallas/ae_chunk.py:170",
            "launches": ae_launches,
            "max_abs_err": ae_max_abs,
            "ms": ae_ms,
            "plain_ms": ae_plain_ms,
            "bound_ms": ae_bound,
            "bound_by": ae_by,
            "bound_3xtf32_ms": ae_bound3,
            "library_ms": None,
        },
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "desmo_tpu_torch/csrc/shard_step.cu",
            "replaces": "desmo_tpu/pallas/shard_step.py:74",
            "launches": sharded_runs[preset_name]["launches"],
            "max_abs_err": step_checks[preset_name]["max_abs"],
            **step_times[preset_name],
            "library_ms": None,
        }
        for name, preset_name in (("step (cylinder over space=1)", preset.name),
                                  ("step (fourier_cylinder over space=1)", fpreset.name))
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "desmo_tpu_torch/csrc/shard_step.cu",
            "replaces": "desmo_tpu/pallas/shard_step.py:168 (n_seeds>1, make_sharded_fused_ensemble_chunk :478)",
            "launches": packed_runs[preset_name]["launches"],
            "max_abs_err": packed_steps[preset_name]["max_abs"],
            **packed_step_times[preset_name],
            "library_ms": None,
        }
        for name, preset_name in (("step (aneurysm, 4 seeds over space=1)", "aneurysm"),
                                  ("step (Fourier form, fourier_cylinder, 8 seeds over space=1)", "fourier_cylinder"))
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "desmo_tpu_torch/csrc/train_chunk.cu",
            "replaces": "desmo_tpu/pallas/train_chunk.py:356" + (" (nf>0)" if "Fourier" in name else ""),
            "launches": large[preset_name]["launches"],
            "max_abs_err": large[preset_name]["max_abs"],
            **{key: v for key, v in large[preset_name].items() if key not in ("launches", "max_abs")},
            "library_ms": None,
        }
        for name, preset_name in (("fused_train_chunk (channel, n=16384)", "channel"),
                                  ("fused_train_chunk (aneurysm, one seed)", "aneurysm"),
                                  ("fused_train_chunk (Fourier form, fourier_aneurysm, nF=30)", "fourier_aneurysm"))
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": resumes[run]["launches"],
            "max_abs_err": max_abs,
            **times,
            "library_ms": None,
        }
        for name, run, source, replaces, max_abs, times in (
            ("fused_train_chunk (cylinder, straight and resumed)", "cylinder", "desmo_tpu_torch/csrc/train_chunk.cu",
             "desmo_tpu/pallas/train_chunk.py:356", chunk_max_abs,
             dict(ms=chunk_ms, plain_ms=chunk_plain_ms, bound_ms=chunk_bound, bound_by=chunk_by,
                  bound_3xtf32_ms=chunk_bound3)),
            ("step (cylinder over space=1, straight and resumed)", "cylinder over space=1",
             "desmo_tpu_torch/csrc/shard_step.cu", "desmo_tpu/pallas/shard_step.py:74",
             step_checks[preset.name]["max_abs"], step_times[preset.name]),
            ("fused_ae_chunk (ae_cylinder, straight and resumed)", "ae_cylinder", "desmo_tpu_torch/csrc/ae_chunk.cu",
             "desmo_tpu/pallas/ae_chunk.py:170", ae_max_abs,
             dict(ms=ae_ms, plain_ms=ae_plain_ms, bound_ms=ae_bound, bound_by=ae_by, bound_3xtf32_ms=ae_bound3)),
        )
    ] + [
        {
            "name": "fused_train_chunk (Fourier form, fourier_cylinder at m=801: the multi-start's probes and the "
                    "holdout fit)",
            "route": "cuda",
            "source": "desmo_tpu_torch/csrc/train_chunk.cu",
            "replaces": "desmo_tpu/pallas/train_chunk.py:356 (nf>0)",
            "launches": holdout_kernel["launches"],
            "max_abs_err": holdout_kernel["max_abs"],
            **{key: v for key, v in holdout_kernel.items() if key not in ("launches", "max_abs")},
            "library_ms": None,
        },
        {
            "name": "fused_train_chunk (cylinder with pod_method=snapshots, the evaluate round trip)",
            "route": "cuda",
            "source": "desmo_tpu_torch/csrc/train_chunk.cu",
            "replaces": "desmo_tpu/pallas/train_chunk.py:356",
            "launches": rt_launches,
            "max_abs_err": chunk_max_abs,
            "ms": chunk_ms,
            "plain_ms": chunk_plain_ms,
            "bound_ms": chunk_bound,
            "bound_by": chunk_by,
            "bound_3xtf32_ms": chunk_bound3,
            "library_ms": None,
        },
    ]}))
    check(kind == torch.cuda.get_device_name(dev), f"the device record's kind {kind!r} is not the card's name")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
