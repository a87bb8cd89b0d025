#!/usr/bin/env python3
"""Time variants of the dual contraction's kernel with parts of it stubbed
out, on one GPU, to see what bounds it.

    python3 scripts/torch_variants_dual_gemm.py [base,onepass,...]

Each variant is ``desmo_tpu_torch/csrc/dual_gemm.cu`` and its tile headers
with one text patch (PATCHES), compiled with the kernels' own nvcc flags
into ``build/variants_dual/<name>/`` and loaded through its C interface.
The variants give wrong results and are only timed: ``base`` as built;
``nosplit`` without the TF32 split of the staged operands (the planes are
copied, not split); ``onepass`` with one TF32 pass of the three;
``xbonly`` and ``axonly`` with one kind of block returning at once;
``emptymain`` with the main kernel returning at once (the launches and the
partial sums alone); ``copyonly`` with no products and no split (the
cp.async staging alone). At (n, m, K) = (3961, 1001, 47), (27000, 1000,
108), (3961, 1001, 12) and (3961, 1000, 47) it prints µs per call by CUDA
events over back-to-back calls (200, 50 at n = 27000), for m not a multiple
of 4 also on X as a view with 16-byte rows (``+aligned``), beside the two
cuBLAS fp32 products, then the device time per call of ``base``'s kernels
and cuBLAS's from a ``torch.profiler`` window of 20 calls each. Prints the
card's name and power limit first.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PRODUCT = "if (aon[i] && bon[j]) mma_tf32(acc[i][j], {}, {});"
SPLIT_STORES = "  *reinterpret_cast<float4*>(pb) = big4;\n  *reinterpret_cast<float4*>(ps) = small4;"
PATCHES = {
    "base": [],
    "nosplit": [("col_mma.cuh", SPLIT_STORES, "")],
    "onepass": [("col_mma.cuh", PRODUCT.format("a_small[i]", "b_big[j]"), ";"),
                ("col_mma.cuh", PRODUCT.format("a_big[i]", "b_small[j]"), ";")],
    "xbonly": [("dual_gemm.cu", "  // the gp tiles of one slab", "  return;\n  // the gp tiles of one slab")],
    "axonly": [("dual_gemm.cu", "  if (r >= n_ax) {\n    const int tile", "  if (r >= n_ax) {\n    return;\n    const int tile")],
    "emptymain": [("dual_gemm.cu", "  float* ring = shared_base();\n  const Plan& pl = p.pl;",
                   "  return;\n  float* ring = shared_base();\n  const Plan& pl = p.pl;")],
    "copyonly": [("col_mma.cuh", PRODUCT.format("a_small[i]", "b_big[j]"), ";"),
                 ("col_mma.cuh", PRODUCT.format("a_big[i]", "b_small[j]"), ";"),
                 ("col_mma.cuh", PRODUCT.format("a_big[i]", "b_big[j]"), ";"),
                 ("col_mma.cuh", SPLIT_STORES, "")],
}
SHAPES = ((3961, 1001, 47), (27000, 1000, 108), (3961, 1001, 12), (3961, 1000, 47))


def build(name: str):
    """The variant's library, or None where nvcc refused it."""
    from desmo_tpu_torch.kernels import _build

    d = _build.BUILD_DIR.parent / "variants_dual" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in ("dual_gemm.cu", "col_mma.cuh", "tile_mma.cuh"):
        shutil.copy(_build.CSRC / f, d / f)
    for f, old, new in PATCHES[name]:
        text = (d / f).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: the patch of {f} no longer applies")
        (d / f).write_text(text.replace(old, new))
    out = d / "lib.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(d / "dual_gemm.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        print(f"{name}: nvcc failed\n{proc.stderr[-2000:]}")
        return None
    log = proc.stdout + proc.stderr
    print(f"{name}: registers {re.findall(r'Used (\d+) registers', log)}, "
          f"bytes spilled {re.findall(r'(\d+) bytes spill stores', log)}", flush=True)
    lib = ctypes.CDLL(str(out))
    lib.desmo_dual_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.desmo_dual_contractions.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
                                            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return lib


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


def caller(lib, a, b, x):
    """A call of the variant on (a, b, x) with its own scratch."""
    import torch

    (n, k), m = a.shape, b.shape[1]
    plan = (ctypes.c_int * 2)()
    lib.desmo_dual_plan(n, m, k, plan)
    gr, gx = plan[0], plan[1]
    ax, xb = torch.empty(k, m, device=x.device), torch.empty(n, k, device=x.device)
    part, xpart = torch.empty(gr, k, m, device=x.device), torch.empty(gx, n, k, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: lib.desmo_dual_contractions(a.data_ptr(), b.data_ptr(), x.data_ptr(), x.stride(0),
                                               part.data_ptr(), xpart.data_ptr(), ax.data_ptr(), xb.data_ptr(),
                                               n, m, k, gr, gx, stream)


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (argv if argv is not None else sys.argv[1:]) or [",".join(PATCHES)]
    names = names[0].split(",")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = {name: lib for name, lib in zip(names, pool.map(build, names)) if lib is not None}
    gen = torch.Generator().manual_seed(0)
    for n, m, k in SHAPES:
        a, b, x = (torch.randn(s, generator=gen).cuda() for s in ((n, k), (k, m), (n, m)))
        xa = torch.zeros(n, (m + 3) // 4 * 4, device="cuda")[:, :m]
        xa.copy_(x)
        iters = 50 if n > 10_000 else 200
        line = []
        for name, lib in libs.items():
            line.append(f"{name} {1e3 * time_ms(caller(lib, a, b, x), iters):.1f}")
            if m % 4:
                line.append(f"{name}+aligned {1e3 * time_ms(caller(lib, a, b, xa), iters):.1f}")
        plain = 1e3 * time_ms(lambda: (a.T @ x, x @ b.T), iters)
        print(f"{(n, m, k)}: " + ", ".join(line) + f", cuBLAS pair {plain:.1f} us per call", flush=True)
        if "base" in libs:
            calls = {"base": caller(libs["base"], a, b, xa if m % 4 else x), "cuBLAS": lambda: (a.T @ x, x @ b.T)}
            for name, fn in calls.items():
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        fn()
                    torch.cuda.synchronize()
                print(f"   {name}, device us per call: " + "; ".join(
                    f"{e.key[:60]} {e.device_time_total / 20:.1f}" for e in prof.key_averages()
                    if e.device_time_total > 0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
