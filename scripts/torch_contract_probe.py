#!/usr/bin/env python3
"""The mega-kernel's two contractions with X against float64, on one GPU.

    python3 scripts/torch_contract_probe.py
    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 scripts/torch_contract_probe.py --parent build/parent/desmo_tpu_torch/csrc/train_chunk.cu

At cylinder (n=3961, m=1001, K=47) and at aneurysm with four packed seeds
(n=27000, m=1000, K'=108), synthetic data at full width: the state after
200 epochs of the plain chunk at omega_init=1, lr_omega=1, then one epoch of
the kernel from it. Its dictionary A (read back from the kernel's scratch),
the state's B and X are the inputs; X·Bᵀ and AᵀX as the kernel forms them
are held against the same products in float64, as a share of max|ref|.

- This checkout: ``train_chunk.contract_probe`` (the kernel's own routines).
- ``--parent SRC``: another version of ``csrc/train_chunk.cu`` with this
  checkout's C interface (``desmo_train_chunk``), compiled by the script
  into ``build/ab/`` after two stores are patched into its rows and columns
  phases, so that one epoch leaves its xb and ax in extra scratch; its A is
  read from the scratch's start (stride K). The patch matches the text of
  the design before the tensor-core tiles (X·Bᵀ staged through registers,
  each block's AᵀX slab over all rows) and refuses any other.

Prints the card's name and power limit first, then one line per cell and
version, with the float32 plain version's error beside.
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

ROOT = Path(__file__).resolve().parents[1]
STATE_STEPS = 200

# the parent's two loops, each with one store of its result appended
XB_STORE = (
    "          Y_s[(ty + 16) * ld + k] = acc[1][c];\n",
    "          Y_s[(ty + 16) * ld + k] = acc[1][c];\n"
    "          float* xb_out = a.work + L.total + (long long)K * m;\n"
    "          if (ty < rows) xb_out[(long long)(r0 + ty) * K + k] = acc[0][c];\n"
    "          if (ty + 16 < rows) xb_out[(long long)(r0 + ty + 16) * K + k] = acc[1][c];\n",
)
AX_STORE = (
    "      ax_s[o] = sum;\n",
    "      ax_s[o] = sum;\n"
    "      if (o % kSW < w) a.work[L.total + (long long)(o / kSW) * m + j0 + o % kSW] = sum;\n",
)
WORKSPACE = (
    "  return make_layout(n, m, r, Ks, S, nf > 0 ? 2 * nf + 1 : 0, grid).total;\n",
    "  return make_layout(n, m, r, Ks, S, nf > 0 ? 2 * nf + 1 : 0, grid).total + (long long)S * Ks * (m + n);\n",
)


def build_parent(src: str) -> ctypes.CDLL:
    """The patched parent library: one epoch leaves ax (K, m) and xb (n, K)
    after its own scratch."""
    from desmo_tpu_torch.kernels import _build

    text = Path(src).read_text()
    for old, new in (XB_STORE, AX_STORE, WORKSPACE):
        if text.count(old) != 1:
            raise SystemExit(f"torch_contract_probe: {src} is not the design this patch knows ({old.strip()!r})")
        text = text.replace(old, new)
    out_dir = _build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    patched = out_dir / "train_chunk_probe.cu"
    patched.write_text(text)
    out = out_dir / "libtrain_chunk_probe.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(patched)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(out))


@contextlib.contextmanager
def launching(lib: ctypes.CDLL):
    from desmo_tpu_torch.kernels import train_chunk

    with mock.patch.object(train_chunk, "_lib", lambda: lib):
        train_chunk._grid.cache_clear()
        yield
    train_chunk._grid.cache_clear()


def cells():
    """``(name, cfg, spec, batch, state)`` for each cell, on the card."""
    import torch

    from desmo_tpu_torch import configs, device as device_mod, ensemble, pod, runner
    from desmo_tpu_torch.kernels import train_chunk
    from desmo_tpu_torch.models import desmo

    dev = device_mod.resolve("cuda")
    for preset, seeds in (("cylinder", 1), ("aneurysm", 4)):
        cfg = dataclasses.replace(configs.get(preset), omega_init=1.0, lr_omega=1.0)
        spec = desmo.DesmoSpec(cfg.n, cfg.m, cfg.r, cfg.poly_order, cfg.omega_init)
        x, _ = runner.load_data(cfg, synthetic=True)
        batch = runner.prepare_batch(x, pod.pod_host(x, cfg.r, dev).modes, dev)
        params = ensemble.init_params(spec, seeds, seed=cfg.seed, phi_sigma=cfg.seed_phi_sigma,
                                      omega_spread=cfg.seed_omega_spread, device=dev)
        state = ensemble.init_state(params, cfg, seeds)
        state, _ = train_chunk.train_chunk_plain_packed(state, batch, STATE_STEPS, spec, cfg)
        torch.cuda.synchronize()
        yield f"{preset} S={seeds}", cfg, spec, batch, state


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--parent", help="csrc/train_chunk.cu of the design before the tensor-core tiles")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from desmo_tpu_torch.kernels import train_chunk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    parent = train_chunk._bind(build_parent(args.parent)) if args.parent else None

    def rel(got, ref):
        return float((got.double() - ref).abs().max() / ref.abs().max())

    for name, cfg, spec, batch, state in cells():
        x = batch["x"]
        n, m = x.shape
        k = state.params["z"].shape[0] * (spec.num_poly_terms + 3 * spec.r)
        b = train_chunk.pack_seeds(state, *train_chunk.seed_hypers(cfg, state.params["phi"].shape[0]))
        b = b.b[0].view(k, m).clone()  # B of the state, before the epoch's update
        versions = {}
        with launching(train_chunk._lib()):
            _, _, work = train_chunk._launch(state, batch, 1, spec, cfg, None, None)
        torch.cuda.synchronize()
        lda = (k + 3) // 4 * 4
        a = work[:n * lda].view(n, lda)[:, :k].contiguous()  # this checkout's A: stride round4(K)
        if parent is not None:
            with launching(parent):
                _, _, pwork = train_chunk._launch(state, batch, 1, spec, cfg, None, None)
            torch.cuda.synchronize()
            total = pwork.numel() - k * (m + n)
            pa = pwork[:n * k].view(n, k)  # the parent's A: stride K
            pb_ax = pwork[total:total + k * m].view(k, m)
            pb_xb = pwork[total + k * m:].view(n, k)
            versions["parent"] = (pa, pb_xb, pb_ax)
        xb, ax = train_chunk.contract_probe(a, b, x)
        torch.cuda.synchronize()
        versions["this checkout"] = (a, xb, ax)
        for version, (va, vxb, vax) in versions.items():
            rxb, rax = x.double() @ b.double().T, va.double().T @ x.double()
            fxb, fax = train_chunk.contract_probe_plain(va.contiguous(), b, x)
            print(f"{name} (n, m, K)=({n}, {m}, {k}), {version}: X·Bᵀ {rel(vxb, rxb):.2e}, AᵀX {rel(vax, rax):.2e} "
                  f"of max|ref| against float64; the float32 plain version {rel(fxb, rxb):.2e}, {rel(fax, rax):.2e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
