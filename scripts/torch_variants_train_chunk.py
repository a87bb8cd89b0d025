#!/usr/bin/env python3
"""Where the mega-kernel's two contractions with X spend their time, on one GPU.

    python3 scripts/torch_variants_train_chunk.py [--preset cylinder,aneurysm:4] [--steps 1000]

Builds variants of this checkout's ``csrc/train_chunk.cu`` into
``build/variants/``, each with a part of ``csrc/tile_mma.cuh`` taken out:

- ``full``: the header as it is;
- ``no_copies``: ``cp.async`` copies nothing, so the tiles hold stale data;
- ``no_products``: no ``mma.sync``;
- ``staging_only``: no fragment loads, TF32 splits or products, so that
  X·Bᵀ and AᵀX are their staging, barriers and bookkeeping alone.

The variants compute wrong numbers: only their times mean anything. For
each cell (``preset`` or ``preset:S`` for S packed seeds, as
``scripts/torch_ab_train_chunk.py`` takes them) every variant runs one
``--steps``-epoch chunk in turn, twice, and prints its phase split from the
kernel's own clock. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

MMA = re.compile(r"(__device__ __forceinline__ void mma_tf32\([^)]*\) \{\n)(.*?)(\n\}\n)", re.S)
COPY = re.compile(r"(__device__ __forceinline__ void cp_async16\([^)]*\) \{\n)(.*?)(\n\}\n)", re.S)
LOADS = ("load_a_rows", "load_a_cols_split", "load_b_cols", "load_b_rows")


def stub(header: str, pattern: re.Pattern, body: str) -> str:
    new, count = pattern.subn(lambda mt: mt.group(1) + body + mt.group(3), header)
    if count != 1:
        raise SystemExit("torch_variants_train_chunk: tile_mma.cuh no longer has the function this variant stubs")
    return new


def without_fragments(header: str) -> str:
    """Every fragment loader gives constants: no loads, no splits."""
    header = stub(header, MMA, "  (void)d; (void)a; (void)b;")
    for name in LOADS:
        pattern = re.compile(r"(__device__ __forceinline__ void " + name + r"\([^)]*\) \{\n)(.*?)(\n\}\n)", re.S)
        n = 4 if "_a_" in name else 2
        header = stub(header, pattern, "\n".join(f"  big[{e}] = small[{e}] = {e};" for e in range(n)))
    return header


def variants(header: str) -> dict[str, str]:
    return {
        "full": header,
        "no_copies": stub(header, COPY, "  (void)dst; (void)src; (void)valid;"),
        # the operands still reach the accumulators, so their loads and splits stay
        "no_products": stub(header, MMA, "  for (int e = 0; e < 4; ++e) d[e] += f32_bits(a[e] ^ b[e % 2]);"),
        "staging_only": without_fragments(header),
    }


def build(name: str, header: str, source: str) -> Path:
    from desmo_tpu_torch.kernels import _build

    out = _build.BUILD_DIR.parent / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "tile_mma.cuh").write_text(header)
    (out / "train_chunk.cu").write_text(source)
    lib = out / "libtrain_chunk.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / "train_chunk.cu")],
                   check=True, capture_output=True)
    return lib


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--preset", default="cylinder,aneurysm:4")
    parser.add_argument("--steps", type=int, default=1000)
    args = parser.parse_args(argv)

    import torch_ab_train_chunk as ab
    from desmo_tpu_torch.kernels import _build, train_chunk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    source = (_build.CSRC / "train_chunk.cu").read_text()
    headers = variants((_build.CSRC / "tile_mma.cuh").read_text())
    with concurrent.futures.ThreadPoolExecutor(len(headers)) as pool:
        built = dict(zip(headers, pool.map(build, headers, headers.values(), [source] * len(headers))))
    libs = {name: train_chunk._bind(ctypes.CDLL(str(path))) for name, path in built.items()}
    for cell in args.preset.split(","):
        cfg, spec, batch, state = ab.problem(cell)
        for _ in range(2):
            for name, lib in libs.items():
                with ab.launching(lib):
                    split = train_chunk.phase_split(state, batch, args.steps, spec, cfg)
                print(ab.split_line(f"{cell} {name}", split, args.steps), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
