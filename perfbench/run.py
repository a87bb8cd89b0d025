"""Run one cell of the benchmark once, on the cards of this machine.

    python3 perfbench/run.py --workload cylinder.one_seed --seed 7 --seconds 20 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` (seed-epochs trained in the window), ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; last, ``compared``: each number the
correctness check compared, beside its limit. The same numbers are the last
lines of standard error. Exits non-zero, printing no result, without a CUDA
card (or with fewer than the cell asks for), and when JAX or the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from perfbench import harness

    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    seed = args.seed % 2**63
    result = harness.run(cell, seed, args.seconds, bool(args.trace), "cuda", T_START)
    print(f"card: {harness.card_line()}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: JAX or the JAX package is loaded: {bad}", file=sys.stderr)
        return 3
    for name, entry in result["compared"].items():
        print(f"compared {name}: {entry['value']!r} (limit {entry['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
