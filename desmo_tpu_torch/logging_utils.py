"""Structured metrics logging and observability (SURVEY §5.5).

The reference logs via ``print(..., flush=True)`` every 10 epochs and relies
on SLURM's stdout redirect for persistence (``DESMO/cylinder_flow/
DESMO-Cylinder.py:776-777``; ``GPU_jobfile.sh:26``). Here metrics are emitted
both in the reference's human-readable epoch format (diffable against the
shipped ``DESMO.out`` logs) and as machine-readable CSV/JSONL streams.

The port's own copy of ``desmo_tpu/logging_utils.py``.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Optional, TextIO


class MetricsLogger:
    """Writes epoch metrics to CSV + JSONL and optionally echoes the
    reference-format line to stdout."""

    def __init__(self, out_dir: str, run_name: str, echo: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self.echo = echo
        self._csv_path = os.path.join(out_dir, f"{run_name}.csv")
        self._jsonl_path = os.path.join(out_dir, f"{run_name}.jsonl")
        self._csv_file: Optional[TextIO] = None
        self._jsonl_file: Optional[TextIO] = None
        self._writer = None
        self._t0 = time.time()

    def log_epoch(self, epoch: int, num_epochs: int, metrics: dict) -> None:
        row = {"epoch": epoch, "wall_s": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        if self._csv_file is None:
            self._csv_file = open(self._csv_path, "w", newline="")
            self._writer = csv.DictWriter(self._csv_file, fieldnames=list(row))
            self._writer.writeheader()
            self._jsonl_file = open(self._jsonl_path, "w")
        self._writer.writerow(row)
        self._jsonl_file.write(json.dumps(row) + "\n")
        if self.echo:
            print(self.format_reference_line(epoch, num_epochs, metrics), flush=True)

    @staticmethod
    def format_reference_line(epoch: int, num_epochs: int, metrics: dict) -> str:
        """The reference's epoch print format (``CYL:777``), for diffability
        against the shipped ``DESMO.out`` training logs."""
        line = (
            f"Epoch [{epoch + 1}/{num_epochs}], "
            f"Rec Loss: {metrics['rec']:.12f}, "
            f"Spatial ortho loss: {metrics['ortho']:.8f}, "
            f"L1 loss: {metrics['l1']:.4f} "
        )
        if "ae" in metrics:
            line += f", AE loss: {metrics['ae']:.8f} "
        return line

    def close(self) -> None:
        for f in (self._csv_file, self._jsonl_file):
            if f is not None:
                f.close()
        self._csv_file = self._jsonl_file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
