"""The port runs where jax is not installed: the package and its CLI, in a
subprocess whose import system refuses ``jax`` and ``jaxlib``."""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ModuleNotFoundError(f"jax is blocked in this process: {name}")
        return None
sys.meta_path.insert(0, _NoJax())
"""

MODULES = [
    "desmo_tpu_torch",
    "desmo_tpu_torch.__main__",
    "desmo_tpu_torch.checkpoint",
    "desmo_tpu_torch.configs",
    "desmo_tpu_torch.device",
    "desmo_tpu_torch.kernels._build",
    "desmo_tpu_torch.kernels.dual_gemm",
    "desmo_tpu_torch.library",
    "desmo_tpu_torch.losses",
    "desmo_tpu_torch.models.desmo",
    "desmo_tpu_torch.optim",
    "desmo_tpu_torch.pod",
    "desmo_tpu_torch.runner",
    "desmo_tpu_torch.sparsify",
    "desmo_tpu_torch.train",
]


def _run(code: str, tmp_path, timeout: int = 120):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-c", _BLOCK_JAX + code],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=timeout,
    )


def test_package_imports_without_jax(tmp_path):
    code = (
        "import importlib\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib') for m in sys.modules)\n"
        "try:\n"
        "    import jax\n"
        "except ModuleNotFoundError:\n"
        "    print('blocked')\n"
    )
    proc = _run(code, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "blocked"


def test_cli_run_without_jax(tmp_path):
    out_dir = tmp_path / "runs"
    code = (
        "import runpy\n"
        "sys.argv = ['desmo_tpu_torch', 'run', '--preset', 'cylinder', '--synthetic', "
        f"'--epochs', '3', '--device', 'cpu', '--out-dir', {str(out_dir)!r}]\n"
        "runpy.run_module('desmo_tpu_torch', run_name='__main__')\n"
    )
    proc = _run(code, tmp_path)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["preset"] == "cylinder" and summary["device"] == "cpu"
    files = os.listdir(out_dir / "cylinder")
    assert "cylinder_r4_final.pt" in files and "state_final.npz" in files
