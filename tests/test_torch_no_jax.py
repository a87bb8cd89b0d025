"""The port runs where jax is not installed and imports nothing of the JAX
package: the package, ``chip_smoke`` and the CLI, in a subprocess whose
import system refuses ``jax``, ``jaxlib`` and ``desmo_tpu`` (but not
``desmo_tpu_torch``)."""

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
        if name.split(".")[0] in ("jax", "jaxlib", "desmo_tpu"):
            raise ModuleNotFoundError(f"jax and desmo_tpu are blocked in this process: {name}")
        return None
sys.meta_path.insert(0, _NoJax())
"""

MODULES = [
    "desmo_tpu_torch",
    "desmo_tpu_torch.__main__",
    "desmo_tpu_torch.checkpoint",
    "desmo_tpu_torch.configs",
    "desmo_tpu_torch.data",
    "desmo_tpu_torch.device",
    "desmo_tpu_torch.ensemble",
    "desmo_tpu_torch.io.native",
    "desmo_tpu_torch.io.synthetic",
    "desmo_tpu_torch.io.vtk",
    "desmo_tpu_torch.kernels._build",
    "desmo_tpu_torch.kernels._chunk_optim",
    "desmo_tpu_torch.kernels.ae_chunk",
    "desmo_tpu_torch.kernels.dual_gemm",
    "desmo_tpu_torch.kernels.shard_step",
    "desmo_tpu_torch.kernels.train_chunk",
    "desmo_tpu_torch.library",
    "desmo_tpu_torch.logging_utils",
    "desmo_tpu_torch.losses",
    "desmo_tpu_torch.models.autoencoder",
    "desmo_tpu_torch.models.desmo",
    "desmo_tpu_torch.models.fourier",
    "desmo_tpu_torch.optim",
    "desmo_tpu_torch.parallel",
    "desmo_tpu_torch.parallel.sharding",
    "desmo_tpu_torch.pod",
    "desmo_tpu_torch.runner",
    "desmo_tpu_torch.sparsify",
    "desmo_tpu_torch.train",
    "chip_smoke",
]
_BLOCKED = ("jax", "jaxlib", "desmo_tpu")


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
        f"assert not any(m.split('.')[0] in {_BLOCKED!r} for m in sys.modules)\n"
        f"for name in {_BLOCKED!r}:\n"
        "    try:\n"
        "        importlib.import_module(name)\n"
        "    except ModuleNotFoundError:\n"
        "        print('blocked', name)\n"
    )
    proc = _run(code, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:3] == [f"blocked {name}" for name in _BLOCKED]


def test_sources_import_nothing_of_desmo_tpu():
    """No line of the port or of ``chip_smoke.py`` imports ``desmo_tpu``,
    lazily or not (the same match as
    ``grep -rnE "^\\s*(from|import) desmo_tpu(\\.| |$)"``)."""
    import re
    from pathlib import Path

    pattern = re.compile(r"^\s*(from|import) desmo_tpu(\.| |$)")
    files = sorted(Path(REPO, "desmo_tpu_torch").rglob("*.py")) + [Path(REPO, "chip_smoke.py")]
    hits = [f"{f}:{i}" for f in files for i, line in enumerate(f.read_text().splitlines(), 1) if pattern.match(line)]
    assert len(files) > 20 and hits == []


def test_cli_run_without_jax(tmp_path):
    """The CLI at full width on the CPU through the preset's chunk method
    (``auto``: the eager loop on the CPU)."""
    _cli_run(tmp_path, None)


def test_cli_run_megakernel_without_jax(tmp_path):
    """The CLI at full width on the CPU through the mega-kernel's chunk (its
    plain version on the CPU)."""
    _cli_run(tmp_path, "megakernel")


@pytest.mark.parametrize("chunk_method", [None, "megakernel"])
def test_cli_run_fourier_without_jax(tmp_path, chunk_method):
    """The Fourier preset at full width (n=3961, m=1001, nF=10) on the CPU,
    through the eager loop and through the mega-kernel's plain chunk; the
    export holds the reference's period keys."""
    out_dir = _cli_run(tmp_path, chunk_method, preset="fourier_cylinder", r=2)
    import torch

    sd = torch.load(out_dir / "fourier_cylinder_r2_final.pt", weights_only=True)
    assert {"period_list.0", "trig_period_list.0"} <= set(sd) and sd["z_list.0"].shape == (21,)


@pytest.mark.parametrize("chunk_method", [None, "megakernel"])
def test_cli_run_ae_without_jax(tmp_path, chunk_method):
    """The AE preset at full width (n=3961, m=1001) on the CPU, through the
    eager loop and through the AE kernel's plain chunk; the export holds the
    reference's ``SINDyAutoencoder`` keys."""
    out_dir = _cli_run(tmp_path, chunk_method, preset="ae_cylinder", r=2)
    import torch

    sd = torch.load(out_dir / "ae_cylinder_r2_final.pt", weights_only=True)
    assert {"temporal_ae.encoder.0.weight", "omega_phi6", "zsin_coef_1"} <= set(sd)


def test_cli_run_seeds_without_jax(tmp_path):
    """Two packed seeds of the cylinder preset at full width on the CPU (the
    packed eager loop); the run writes ensemble.json."""
    out_dir = _cli_run(tmp_path, None, extra=["--seeds", "2"])
    assert "ensemble.json" in os.listdir(out_dir)


def test_cli_run_mesh_without_jax(tmp_path):
    """The cylinder preset at full width over a one-rank mesh on the CPU (a
    gloo group of this process; the sharded step kernel's plain version)."""
    _cli_run(tmp_path, None, extra=["--mesh", "space=1"])


def _cli_run(tmp_path, chunk_method, preset="cylinder", r=4, extra=()):
    out_dir = tmp_path / "runs"
    extra = list(extra) + ([] if chunk_method is None else ["--chunk-method", chunk_method])
    code = (
        "import runpy\n"
        f"sys.argv = ['desmo_tpu_torch', 'run', '--preset', {preset!r}, '--synthetic', "
        f"'--epochs', '3', '--device', 'cpu', '--out-dir', {str(out_dir)!r}] + {extra!r}\n"
        "runpy.run_module('desmo_tpu_torch', run_name='__main__')\n"
    )
    proc = _run(code, tmp_path)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["preset"] == preset and summary["device"] == "cpu"
    assert summary["chunk_method"] == (chunk_method or "auto")
    files = os.listdir(out_dir / preset)
    assert f"{preset}_r{r}_final.pt" in files and "state_final.npz" in files
    return out_dir / preset


def test_cli_evaluate_inspect_pt_and_pod_without_jax(tmp_path):
    """A Fourier run with the period multi-start, a holdout and the device
    POD, then ``evaluate --forecast-after`` of its final checkpoint with the
    same POD method, ``inspect-pt`` and ``pod``, all on the CPU with jax and
    ``desmo_tpu`` blocked, on a small ``--npz`` (300 rows, 120 snapshots:
    the probes run ``period_probe_epochs``, 300 each, through the
    mega-kernel's plain chunk): evaluate reproduces the run's errors and
    held-out error."""
    import numpy as np

    rng = np.random.default_rng(0)
    t = np.arange(120)
    x = (np.outer(rng.standard_normal(300), np.sin(2 * np.pi * t / 30.0))
         + np.outer(rng.standard_normal(300), np.cos(2 * np.pi * t / 15.0)))
    npz = tmp_path / "small.npz"
    np.savez(npz, X=x.astype(np.float32))
    out_dir = tmp_path / "runs"
    pt = out_dir / "fourier_cylinder" / "fourier_cylinder_r2_final.pt"
    code = (
        "import io, json, contextlib\n"
        "from desmo_tpu_torch.__main__ import main\n"
        "def last(argv):\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        assert main(argv) == 0\n"
        "    return buf.getvalue()\n"
        f"common = ['--preset', 'fourier_cylinder', '--npz', {str(npz)!r}, '--device', 'cpu', "
        "'--pod-method', 'snapshots']\n"
        f"run = json.loads(last(['run', *common, '--epochs', '3', '--period-multistart', '2', '--holdout', '0.2', "
        f"'--chunk-method', 'megakernel', '--out-dir', {str(out_dir)!r}]).splitlines()[-1])\n"
        f"ev = json.loads(last(['evaluate', *common, '--checkpoint', {str(pt)!r}, '--forecast-after', '96'])"
        ".splitlines()[-1])\n"
        f"listing = last(['inspect-pt', {str(pt)!r}, '--device', 'cpu'])\n"
        f"pod = json.loads(last(['pod', '--preset', 'cylinder', '--npz', {str(npz)!r}, '--device', 'cpu', "
        f"'--method', 'randomized', '--save', {str(tmp_path / 'pod.npz')!r}]).splitlines()[-1])\n"
        "print(json.dumps({'run': run, 'evaluate': ev, 'listing': listing, 'pod': pod}))\n"
    )
    proc = _run(code, tmp_path)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    run, ev = got["run"], got["evaluate"]
    assert run["forecast"]["m_train"] == ev["forecast"]["m_train"] == 96
    assert ev["relative_error"] == run["relative_error"] and ev["pod_error_r"] == run["pod_error_r"]
    assert abs(ev["forecast"]["holdout_error"] - run["forecast"]["holdout_error"]) <= 1e-5 * run["forecast"][
        "holdout_error"]
    assert "period_list.0" in got["listing"] and "(21,)" in got["listing"]
    assert got["pod"]["method"] == "randomized" and got["pod"]["rank"] == 4 and os.path.exists(tmp_path / "pod.npz")
