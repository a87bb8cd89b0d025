"""The port's own copies of the JAX package's jax-free modules equal the
originals: the presets, ``preprocess``, ``cylinder_wake``, ``MetricsLogger``
and the VTK and native snapshot readers (on files written into ``tmp_path``
by ``desmo_tpu``'s writers)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from desmo_tpu import configs as jconfigs  # noqa: E402
from desmo_tpu import data as jdata  # noqa: E402
from desmo_tpu import logging_utils as jlogging  # noqa: E402
from desmo_tpu.io import synthetic as jsynthetic  # noqa: E402
from desmo_tpu.io import vtk as jvtk  # noqa: E402
from desmo_tpu_torch import configs, data, logging_utils  # noqa: E402
from desmo_tpu_torch.io import native, synthetic, vtk  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_presets_equal_field_for_field():
    assert configs.GROUP_ORDER == jconfigs.GROUP_ORDER
    assert configs.names() == jconfigs.names()
    assert [f.name for f in dataclasses.fields(configs.RunConfig)] == [
        f.name for f in dataclasses.fields(jconfigs.RunConfig)
    ]
    for name in configs.names():
        ours, ref = configs.get(name), jconfigs.get(name)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref), name
        assert ours.group_lrs == ref.group_lrs
    with pytest.raises(KeyError, match="unknown preset"):
        configs.get("no-such-preset")


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(),
        dict(dim=3),
        dict(magnitude=False),
        dict(mean_subtract=False, time_stride=2),
        dict(inv_sqrt_m=True),
    ],
)
def test_preprocess_equals(kwargs):
    x = np.random.default_rng(0).standard_normal((3 * 50, 21)).astype(np.float32)
    got, got_mean = data.preprocess(x, **kwargs)
    ref, ref_mean = jdata.preprocess(x, **kwargs)
    np.testing.assert_array_equal(got, ref)
    if ref_mean is None:
        assert got_mean is None
    else:
        np.testing.assert_array_equal(got_mean, ref_mean)


@pytest.mark.parametrize(
    "args, kwargs",
    [((), {}), ((300, 120), {"seed": 3}), ((64, 40), {"noise": 0.1, "period_steps": 60.0})],
)
def test_cylinder_wake_bit_for_bit(args, kwargs):
    np.testing.assert_array_equal(synthetic.cylinder_wake(*args, **kwargs), jsynthetic.cylinder_wake(*args, **kwargs))


def test_metrics_logger_writes_the_same_files(tmp_path):
    rows = [(i, {"rec": 1.0 / (i + 1), "ortho": 0.1 * i, "l1": 3.0}) for i in range(5)]
    for mod, sub in ((logging_utils, "ours"), (jlogging, "ref")):
        with mod.MetricsLogger(str(tmp_path / sub), "run", echo=False) as log:
            for epoch, metrics in rows:
                log.log_epoch(epoch, 5, metrics)
    for suffix in ("csv", "jsonl"):
        ours = (tmp_path / "ours" / f"run.{suffix}").read_text().splitlines()
        ref = (tmp_path / "ref" / f"run.{suffix}").read_text().splitlines()
        assert len(ours) == len(ref)
        # identical but for the wall-clock column
        assert [line.split(",")[0] for line in ours] == [line.split(",")[0] for line in ref]
    assert logging_utils.MetricsLogger.format_reference_line(3, 10, rows[1][1]) == (
        jlogging.MetricsLogger.format_reference_line(3, 10, rows[1][1])
    )


def _mesh(npts=12):
    rng = np.random.default_rng(1)
    points = rng.standard_normal((npts, 3)).astype(np.float32)
    return jvtk.Mesh(
        points=points,
        point_data={},
        cell_data={},
        cells=np.arange(npts, dtype=np.int64),
        cell_offsets=np.arange(3, npts + 1, 3, dtype=np.int64),
        cell_types=np.full(npts // 3, 5, np.uint8),
    )


@pytest.fixture
def series(tmp_path):
    """Four snapshot series of 5 files each, written by ``desmo_tpu``: .vtu
    ascii, .vtu raw-appended, legacy binary and legacy ascii."""
    rng = np.random.default_rng(2)
    mesh = _mesh()
    out = {}
    for fmt in ("ascii", "appended"):
        d = tmp_path / f"vtu_{fmt}"
        d.mkdir()
        for i in range(5):
            vel = rng.standard_normal((12, 3)).astype(np.float32)
            jvtk.write_vtu(str(d / f"velocity_{i}.vtu"), mesh, point_data={"velocity": vel}, data_format=fmt)
        out[f"vtu_{fmt}"] = (str(d), ".vtu", "velocity")
    for binary in (True, False):
        d = tmp_path / f"legacy_{'bin' if binary else 'ascii'}"
        d.mkdir()
        for i in range(5):
            vel = rng.standard_normal((2 * 3 * 2, 3)).astype(np.float32)
            jvtk.write_legacy_vtk(str(d / f"velocity_{i}.vtk"), (2, 3, 2), {"Velocity": vel}, binary=binary)
        out[d.name] = (str(d), ".vtk", "Velocity")
    return out


def test_vtk_readers_equal(series):
    for name, (d, ext, array) in series.items():
        x, mesh = vtk.read_snapshot_series(d, "velocity_", 0, 5, extension=ext, array=array)
        rx, rmesh = jvtk.read_snapshot_series(d, "velocity_", 0, 5, extension=ext, array=array)
        np.testing.assert_array_equal(x, rx, err_msg=name)
        np.testing.assert_array_equal(mesh.points, rmesh.points, err_msg=name)
        one = vtk.read_mesh(f"{d}/velocity_0{ext}")
        assert sorted(one.point_data) == sorted(jvtk.read_mesh(f"{d}/velocity_0{ext}").point_data)


def test_native_reader_equals_the_reference_reader(series):
    if not native.available():
        pytest.skip(f"the native loader does not build here: {native.build_error()}")
    assert native.library_path().parent == native.BUILD_DIR
    for name, (d, ext, array) in series.items():
        if name in ("vtu_ascii", "legacy_ascii"):
            # sub-formats the native reader leaves to the Python one (runner.load_data falls back)
            with pytest.raises(RuntimeError):
                native.read_snapshot_series_native(d, "velocity_", 0, 5, extension=ext, array=array)
            continue
        got = native.read_snapshot_series_native(d, "velocity_", 0, 5, extension=ext, array=array)
        ref, _ = jvtk.read_snapshot_series(d, "velocity_", 0, 5, extension=ext, array=array)
        np.testing.assert_array_equal(got, ref.astype(np.float32), err_msg=name)


def test_native_builds_race_free(tmp_path):
    """Four processes build the loader into one empty directory at once: each
    compiles to a temporary file of its own and renames it into place, so
    every process loads a whole library and no temporary file is left."""
    if native.build_error() is not None and "native build failed" not in native.build_error():
        pytest.skip(f"no compiler here: {native.build_error()}")
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from desmo_tpu_torch.io import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "assert native.available(), native.build_error()\n"
        "print(native.library_path().name)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(names)
