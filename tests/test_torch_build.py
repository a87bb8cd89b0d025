"""The build cache of the port's CUDA kernels (``desmo_tpu_torch.kernels._build``).

A library is named by a hash of its source, the headers of ``csrc/`` and
the compiler's flags, so that a change to any of them builds anew and an
unchanged tree loads what it built before. Runs on a copy of ``csrc/``; no
compiler is needed.
"""

import shutil

import pytest

pytest.importorskip("torch")

from desmo_tpu_torch.kernels import _build  # noqa: E402

KERNELS = ("train_chunk", "dual_gemm", "ae_chunk", "shard_step")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build key reads in place of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_the_sources_have_headers_to_hash():
    assert (_build.CSRC / "tile_mma.cuh").exists()
    assert '#include "tile_mma.cuh"' in (_build.CSRC / "train_chunk.cu").read_text()


@pytest.mark.parametrize("name", KERNELS)
def test_the_key_is_stable_and_named_for_the_kernel(csrc, name):
    path = _build.library_path(name)
    assert path == _build.library_path(name)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"


@pytest.mark.parametrize("name", KERNELS)
def test_a_changed_header_changes_the_key(csrc, name):
    before = _build.library_path(name)
    header = csrc / "tile_mma.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    assert _build.library_path(name) != before


def test_a_new_header_changes_the_key(csrc):
    before = _build.library_path("train_chunk")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("train_chunk") != before


def test_a_changed_source_changes_only_its_own_key(csrc):
    before = {name: _build.library_path(name) for name in KERNELS}
    src = csrc / "train_chunk.cu"
    src.write_text(src.read_text() + "\n// changed\n")
    after = {name: _build.library_path(name) for name in KERNELS}
    assert after["train_chunk"] != before["train_chunk"]
    assert all(after[name] == before[name] for name in KERNELS if name != "train_chunk")
