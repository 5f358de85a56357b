"""The port's kernel build (``repro_torch.kernels._build``): libraries are
named by a hash of every file of a kernel's ``csrc/`` directory, so an
edited header rebuilds as an edited source does.  Runs on the CPU: it
hashes files and builds nothing."""

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def kernel(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\n')
    (csrc / "k.cuh").write_text("constexpr int kTile = 64;\n")
    monkeypatch.setitem(_build.SOURCES, "k", csrc / "k.cu")
    return csrc


@pytest.mark.parametrize("edit", ["k.cu", "k.cuh"])
def test_library_path_changes_with_every_file_of_csrc(kernel, edit):
    before = _build.library_path("k")
    assert before == _build.library_path("k")
    assert before.parent == _build.BUILD_DIR
    assert before.name.startswith("k-") and before.suffix == ".so"
    with open(kernel / edit, "a") as f:
        f.write("// edited\n")
    assert _build.library_path("k") != before


def test_library_path_changes_when_a_header_is_added(kernel):
    before = _build.library_path("k")
    (kernel / "extra.cuh").write_text("\n")
    assert _build.library_path("k") != before


def test_every_kernel_source_hashes():
    paths = {name: _build.library_path(name) for name in _build.SOURCES}
    assert len(set(paths.values())) == len(paths)
