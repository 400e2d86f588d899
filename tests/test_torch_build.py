"""The kernel libraries' names (``lvc_tpu_torch/ops/_build.py``): a library is
named by a hash of its source, of every header in ``csrc/`` and of the nvcc
flags, so a changed header or flag builds a new library instead of loading a
stale one. No nvcc is needed: only the names are computed."""
import pytest

from lvc_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc/ of two kernel sources and two headers."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "other.cu").write_text("int other;\n")
    (tmp_path / "a.cuh").write_text("#pragma once\nint a;\n")
    (tmp_path / "b.cuh").write_text("#pragma once\nint b;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_path_changes_when_a_header_is_added(csrc):
    before = _build.library_path("k")
    (csrc / "c.cuh").write_text("int c;\n")
    assert _build.library_path("k") != before


@pytest.mark.parametrize("changed", ["k.cu", "a.cuh", "b.cuh"])
def test_path_changes_with_source_or_header_bytes(csrc, changed):
    before = _build.library_path("k")
    path = csrc / changed
    path.write_text(path.read_text() + "// edited\n")
    after = _build.library_path("k")
    assert after != before and after.parent == before.parent and after.name.startswith("libk-")


def test_path_ignores_other_kernel_sources(csrc):
    before = _build.library_path("k")
    (csrc / "other.cu").write_text("int changed;\n")
    assert _build.library_path("k") == before


@pytest.mark.parametrize(
    "flags",
    [["-I/usr/local/cutlass/include"], ["-lcuda"], ["-DDEBUG=1"]],
    ids=["include_path", "link_flag", "define"],
)
def test_path_changes_with_flags(csrc, monkeypatch, flags):
    before = _build.library_path("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + flags)
    assert _build.library_path("k") != before


def test_path_is_stable(csrc):
    assert _build.library_path("k") == _build.library_path("k")


def test_every_port_source_has_a_path():
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"lib{name}-")
