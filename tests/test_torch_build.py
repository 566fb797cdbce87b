"""The port's kernel build rule, without nvcc: a library is stale when it is
missing or older than its .cu source or any shared csrc/*.cuh header."""

import os

import pytest

pytest.importorskip("torch")

from dpfx_torch.ops import _build  # noqa: E402


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)

    def touch(path, t):
        path.write_text("")
        os.utime(path, (t, t))
    return csrc, build, touch


def test_missing_library_is_stale(tree):
    csrc, _, touch = tree
    touch(csrc / "k.cu", 100)
    assert _build.sources() == ["k"]
    assert _build._stale("k")


def test_source_or_header_newer_than_library(tree):
    csrc, build, touch = tree
    touch(csrc / "k.cu", 100)
    touch(csrc / "common.cuh", 100)
    touch(build / "libk.so", 200)
    assert not _build._stale("k")
    touch(csrc / "common.cuh", 300)          # a shared header changed
    assert _build._stale("k")
    touch(build / "libk.so", 400)
    touch(csrc / "k.cu", 500)                # the source changed
    assert _build._stale("k")
