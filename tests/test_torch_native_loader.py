"""The port's native C++ loader (dpfx_torch.native) against dpfx's: the
same batches bit for bit at one worker, over epoch boundaries, with and
without per-shape normalization; the sidecar's refusal of a second
normalization; the build into build/ under a source hash, two builds at
once, and a failed build raising with the compiler's output."""

import json
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from dpfx.native import NativeBatcher as JaxNativeBatcher  # noqa: E402
from dpfx_torch import native  # noqa: E402
from dpfx_torch.native import NativeBatcher  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    rng = np.random.default_rng(0)
    clouds = (rng.normal(size=(10, 300, 3)) * 2 + 1).astype(np.float32)
    path = tmp_path_factory.mktemp("packed") / "clouds.npy"
    np.save(path, clouds)
    return str(path), clouds


@pytest.mark.parametrize("normalize", ["none", "per_shape"])
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_equal_dpfx_bit_for_bit(stack, normalize, seed):
    """10 clouds in batches of 4: 9 batches cross three epoch boundaries
    (each a reshuffle keyed by the seed and the epoch)."""
    path, _ = stack
    ours = NativeBatcher(path, 4, 128, normalize=normalize, seed=seed, n_workers=1)
    ref = JaxNativeBatcher(path, 4, 128, normalize=normalize, seed=seed, n_workers=1)
    try:
        assert (ours.n_items, ours.n_stored, ours.n_coords) == (10, 300, 3)
        for _ in range(9):
            a, b = ours.next(), ref.next()
            assert a.dtype == np.float32 and a.shape == (4, 128, 3)
            np.testing.assert_array_equal(a, b)
    finally:
        ours.close()
        ref.close()


def test_iterator_copies_and_workers_serve_stored_points(stack):
    path, clouds = stack
    nb = NativeBatcher(path, 3, 300, seed=1, n_workers=3)
    try:
        it = iter(nb)
        first = next(it)["x"]
        kept = first.copy()
        next(it)
        np.testing.assert_array_equal(first, kept)   # the reused buffer is not handed out
        for item in first:    # all 300 points: a permutation of one stored cloud
            src = [c for c in clouds if np.array_equal(np.sort(c, 0), np.sort(item, 0))]
            assert len(src) == 1
    finally:
        nb.close()
    with pytest.raises(RuntimeError, match="after close"):
        nb.next()


def test_sidecar_refuses_a_second_normalization(tmp_path):
    path = str(tmp_path / "packed.npy")
    np.save(path, np.zeros((8, 32, 3), np.float32))
    with open(path + ".meta.json", "w") as f:
        json.dump({"normalize_applied": "per_shape"}, f)
    with pytest.raises(ValueError, match="double-normalize"):
        NativeBatcher(path, 2, 8, normalize="per_shape")
    nb = NativeBatcher(path, 2, 8)
    assert nb.next().shape == (2, 8, 3)
    nb.close()
    with pytest.raises(RuntimeError, match="n_points 64 > stored 32"):
        NativeBatcher(path, 2, 64)


def test_builds_into_build_dir_under_a_source_hash():
    lib = native.lib_path()
    assert lib.parent == ROOT / "build" / "dpfx_torch_native"
    assert lib.name.startswith("libdpfx_loader_") and lib.suffix == ".so"
    assert native.native_available() and Path(native.build_native()) == lib
    assert not list(native.SRC.parent.glob("*.so"))      # nothing next to the source


def test_two_builds_at_once(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    out, errs = [], []

    def build():
        try:
            out.append(native.build_native())
        except Exception as e:   # pragma: no cover - reported below
            errs.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and len(out) == 2 and out[0] == out[1]
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [Path(out[0]).name]
    import ctypes

    assert ctypes.CDLL(out[0]).dpfx_batcher_open


@pytest.mark.parametrize("fault", ["source", "compiler"])
def test_failed_build_raises(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    if fault == "source":
        bad = tmp_path / "dpfx_loader.cpp"
        bad.write_text("int broken( {\n")
        monkeypatch.setattr(native, "SRC", bad)
        match = "error"
    else:
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
        match = "no-such-g\\+\\+"
    with pytest.raises(RuntimeError, match=match):
        native.build_native()
    assert native.build_error()
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="build failed"):
        NativeBatcher(str(tmp_path / "x.npy"), 2, 8)
    assert not list((tmp_path / "build").glob("*"))      # no half-written library left
