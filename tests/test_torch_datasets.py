"""The port's ShapeNet and SVR datasets against dpfx.data, bit for bit, on
small trees written here: ShapeNetH5 (an HDF5 file), ShapeNetNpyDir (the
PointFlow npy tree) and ShapeNetRenderDataset (npy clouds paired with PNG
renders) under every normalisation, the label maps and the stats subsample;
render_cloud and SyntheticSVRDataset; the image batches, load_all_images
and preload_images; build_dataset's keys; and that dpfx_torch.data imports
without h5py and pillow."""

import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import dpfx.data as jd  # noqa: E402
from dpfx_torch import data as td  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SYN = {"airplane": "02691156", "chair": "03001627"}
NORMS = ["none", "per_shape", "global"]


def _cloud(rng, n=120, shift=0.0):
    return (rng.normal(size=(n, 3)) * rng.uniform(0.5, 2.0, size=3) + shift).astype(np.float32)


def _same_items(a, b):
    """Two datasets serve the same clouds (bit for bit), labels and names."""
    assert len(a) == len(b) > 0
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert x.dtype == y.dtype and np.array_equal(x, y), i
        assert a.label(i) == b.label(i), i
    assert a.label_names == b.label_names
    if getattr(b, "stats", None) is None:
        assert getattr(a, "stats", None) is None
    else:
        assert np.array_equal(a.stats.mean, b.stats.mean) and a.stats.scale == b.stats.scale


@pytest.fixture(scope="module")
def npy_tree(tmp_path_factory):
    """root/<synset>/<split>/<model>.npy for two synsets, and renders
    render/<synset>/<model>/rendering/NN.png (4 views) for all but the
    last model of each split (the dataset drops unpaired models)."""
    try:
        from PIL import Image
    except ImportError:                 # the render tests skip without pillow
        Image = None
    root = tmp_path_factory.mktemp("shapenet")
    rng = np.random.default_rng(0)
    for c, syn in enumerate(SYN.values()):
        for split, count in (("train", 7), ("val", 3), ("test", 4)):
            d = root / "clouds" / syn / split
            d.mkdir(parents=True)
            for m in range(count):
                name = f"{split}_{m:03d}"
                np.save(d / f"{name}.npy", _cloud(rng, shift=c))
                if m < count - 1 and Image is not None:
                    r = root / "render" / syn / name / "rendering"
                    r.mkdir(parents=True)
                    for v in range(4):
                        px = rng.integers(0, 256, size=(20, 24, 3), dtype=np.uint8)
                        Image.fromarray(px).save(r / f"{v:02d}.png")
            (d / "notes.txt").write_text("not a cloud")
    return root


@pytest.mark.parametrize("normalize", NORMS)
@pytest.mark.parametrize("split,category", [("train", "airplane"), ("test", "all")])
def test_npy_dir_matches_dpfx(npy_tree, normalize, split, category):
    kw = dict(split=split, category=category, normalize=normalize)
    _same_items(td.ShapeNetNpyDir(str(npy_tree / "clouds"), **kw),
                jd.ShapeNetNpyDir(str(npy_tree / "clouds"), **kw))


def test_npy_dir_stats_subsample_and_missing_tree(npy_tree):
    kw = dict(split="val", category="all", normalize="global", norm_stats_max_clouds=5,
              stats_seed=3)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        a = td.ShapeNetNpyDir(str(npy_tree / "clouds"), **kw)
    assert any("norm_stats_max_clouds" in str(w.message) for w in seen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same_items(a, jd.ShapeNetNpyDir(str(npy_tree / "clouds"), **kw))
    with pytest.raises(FileNotFoundError):
        td.ShapeNetNpyDir(str(npy_tree / "none"), category="airplane")


def _write_h5(path, rng, layout):
    h5py = pytest.importorskip("h5py")
    with h5py.File(path, "w") as f:
        for split, count in (("train", 9), ("val", 4), ("test", 5)):
            data = np.stack([_cloud(rng, 100, shift=i % 3) for i in range(count)])
            if layout == "nested":
                f.create_group(split).create_dataset("data", data=data)
            else:
                f.create_dataset(split, data=data)
            f.create_dataset(f"{split}_labels", data=np.arange(count) % 3)
        if layout == "table":
            f.create_dataset("label_names", data=np.array([b"02691156", b"03001627", b"lamp"]))


@pytest.mark.parametrize("layout", ["flat", "nested", "table"])
@pytest.mark.parametrize("normalize", NORMS)
def test_h5_matches_dpfx(tmp_path, layout, normalize):
    path = str(tmp_path / "clouds.h5")
    _write_h5(path, np.random.default_rng(1), layout)
    cases = [dict(category="all")]
    if layout == "table":       # the file's own table: synset ids read as names
        cases.append(dict(category="chair"))
    else:
        cases.append(dict(category="b", label_map={"a": 0, "b": 1, "c": 2}))
    for case in cases:
        for split in ("train", "test"):
            kw = dict(split=split, normalize=normalize, **case)
            with td.ShapeNetH5(path, **kw) as a, jd.ShapeNetH5(path, **kw) as b:
                _same_items(a, b)
                if case["category"] != "all":
                    assert {a.label(i) for i in range(len(a))} == {1}


def test_h5_refusals_and_stats_subsample(tmp_path):
    path = str(tmp_path / "clouds.h5")
    _write_h5(path, np.random.default_rng(2), "flat")
    with pytest.raises(ValueError, match="h5_label_map"):
        td.ShapeNetH5(path, category="chair")
    with pytest.raises(KeyError, match="no split"):
        td.ShapeNetH5(path, split="holdout")
    kw = dict(split="test", normalize="global", norm_stats_max_clouds=4, stats_seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with td.ShapeNetH5(path, **kw) as a, jd.ShapeNetH5(path, **kw) as b:
            _same_items(a, b)
    a.close()                           # idempotent


@pytest.mark.parametrize("normalize", NORMS)
def test_render_dataset_matches_dpfx(npy_tree, normalize):
    pytest.importorskip("PIL")
    for split, category in (("train", "all"), ("val", "chair")):
        kw = dict(split=split, category=category, normalize=normalize, image_size=16,
                  views_per_model=4)
        a = td.ShapeNetRenderDataset(str(npy_tree / "clouds"), str(npy_tree / "render"), **kw)
        b = jd.ShapeNetRenderDataset(str(npy_tree / "clouds"), str(npy_tree / "render"), **kw)
        _same_items(a, b)
        assert a.items == b.items
        for i in range(len(a)):
            x, y = a.image(i), b.image(i)
            assert x.shape == (16, 16, 3) and x.dtype == y.dtype and np.array_equal(x, y)
        assert np.array_equal(a.image(0, view=3), b.image(0, view=3))


def test_render_cloud_and_synthetic_svr_match_dpfx():
    rng = np.random.default_rng(3)
    pts = _cloud(rng, 500)
    for size, view in ((16, 0), (32, 5)):
        x, y = td.render_cloud(pts, size, view), jd.render_cloud(pts, size, view)
        assert x.shape == (size, size, 3) and np.array_equal(x, y)
    a = td.SyntheticSVRDataset(size=10, image_size=16, split="val", family="v2")
    b = jd.SyntheticSVRDataset(size=10, image_size=16, split="val", family="v2")
    _same_items(a, b)
    for i in (0, 3, 9, 3):              # 3 twice: the cached render
        assert np.array_equal(a.image(i), b.image(i))


def test_image_batches_and_stacks_match_dpfx():
    a = td.SyntheticSVRDataset(size=12, image_size=16)
    b = jd.SyntheticSVRDataset(size=12, image_size=16)
    kw = dict(batch_size=5, n_points=300, seed=4, epochs=2, with_images=True)
    got, want = list(td.iterate_batches(a, **kw)), list(jd.iterate_batches(b, **kw))
    assert len(got) == len(want) == 4
    for x, y in zip(got, want):
        assert x.keys() == y.keys() == {"x", "image"}
        assert np.array_equal(x["x"], y["x"]) and np.array_equal(x["image"], y["image"])
    assert "image" not in next(td.iterate_batches(td.SyntheticDataset(size=8), 4, 64,
                                                   with_images=True))
    idx = np.array([1, 7, 2])
    for limit, indices in ((None, None), (5, None), (None, idx)):
        assert np.array_equal(td.load_all_images(a, limit=limit, indices=indices),
                              jd.load_all_images(b, limit=limit, indices=indices))
    assert td.load_all_images(td.SyntheticDataset(size=4)) is None
    for rows in (None, idx):
        assert np.array_equal(td.preload_images(a, indices=rows),
                              jd.preload_images(b, indices=rows))
        assert np.array_equal(td.preload_clouds(a, indices=rows),
                              jd.preload_clouds(b, indices=rows))


def test_preload_images_refuses_ragged_and_empty():
    class Ragged:
        def __len__(self):
            return 3

        def image(self, i):
            return np.zeros((8 + (i == 2), 8, 3), np.float32)

    with pytest.raises(ValueError, match="uniform image shapes"):
        td.preload_images(Ragged())
    with pytest.raises(ValueError, match="empty"):
        td.preload_images(Ragged(), indices=[])


@pytest.mark.parametrize("key", ["synthetic", "synthetic_svr", "shapenet_h5", "shapenet_npy_dir",
                                 "shapenet_svr"])
def test_build_dataset_matches_dpfx(npy_tree, tmp_path, key):
    from dpfx.config import config_from_dict as jax_config

    data = {"dataset": key, "synthetic_size": 16, "category": "all", "normalize": "global",
            "views_per_model": 4}
    if key == "shapenet_h5":
        data["path"] = str(tmp_path / "c.h5")
        _write_h5(data["path"], np.random.default_rng(5), "flat")
    elif key.startswith("shapenet"):
        if key == "shapenet_svr":
            pytest.importorskip("PIL")
        data["path"] = str(npy_tree / "clouds")
        data["render_path"] = str(npy_tree / "render")
    raw = {"experiment": "gen", "data": data}
    for split in ("train", "val"):
        a = td.build_dataset(config_from_dict(raw).data, split, 16)
        b = jd.build_dataset(jax_config(raw).data, split, 16)
        assert type(a).__name__ == type(b).__name__
        _same_items(a, b)
        if hasattr(b, "image"):
            assert np.array_equal(a.image(1), b.image(1))
    with pytest.raises(ValueError, match="unknown dataset"):
        td.build_dataset(config_from_dict({"data": {"dataset": "modelnet"}}).data, "train")


def test_data_imports_without_h5py_and_pillow():
    """With h5py and PIL unimportable, dpfx_torch.data imports and serves
    the synthetic SVR pairs; ShapeNetRenderDataset says what it needs."""
    code = (
        "import sys\n"
        "sys.modules.update({'h5py': None, 'PIL': None, 'PIL.Image': None})\n"
        "import dpfx_torch.data as d\n"
        "ds = d.SyntheticSVRDataset(size=4, image_size=8)\n"
        "assert d.preload_images(ds).shape == (4, 8, 8, 3)\n"
        "try:\n"
        "    d.ShapeNetRenderDataset('a', 'b')\n"
        "except ImportError as e:\n"
        "    assert 'pillow' in str(e)\n"
        "else:\n"
        "    raise SystemExit('no ImportError')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
