"""The port's sample montage (dpfx_torch.utils.viz.save_cloud_montage)
against dpfx's, pixel for pixel, and `python -m dpfx_torch.generate
--png` on the CPU."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

import numpy as np  # noqa: E402

from dpfx.utils import save_cloud_montage as jax_montage  # noqa: E402
from dpfx_torch import generate  # noqa: E402
from dpfx_torch.compat import randomize_  # noqa: E402
from dpfx_torch.config import load_config  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.utils.viz import save_cloud_montage  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE = str(ROOT / "configs" / "smoke_gen_synthetic.yaml")


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im)


@pytest.mark.parametrize("n,kwargs", [(20, {}), (5, {"views": 4, "tile": 64}),
                                      (3, {"views": 2, "tile": 32, "max_clouds": 2})])
def test_montage_equals_dpfx_pixel_for_pixel(tmp_path, n, kwargs):
    rng = np.random.default_rng(n)
    clouds = (rng.normal(size=(n, 500, 3)) * rng.uniform(0.2, 2, size=(n, 1, 3))).astype(np.float32)
    ours, ref = tmp_path / "ours.png", tmp_path / "ref.png"
    assert save_cloud_montage(clouds, str(ours), **kwargs) == str(ours)
    assert jax_montage(clouds, str(ref), **kwargs) == str(ref)
    a = _pixels(ours)
    views, tile = kwargs.get("views", 3), kwargs.get("tile", 128)
    rows = min(n, kwargs.get("max_clouds", 16))
    assert a.shape == (rows * tile, views * tile, 3) and a.dtype == np.uint8 and a.max() > 0
    np.testing.assert_array_equal(a, _pixels(ref))


def test_generate_png(tmp_path, capsys):
    model = randomize_(DPF(load_config(SMOKE)), seed=3, scale=0.05)
    weights = tmp_path / "w.pt"
    torch.save(model.state_dict(), weights)
    out, png = tmp_path / "s.npy", tmp_path / "m.png"
    rc = generate.main([SMOKE, "--device", "cpu", "--weights", str(weights), "--n-clouds", "4",
                        "--n-points", "300", "--out", str(out), "--png", str(png)])
    assert rc == 0 and f"montage -> {png}" in capsys.readouterr().out
    img = _pixels(png)
    assert img.shape == (4 * 128, 3 * 128, 3) and img.max() > 0
    ref = tmp_path / "ref.png"
    jax_montage(np.load(out), str(ref))
    np.testing.assert_array_equal(img, _pixels(ref))


def test_montage_without_pillow(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "PIL", None)
    path = tmp_path / "m.png"
    assert save_cloud_montage(np.zeros((2, 10, 3), np.float32), str(path)) is None
    assert not path.exists()
    model = randomize_(DPF(load_config(SMOKE)), seed=3, scale=0.05)
    weights = tmp_path / "w.pt"
    torch.save(model.state_dict(), weights)
    rc = generate.main([SMOKE, "--device", "cpu", "--weights", str(weights), "--n-clouds", "2",
                        "--n-points", "64", "--out", str(tmp_path / "s.npy"), "--png", str(path)])
    assert rc == 0 and "montage -> skipped (no PIL)" in capsys.readouterr().out
