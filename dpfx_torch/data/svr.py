"""Single-view-reconstruction datasets, a copy of ``dpfx/data/svr.py``:
pairs of (cloud, rendered view), numpy only.

  * ``SyntheticSVRDataset`` -- the deterministic synthetic clouds, each
    rendered on the host to a depth-shaded orthographic image
    (``render_cloud``): a learnable image-to-shape pairing with no data on
    disk;
  * ``ShapeNetRenderDataset`` -- the PointFlow-lineage layout, clouds
    ``root/<synset>/<split>/<model>.npy`` with renders
    ``render_root/<synset>/<model>/rendering/{00..23}.png``. It needs
    ``pillow``, imported where it is used.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dpfx_torch.data.shapenet import (
    SYNSET_IDS,
    _stats_row_subset,
    compute_global_stats_streaming,
    normalize_cloud,
)
from dpfx_torch.data.synthetic import SyntheticDataset


def render_cloud(points: np.ndarray, size: int = 64, view: int = 0) -> np.ndarray:
    """Orthographic depth-shaded render of a cloud -> [size, size, 3] f32.

    Rotates by one of 8 canonical azimuths, projects to the image plane and
    z-buffers by depth (the nearest point of a pixel wins)."""
    theta = view * (2 * np.pi / 8)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    p = points @ rot.T
    p = p / (np.abs(p).max() + 1e-6)       # into the [-1, 1] box
    u = np.clip(((p[:, 0] + 1) * 0.5 * (size - 1)).astype(np.int64), 0, size - 1)
    v = np.clip(((p[:, 1] + 1) * 0.5 * (size - 1)).astype(np.int64), 0, size - 1)
    depth = (p[:, 2] + 1) * 0.5
    img = np.zeros((size, size), np.float32)
    order = np.argsort(depth)  # far to near; near overwrites
    img[v[order], u[order]] = 1.0 - depth[order]
    return np.repeat(img[..., None], 3, axis=-1)


class SyntheticSVRDataset:
    """Paired (render, cloud): item i is the synthetic cloud i, its image
    the render of it from view ``i % 8``."""

    def __init__(self, size: int = 256, n_stored: int = 2048, image_size: int = 64,
                 seed: int = 0, split: str = "train", family: str = "v1",
                 cache: bool = True):
        self.clouds = SyntheticDataset(size=size, n_stored=n_stored, seed=seed,
                                       split=split, family=family)
        self.image_size = image_size
        self.label_names = self.clouds.label_names
        # renders are deterministic in idx: cache the single channel (the
        # 3-channel repeat is cheap); 8192 items at 64x64 f32 are ~134 MB
        self._img_cache: dict | None = {} if cache else None

    def label(self, idx: int) -> int:
        return self.clouds.label(idx)

    def __len__(self) -> int:
        return len(self.clouds)

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.clouds[idx]

    def image(self, idx: int) -> np.ndarray:
        if self._img_cache is not None and idx in self._img_cache:
            one = self._img_cache[idx]
            return np.repeat(one[..., None], 3, axis=-1)
        img = render_cloud(self.clouds[idx], self.image_size, view=idx % 8)
        if self._img_cache is not None:
            self._img_cache[idx] = np.ascontiguousarray(img[..., 0])
        return img


class ShapeNetRenderDataset:
    """ShapeNet clouds with rendered views (the 3D-R2N2-style layout).

    Pairing: cloud ``cloud_root/<synset>/<split>/<model>.npy`` with renders
    ``render_root/<synset>/<model>/rendering/<NN>.png``. Models without a
    render directory are dropped (the public trees are not 1:1)."""

    def __init__(
        self,
        cloud_root: str,
        render_root: str,
        split: str = "train",
        category: str = "airplane",
        normalize: str = "per_shape",
        stats=None,
        image_size: int = 128,
        views_per_model: int = 24,
        norm_stats_max_clouds: int = 0,
        stats_seed: int = 0,
    ):
        try:
            from PIL import Image  # noqa: F401
        except ImportError as e:
            raise ImportError("ShapeNetRenderDataset requires pillow") from e
        self.normalize = normalize
        self.image_size = image_size
        self.views_per_model = views_per_model
        cats = sorted(SYNSET_IDS) if category == "all" else [category]
        self.label_names = dict(enumerate(cats))
        self.items = []
        self.labels = []
        for ci, cat in enumerate(cats):
            syn = SYNSET_IDS.get(cat, cat)
            cdir = os.path.join(cloud_root, syn, split)
            for f in sorted(os.listdir(cdir)) if os.path.isdir(cdir) else []:
                if not f.endswith(".npy"):
                    continue
                model = f[:-4]
                rdir = os.path.join(render_root, syn, model, "rendering")
                if os.path.isdir(rdir):
                    self.items.append((os.path.join(cdir, f), rdir))
                    self.labels.append(ci)
        if not self.items:
            raise FileNotFoundError(
                f"no paired (cloud, render) items under {cloud_root} / {render_root}"
            )
        self.stats = stats
        if normalize == "global" and stats is None:
            # stats from the TRAIN split's clouds with the same category
            # filter: every split normalises in one frame
            if split == "train":
                donor_files = [c for c, _ in self.items]
            else:
                donor_files = [
                    c for c, _ in ShapeNetRenderDataset(
                        cloud_root, render_root, "train", category,
                        normalize="none", image_size=image_size,
                    ).items
                ]
            rows = _stats_row_subset(
                len(donor_files), norm_stats_max_clouds, stats_seed)
            self.stats = compute_global_stats_streaming(
                np.load(donor_files[i]) for i in rows
            )

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> np.ndarray:
        x = np.load(self.items[idx][0]).astype(np.float32)
        return normalize_cloud(x, self.normalize, self.stats)

    def label(self, idx: int) -> int:
        return self.labels[idx]

    def image(self, idx: int, view: Optional[int] = None) -> np.ndarray:
        from PIL import Image

        rdir = self.items[idx][1]
        view = idx % self.views_per_model if view is None else view
        path = os.path.join(rdir, f"{view:02d}.png")
        img = Image.open(path).convert("RGB").resize((self.image_size, self.image_size))
        return np.asarray(img, np.float32) / 255.0
