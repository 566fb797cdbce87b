"""Sample montages, a copy of ``dpfx/utils/viz.py``: depth-shaded
orthographic renders (``dpfx_torch.data.render_cloud``, the SVR
rasterizer) in a grid PNG. Pillow is imported where it is used."""

from __future__ import annotations

from typing import Optional

import numpy as np


def save_cloud_montage(clouds: np.ndarray, path: str, views: int = 3, tile: int = 128,
                       max_clouds: int = 16) -> Optional[str]:
    """clouds [S, N, 3] -> a PNG grid (a row per cloud, a column per
    azimuth view, tiles of ``tile`` pixels). Returns the path, or None
    where pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None

    from dpfx_torch.data.svr import render_cloud

    rows = [np.concatenate([render_cloud(c, size=tile, view=v * (8 // views))
                            for v in range(views)], axis=1)
            for c in np.asarray(clouds)[:max_clouds]]
    img8 = (np.clip(np.concatenate(rows, axis=0), 0, 1) * 255).astype(np.uint8)
    Image.fromarray(img8).save(path)
    return path
