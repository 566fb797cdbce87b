"""The device-resident split (``data.device_resident``), a copy of
``dpfx/data/device.py``'s preloads: the whole training split is uploaded
to the card once, and each step's batch is drawn and gathered there
(``dpfx_torch.train.trainer.resident_draw``), so steady-state training
moves no batch from the host. The flagship's synthetic split at
``data.synthetic_size=8192`` is ~400 MB of float32 (4096 stored points a
cloud). An SVR run preloads its paired render stack too
(``preload_images``): 8192 synthetic renders of 64 x 64 x 3 float32 are
another ~400 MB, gathered with the clouds' index."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np


def _preload(getter: Callable[[int], np.ndarray], n_items: int,
             indices: Optional[Sequence[int]], what: str) -> np.ndarray:
    rows = [int(i) for i in (range(n_items) if indices is None else indices)]
    if not rows:
        raise ValueError("cannot preload an empty dataset")
    first = np.asarray(getter(rows[0]), np.float32)
    out = np.empty((len(rows),) + first.shape, np.float32)
    out[0] = first
    for j, i in enumerate(rows[1:], start=1):
        x = np.asarray(getter(i), np.float32)
        if x.shape != first.shape:
            raise ValueError(f"device-resident preload needs uniform {what} shapes: item {i} is "
                             f"{x.shape}, item {rows[0]} is {first.shape}")
        out[j] = x
    return out


def preload_clouds(dataset, indices: Optional[Sequence[int]] = None) -> np.ndarray:
    """Materialise a dataset as one [S, P, 3] float32 stack.

    Items carry the dataset's normalisation (``__getitem__`` applies it),
    and P is the stored cloud size: the subsample to ``data.n_points``
    happens on the device each step. Raises on an empty selection and on
    ragged stored sizes. ``indices`` selects rows (default: all)."""
    return _preload(dataset.__getitem__, len(dataset), indices, "cloud")


def preload_images(dataset, indices: Optional[Sequence[int]] = None) -> np.ndarray:
    """Materialise a paired SVR dataset's renders as one [S, H, W, C]
    float32 stack (``dataset.image(i)``: the view the host loader feeds
    for item i, so a resident step sees the pairs that
    ``iterate_batches(with_images=True)`` would). Raises on an empty
    selection and on ragged image shapes; ``indices`` as in
    ``preload_clouds``."""
    return _preload(dataset.image, len(dataset), indices, "image")
