"""The device-resident split (``data.device_resident``), a copy of
``dpfx/data/device.py``'s cloud preload: the whole training split is
uploaded to the card once, and each step's batch is drawn and gathered
there (``dpfx_torch.train.trainer.resident_draw``), so steady-state training
moves no batch from the host. The flagship's synthetic split at
``data.synthetic_size=8192`` is ~400 MB of float32 (4096 stored points a
cloud). The SVR render stack (``preload_images``) waits for the SVR
datasets (ROADMAP Queue 1)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def preload_clouds(dataset, indices: Optional[Sequence[int]] = None) -> np.ndarray:
    """Materialise a dataset as one [S, P, 3] float32 stack.

    Items carry the dataset's normalisation (``__getitem__`` applies it),
    and P is the stored cloud size: the subsample to ``data.n_points``
    happens on the device each step. Raises on an empty selection and on
    ragged stored sizes. ``indices`` selects rows (default: all)."""
    rows = [int(i) for i in (range(len(dataset)) if indices is None else indices)]
    if not rows:
        raise ValueError("cannot preload an empty dataset")
    first = np.asarray(dataset[rows[0]], np.float32)
    out = np.empty((len(rows),) + first.shape, np.float32)
    out[0] = first
    for j, i in enumerate(rows[1:], start=1):
        x = np.asarray(dataset[i], np.float32)
        if x.shape != first.shape:
            raise ValueError(f"device-resident preload needs uniform cloud shapes: item {i} is "
                             f"{x.shape}, item {rows[0]} is {first.shape}")
        out[j] = x
    return out
