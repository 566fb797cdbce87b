"""Host-side batching, a copy of the single-process part of
``dpfx/data/loader.py``: random per-item subsampling, seeded epoch
permutations, and a background-thread prefetcher. The batches are numpy;
the trainer moves them to the device."""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def sample_cloud(x: np.ndarray, n_points: int, rng: np.random.Generator) -> np.ndarray:
    """Random subsample (without replacement when possible) to n_points."""
    m = x.shape[0]
    if m == n_points:
        return x
    idx = rng.choice(m, size=n_points, replace=m < n_points)
    return x[idx]


def _slot_rng(seed: int, epoch: int, slot: int) -> np.random.Generator:
    """Per-item subsample rng keyed by (loader seed, epoch, epoch slot)."""
    return np.random.default_rng(np.random.SeedSequence((seed, epoch, slot)))


def iterate_batches(dataset, batch_size: int, n_points: int, seed: int = 0,
                    shuffle: bool = True, drop_last: bool = True,
                    epochs: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"x": [B, n_points, 3]} batches, reshuffled every epoch; the
    same batches as ``dpfx.data.iterate_batches`` for the same seed."""
    if drop_last and len(dataset) < batch_size:
        raise ValueError(f"dataset has {len(dataset)} items < batch_size {batch_size} with "
                         "drop_last=True: no batch can ever be produced")
    epoch = 0
    while epochs is None or epoch < epochs:
        rng = np.random.default_rng(seed * 1_000_003 + epoch)
        order = rng.permutation(len(dataset)) if shuffle else np.arange(len(dataset))
        stop = len(order) - (len(order) % batch_size if drop_last else 0)
        for s in range(0, stop, batch_size):
            idx = order[s:s + batch_size]
            yield {"x": np.stack([sample_cloud(dataset[int(i)], n_points,
                                               _slot_rng(seed, epoch, s + j))
                                  for j, i in enumerate(idx)])}
        epoch += 1


def prefetch_batches(batches: Iterator, depth: int = 2) -> Iterator:
    """Run the host-side batch prep on a background thread, keeping up to
    ``depth`` ready batches. Worker exceptions re-raise in the consumer, and
    abandoning the generator stops the worker."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    end = object()

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def worker():
        try:
            for b in batches:
                put(b)
                if stop.is_set():
                    return
        except BaseException as e:  # re-raised on the consumer side
            put(e)
            return
        put(end)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            b = q.get()
            if b is end:
                break
            if isinstance(b, BaseException):
                raise b
            yield b
    finally:
        stop.set()
