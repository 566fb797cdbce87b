"""Host-side batching, a copy of ``dpfx/data/loader.py``: random per-item
subsampling, seeded epoch permutations (and a rank's rows of each batch,
``batch_shard``), a background-thread prefetcher, and the eval-split helpers
(label-stratified subsets, whole-split materialisation, the paired
renders of an SVR dataset). The batches are numpy; the trainer and the
evaluators move them to the device."""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

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
                    epochs: Optional[int] = None, with_images: bool = False,
                    batch_shard: Optional[Tuple[int, int]] = None
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"x": [B, n_points, 3]} batches, plus "image" [B, H, W, 3]
    with ``with_images`` on a dataset that has images (SVR), reshuffled
    every epoch; the same batches as ``dpfx.data.iterate_batches`` for the
    same seed.

    ``batch_shard=(start, stop)`` is the data-parallel mode: every rank
    walks the same epoch permutation but loads only rows [start, stop) of
    each global batch (``dpfx_torch.parallel.process_local_rows``), each
    item subsampled by the rng of its global slot, so the ranks' rows
    concatenate to the one-process batch bit for bit. It requires
    ``drop_last=True`` (a ragged tail would desynchronise the ranks) and
    raises on an empty slice."""
    if drop_last and len(dataset) < batch_size:
        raise ValueError(f"dataset has {len(dataset)} items < batch_size {batch_size} with "
                         "drop_last=True: no batch can ever be produced")
    if batch_shard is not None and not drop_last:
        raise ValueError("batch_shard (a rank's rows of each batch) requires drop_last=True: a "
                         "ragged tail batch desynchronises the ranks")
    epoch = 0
    while epochs is None or epoch < epochs:
        rng = np.random.default_rng(seed * 1_000_003 + epoch)
        order = rng.permutation(len(dataset)) if shuffle else np.arange(len(dataset))
        stop = len(order) - (len(order) % batch_size if drop_last else 0)
        for s in range(0, stop, batch_size):
            idx = order[s:s + batch_size]
            slots = np.arange(s, s + len(idx))
            if batch_shard is not None:
                lo, hi = batch_shard
                idx, slots = idx[lo:hi], slots[lo:hi]
                if idx.size == 0:
                    raise RuntimeError("batch_shard slice is empty: batch_size is smaller than "
                                       "this rank's padded row count")
            batch = {"x": np.stack([sample_cloud(dataset[int(i)], n_points,
                                                 _slot_rng(seed, epoch, int(j)))
                                    for i, j in zip(idx, slots)])}
            if with_images and hasattr(dataset, "image"):
                batch["image"] = np.stack([dataset.image(int(i)) for i in idx])
            yield batch
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


def _subset_rows(dataset, limit: Optional[int], indices: Optional[np.ndarray]) -> np.ndarray:
    if indices is not None:
        return np.asarray(indices, np.int64)
    count = len(dataset) if limit is None else min(limit, len(dataset))
    return np.arange(count)


def stratified_indices(labels: np.ndarray, limit: int, seed: int = 0) -> np.ndarray:
    """Seeded, label-proportional row subset (sorted): a prefix limit on a
    dataset grouped by category would turn an all-category eval into a
    one-category one."""
    labels = np.asarray(labels)
    if limit >= labels.shape[0]:
        return np.arange(labels.shape[0])
    rng = np.random.default_rng(seed)
    cats, counts = np.unique(labels, return_counts=True)
    take = np.maximum((counts * limit / labels.shape[0]).astype(np.int64), 1)
    while take.sum() > limit:  # rounding overflow: trim the largest classes
        take[np.argmax(take)] -= 1
    while take.sum() < limit:
        take[np.argmin(take / counts)] += 1
    picked = []
    for c, t in zip(cats, take):
        rows = np.flatnonzero(labels == c)
        picked.append(rng.choice(rows, size=min(t, rows.size), replace=False))
    return np.sort(np.concatenate(picked))


def eval_subset(dataset, limit: Optional[int], seed: int = 0):
    """``(indices, labels)``: a label-stratified subset when the dataset is
    labelled, multi-class and ``limit`` caps it (``indices`` None otherwise:
    callers take the prefix ``limit``), and the labels of the resulting rows
    (None for a label-less dataset)."""
    labels_all = load_all_labels(dataset)
    if labels_all is None:
        return None, None
    if limit is not None and limit < len(dataset) and len(np.unique(labels_all)) > 1:
        indices = stratified_indices(labels_all, limit, seed)
        return indices, labels_all[indices]
    count = len(dataset) if limit is None else min(limit, len(dataset))
    return None, labels_all[:count]


def load_all(dataset, n_points: int, seed: int = 0, limit: Optional[int] = None,
             indices: Optional[np.ndarray] = None) -> np.ndarray:
    """A whole split as [S, n_points, 3]; ``indices`` overrides the prefix
    ``limit``."""
    rng = np.random.default_rng(seed)
    rows = _subset_rows(dataset, limit, indices)
    return np.stack([sample_cloud(dataset[int(i)], n_points, rng) for i in rows])


def load_all_labels(dataset, limit: Optional[int] = None,
                    indices: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """Category ids aligned with load_all's rows, or None for a label-less
    dataset."""
    if not hasattr(dataset, "label"):
        return None
    rows = _subset_rows(dataset, limit, indices)
    return np.array([dataset.label(int(i)) for i in rows], np.int32)


def load_all_images(dataset, limit: Optional[int] = None,
                    indices: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """The paired renders [S, H, W, 3] aligned with load_all's rows (SVR
    evaluation), or None for a dataset without images."""
    if not hasattr(dataset, "image"):
        return None
    rows = _subset_rows(dataset, limit, indices)
    return np.stack([dataset.image(int(i)) for i in rows])
