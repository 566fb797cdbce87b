"""Datasets, host-side batching and the device-resident preload. Only the
synthetic dataset is ported; ShapeNet (h5, npy directory) and the SVR
datasets are ROADMAP Queue 1 items."""

from dpfx_torch.data.device import preload_clouds
from dpfx_torch.data.loader import (eval_subset, iterate_batches, load_all, load_all_labels,
                                    prefetch_batches, sample_cloud, stratified_indices)
from dpfx_torch.data.synthetic import SyntheticDataset


def build_dataset(cfg, split: str):
    """Dataset from a DataConfig (``dataset: synthetic`` only)."""
    if cfg.dataset == "synthetic":
        sizes = {"train": cfg.synthetic_size, "val": max(cfg.synthetic_size // 4, 8),
                 "test": max(cfg.synthetic_size // 4, 8)}
        return SyntheticDataset(size=sizes[split], modes=cfg.synthetic_modes, split=split,
                                family=cfg.synthetic_family)
    raise NotImplementedError(f"data.dataset={cfg.dataset!r} is not ported yet: the port reads "
                              "only 'synthetic' (ShapeNet and SVR datasets: ROADMAP Queue 1)")


__all__ = ["SyntheticDataset", "build_dataset", "eval_subset", "iterate_batches", "load_all",
           "load_all_labels", "prefetch_batches", "preload_clouds", "sample_cloud",
           "stratified_indices"]
