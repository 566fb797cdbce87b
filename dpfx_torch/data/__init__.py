"""Datasets, host-side batching and the device-resident preloads: the
synthetic clouds, the ShapeNet layouts (an HDF5 file, a PointFlow npy
tree) and the SVR pairs (synthetic renders, ShapeNet renders). ``h5py``
and ``pillow`` are imported only by the datasets that read them."""

from dpfx_torch.data.device import preload_clouds, preload_images
from dpfx_torch.data.loader import (eval_subset, iterate_batches, load_all, load_all_images,
                                    load_all_labels, prefetch_batches, sample_cloud,
                                    stratified_indices)
from dpfx_torch.data.shapenet import (SYNSET_IDS, NormStats, ShapeNetH5, ShapeNetNpyDir,
                                      compute_global_stats, compute_global_stats_streaming,
                                      normalize_cloud)
from dpfx_torch.data.svr import ShapeNetRenderDataset, SyntheticSVRDataset, render_cloud
from dpfx_torch.data.synthetic import SyntheticDataset


def build_dataset(cfg, split: str, image_size: int = 64):
    """Dataset from a DataConfig, as ``dpfx.data.build_dataset``;
    ``image_size`` is the renders' side for the SVR datasets."""
    if cfg.dataset in ("synthetic", "synthetic_svr"):
        sizes = {"train": cfg.synthetic_size, "val": max(cfg.synthetic_size // 4, 8),
                 "test": max(cfg.synthetic_size // 4, 8)}
        if cfg.dataset == "synthetic":
            return SyntheticDataset(size=sizes[split], modes=cfg.synthetic_modes, split=split,
                                    family=cfg.synthetic_family)
        return SyntheticSVRDataset(size=sizes[split], image_size=image_size, split=split,
                                   family=cfg.synthetic_family)
    if cfg.dataset == "shapenet_h5":
        return ShapeNetH5(cfg.path, split=split, category=cfg.category, normalize=cfg.normalize,
                          label_map=cfg.h5_label_map or None,
                          norm_stats_max_clouds=cfg.norm_stats_max_clouds,
                          stats_seed=cfg.norm_stats_seed)
    if cfg.dataset == "shapenet_npy_dir":
        return ShapeNetNpyDir(cfg.path, split=split, category=cfg.category,
                              normalize=cfg.normalize,
                              norm_stats_max_clouds=cfg.norm_stats_max_clouds,
                              stats_seed=cfg.norm_stats_seed)
    if cfg.dataset == "shapenet_svr":
        return ShapeNetRenderDataset(cfg.path, cfg.render_path, split=split,
                                     category=cfg.category, normalize=cfg.normalize,
                                     image_size=image_size, views_per_model=cfg.views_per_model,
                                     norm_stats_max_clouds=cfg.norm_stats_max_clouds,
                                     stats_seed=cfg.norm_stats_seed)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


__all__ = ["SYNSET_IDS", "NormStats", "ShapeNetH5", "ShapeNetNpyDir", "ShapeNetRenderDataset",
           "SyntheticDataset", "SyntheticSVRDataset", "build_dataset", "compute_global_stats",
           "compute_global_stats_streaming", "eval_subset", "iterate_batches", "load_all",
           "load_all_images", "load_all_labels", "normalize_cloud", "prefetch_batches",
           "preload_clouds", "preload_images", "render_cloud", "sample_cloud",
           "stratified_indices"]
