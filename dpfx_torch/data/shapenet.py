"""ShapeNet point-cloud datasets, a copy of ``dpfx/data/shapenet.py``
(numpy only; ``h5py`` is imported inside ``ShapeNetH5`` alone, so the
package imports without it). Two layouts:

  * ``shapenet_h5``      -- one HDF5 file (or a file per category) with
                            ``<split>`` datasets (or ``<split>/data``), each
                            ``[S, N_stored, 3]`` float32, optionally with
                            ``<split>_labels`` category ids;
  * ``shapenet_npy_dir`` -- the PointFlow tree
                            ``root/<synset_id>/<split>/<model>.npy``.

``DataConfig.normalize`` picks the frame: ``per_shape`` (each cloud centred
at its mean and divided by its largest radius), ``global`` (the train
split's per-axis mean and one overall std, whatever split is served) or
``none``.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional

import numpy as np

# ShapeNetCore.v2 synset ids for the categories in the paper tables plus the
# common PointFlow-lineage set.
SYNSET_IDS: Dict[str, str] = {
    "airplane": "02691156",
    "bag": "02773838",
    "basket": "02801938",
    "bathtub": "02808440",
    "bed": "02818832",
    "bench": "02828884",
    "bottle": "02876657",
    "bowl": "02880940",
    "bus": "02924116",
    "cabinet": "02933112",
    "can": "02946921",
    "camera": "02942699",
    "cap": "02954340",
    "car": "02958343",
    "chair": "03001627",
    "clock": "03046257",
    "dishwasher": "03207941",
    "monitor": "03211117",
    "table": "04379243",
    "telephone": "04401088",
    "tower": "04460130",
    "train": "04468005",
    "keyboard": "03085013",
    "earphone": "03261776",
    "faucet": "03325088",
    "file": "03337140",
    "guitar": "03467517",
    "helmet": "03513137",
    "jar": "03593526",
    "knife": "03624134",
    "lamp": "03636649",
    "laptop": "03642806",
    "speaker": "03691459",
    "mailbox": "03710193",
    "microphone": "03759954",
    "microwave": "03761084",
    "motorcycle": "03790512",
    "mug": "03797390",
    "piano": "03928116",
    "pillow": "03938244",
    "pistol": "03948459",
    "pot": "03991062",
    "printer": "04004475",
    "remote_control": "04074963",
    "rifle": "04090263",
    "rocket": "04099429",
    "skateboard": "04225987",
    "sofa": "04256520",
    "stove": "04330267",
    "vessel": "04530566",
    "washer": "04554684",
    "boat": "02858304",
    "cellphone": "02992529",
}


class NormStats:
    """Train-split normalization statistics for the ``global`` mode."""

    def __init__(self, mean: np.ndarray, scale: float):
        self.mean = mean.astype(np.float32)
        self.scale = float(scale)


def normalize_cloud(
    x: np.ndarray, mode: str, stats: Optional[NormStats] = None
) -> np.ndarray:
    if mode == "none":
        return x
    if mode == "per_shape":
        c = x - x.mean(axis=0, keepdims=True)
        r = np.max(np.linalg.norm(c, axis=1))
        return (c / max(r, 1e-9)).astype(np.float32)
    if mode == "global":
        if stats is None:
            raise ValueError("global normalization requires NormStats")
        return ((x - stats.mean) / stats.scale).astype(np.float32)
    raise ValueError(f"unknown normalization mode {mode!r}")


def compute_global_stats(clouds: np.ndarray) -> NormStats:
    """clouds: [S, N, 3] train split. PointFlow-style frame: per-axis mean,
    one scalar std over all coordinates."""
    pts = clouds.reshape(-1, 3)
    mean = pts.mean(axis=0)
    scale = pts.std()
    return NormStats(mean, scale)


def compute_global_stats_streaming(cloud_iter) -> NormStats:
    """Same statistics as :func:`compute_global_stats` but streamed over an
    iterator of ``[N, 3]`` clouds, so the FULL train split can be used
    without materializing it (the PointFlow convention computes stats over
    the whole split — a prefix subsample biases the normalization frame)."""
    sum3 = np.zeros(3, np.float64)
    se = 0.0   # sum of all coordinates
    sse = 0.0  # sum of squared coordinates
    n_pts = 0
    for x in cloud_iter:
        x = np.asarray(x, dtype=np.float64).reshape(-1, 3)
        sum3 += x.sum(axis=0)
        se += float(x.sum())
        sse += float((x * x).sum())
        n_pts += x.shape[0]
    if n_pts == 0:
        raise ValueError("no clouds to compute normalization stats from")
    ne = 3.0 * n_pts
    mean_all = se / ne
    var = max(sse / ne - mean_all * mean_all, 0.0)
    return NormStats((sum3 / n_pts).astype(np.float32), float(np.sqrt(var)))


def _stats_row_subset(n_rows: int, max_clouds: int, seed: int = 0) -> np.ndarray:
    """Row indices for normalization stats: the full split when
    ``max_clouds`` <= 0, else a seeded random subsample (never a silent
    prefix)."""
    if max_clouds <= 0 or n_rows <= max_clouds:
        return np.arange(n_rows)
    rows = np.random.default_rng(seed).choice(n_rows, size=max_clouds, replace=False)
    rows.sort()
    warnings.warn(
        f"dpfx_torch.data: global normalization stats from a seeded random "
        f"subsample of {max_clouds}/{n_rows} train clouds "
        f"(data.norm_stats_max_clouds); set 0 for the full split",
        stacklevel=3,
    )
    return rows


class ShapeNetH5:
    """HDF5-backed dataset. Accepts either a single file containing all
    categories (+ label datasets) or a per-category file; split datasets may
    be named ``train``/``val``/``test`` directly or nested as
    ``<split>/data`` groups. Clouds load lazily per item."""

    #: H5 dataset/attr names probed for the label-id -> category-name table
    _LABEL_TABLE_NAMES = ("label_names", "categories", "cat_names", "classes")

    def __init__(
        self,
        path: str,
        split: str = "train",
        category: str = "all",
        normalize: str = "per_shape",
        stats: Optional[NormStats] = None,
        label_map: Optional[Dict[str, int]] = None,
        norm_stats_max_clouds: int = 0,
        stats_seed: int = 0,
    ):
        import h5py  # deferred so the module imports without h5 data

        self.path = path
        self.split = split
        self.normalize = normalize
        self._h5 = h5py.File(path, "r")
        node = self._h5
        if split in node:
            node = node[split]
        elif f"{split}_data" in node:
            node = node[f"{split}_data"]
        else:
            raise KeyError(f"no split {split!r} in {path} (keys: {list(node.keys())})")
        self._data = node["data"] if hasattr(node, "keys") and "data" in node else node
        self._labels = None
        for lname in (f"{split}_labels", "labels", "label"):
            if lname in self._h5:
                self._labels = self._h5[lname]
                break
        self._indices = np.arange(self._data.shape[0])
        if category != "all" and self._labels is None:
            # no labels at all: a per-category file (the common single-class
            # layout); nothing to filter, but say so
            warnings.warn(
                f"dpfx_torch.data: {path} has no label dataset; serving all "
                f"{self._data.shape[0]} clouds as category={category!r} "
                f"(per-category file assumed)",
                stacklevel=2,
            )
        elif category != "all":
            # label-id semantics are file-specific; never guess (an
            # alphabetical-SYNSET_IDS-index assumption silently
            # selects the wrong category on any other convention)
            lm = label_map if label_map else self._label_map_from_file()
            if lm is None:
                raise ValueError(
                    f"category={category!r} requested but no label->category "
                    f"mapping exists: {path} carries none of "
                    f"{self._LABEL_TABLE_NAMES} (dataset or file attr) and no "
                    f"data.h5_label_map was configured"
                )
            if category not in lm:
                raise KeyError(
                    f"category {category!r} not in label map (known: {sorted(lm)})"
                )
            self._indices = np.nonzero(
                np.asarray(self._labels[:]) == int(lm[category])
            )[0]
        # id -> category-name table for per-category eval reporting, from
        # the explicit map or the file's own table when either exists
        lm_any = label_map if label_map else self._label_map_from_file()
        self.label_names = {v: k for k, v in lm_any.items()} if lm_any else None
        self.stats = stats
        if normalize == "global" and stats is None:
            # global stats come from the TRAIN split with the same category
            # filter, whatever split this instance serves — train and eval
            # must share one normalization frame
            if split == "train":
                donor = self
            else:
                donor = ShapeNetH5(
                    path, "train", category, normalize="none",
                    label_map=label_map,
                )
            try:
                rows = donor._indices[
                    _stats_row_subset(
                        len(donor._indices), norm_stats_max_clouds, stats_seed)
                ]
                self.stats = compute_global_stats_streaming(
                    np.asarray(donor._data[i]) for i in rows
                )
            finally:
                if donor is not self:
                    # the stats donor held its own h5 handle; don't leak it
                    donor.close()

    def _label_map_from_file(self) -> Optional[Dict[str, int]]:
        """category name -> label id, read from the file itself: a string
        table (dataset or file attribute) whose index IS the label id.
        Synset ids in the table are translated to category names."""
        syn_to_name = {v: k for k, v in SYNSET_IDS.items()}
        for name in self._LABEL_TABLE_NAMES:
            table = None
            if name in self._h5:
                table = self._h5[name][:]
            elif name in self._h5.attrs:
                table = self._h5.attrs[name]
            if table is None:
                continue
            out: Dict[str, int] = {}
            for i, raw in enumerate(np.asarray(table).tolist()):
                s = raw.decode() if isinstance(raw, bytes) else str(raw)
                out[syn_to_name.get(s, s)] = i
            return out
        return None

    def __len__(self) -> int:
        return len(self._indices)

    def __getitem__(self, idx: int) -> np.ndarray:
        x = np.asarray(self._data[self._indices[idx]], dtype=np.float32)
        return normalize_cloud(x, self.normalize, self.stats)

    def label(self, idx: int) -> int:
        if self._labels is None:
            return 0
        return int(self._labels[self._indices[idx]])

    def close(self) -> None:
        """Release the underlying h5py handle. Idempotent; reading after
        close raises (h5py's closed-file error)."""
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None
            self._data = None
            self._labels = None

    def __enter__(self) -> "ShapeNetH5":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ShapeNetNpyDir:
    """PointFlow-style ``root/<synset>/<split>/<model>.npy`` tree."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        category: str = "airplane",
        normalize: str = "per_shape",
        stats: Optional[NormStats] = None,
        norm_stats_max_clouds: int = 0,
        stats_seed: int = 0,
    ):
        self.normalize = normalize
        cats = sorted(SYNSET_IDS) if category == "all" else [category]
        self.label_names = dict(enumerate(cats))  # per-category eval reporting
        self.files: List[str] = []
        self.labels: List[int] = []
        for ci, cat in enumerate(cats):
            syn = SYNSET_IDS.get(cat, cat)
            d = os.path.join(root, syn, split)
            if not os.path.isdir(d):
                continue
            for f in sorted(os.listdir(d)):
                if f.endswith(".npy"):
                    self.files.append(os.path.join(d, f))
                    self.labels.append(ci)
        if not self.files:
            raise FileNotFoundError(f"no .npy clouds under {root} for {category}/{split}")
        self.stats = stats
        if normalize == "global" and stats is None:
            # stats always from the train split (same category), so every
            # split normalizes in the same frame; full split by default
            if split == "train":
                donor_files = self.files
            else:
                donor_files = ShapeNetNpyDir(
                    root, "train", category, normalize="none"
                ).files
            rows = _stats_row_subset(
                len(donor_files), norm_stats_max_clouds, stats_seed
            )
            self.stats = compute_global_stats_streaming(
                np.load(donor_files[i]) for i in rows
            )

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        x = np.load(self.files[idx]).astype(np.float32)
        return normalize_cloud(x, self.normalize, self.stats)

    def label(self, idx: int) -> int:
        return self.labels[idx]
