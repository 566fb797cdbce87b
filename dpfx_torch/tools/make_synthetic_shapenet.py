"""Write the synthetic family as a ShapeNet-layout tree, optionally with
renders, or as one HDF5 file (the counterpart of the JAX package's
``tools/make_synthetic_shapenet.py``; the same arguments and files).

    python -m dpfx_torch.tools.make_synthetic_shapenet ROOT [--train 8192]
        [--valtest 2048] [--points 4096] [--family v2] [--renders RENDER_ROOT]
        [--views 8] [--imgsize 137] [--h5]

* The npy tree (``shapenet_npy_dir``): ``ROOT/<synset>/<split>/<model>.npy``,
  each model ``model_<split>_<i:06d>``, each shape kind of the family under
  one real synset id (airplane, chair, car, table, lamp), so that
  ``category: all`` per-category tables work.
* ``--renders RENDER_ROOT`` (npy mode): a 3D-R2N2-layout render tree
  (``shapenet_svr``), ``RENDER_ROOT/<synset>/<model>/rendering/<NN>.png``,
  ``--views`` depth-shaded views a model of the same cloud
  (``render_cloud``), ``--imgsize`` pixels a side. Needs pillow.
* ``--h5``: ROOT is one HDF5 file (``shapenet_h5``): ``<split>`` [S, N, 3],
  ``<split>_labels`` and the ``label_names`` synset table. Needs h5py.

The clouds are the port's ``SyntheticDataset`` items (deterministic in the
split and the index), so the files equal the JAX tool's byte for byte.
``h5py`` and ``PIL`` are imported only where they are needed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# one real synset per shape kind: per-kind trees, reference-shaped
KIND_TO_CATEGORY = ["airplane", "chair", "car", "table", "lamp"]
SPLITS = ("train", "val", "test")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("root", help="npy-dir tree root, or the .h5 path with --h5")
    ap.add_argument("--train", type=int, default=8192)
    ap.add_argument("--valtest", type=int, default=2048)
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--family", default="v2")
    ap.add_argument("--renders", default="",
                    help="also write a 3D-R2N2-layout render tree here (npy-dir mode only): "
                         "<renders>/<synset>/<model>/rendering/<NN>.png")
    ap.add_argument("--views", type=int, default=8,
                    help="renders per model (reference trees ship 24)")
    ap.add_argument("--imgsize", type=int, default=137,
                    help="render PNG size (3D-R2N2 ships 137x137)")
    ap.add_argument("--h5", action="store_true",
                    help="write ONE HDF5 file (<split> [S,N,3], <split>_labels, label_names) "
                         "instead of the npy-dir tree")
    args = ap.parse_args(argv)

    from dpfx_torch.data.shapenet import SYNSET_IDS
    from dpfx_torch.data.synthetic import SyntheticDataset

    sizes = {"train": args.train, "val": args.valtest, "test": args.valtest}

    def dataset(split):
        return SyntheticDataset(size=sizes[split], n_stored=args.points, family=args.family,
                                split=split, cache=False)

    if args.h5:
        import h5py

        with h5py.File(args.root, "w") as f:
            for split in SPLITS:
                ds = dataset(split)
                data = np.stack([ds[i] for i in range(len(ds))])
                labels = np.array([ds.label(i) % len(KIND_TO_CATEGORY) for i in range(len(ds))],
                                  np.int64)
                f.create_dataset(split, data=data)
                f.create_dataset(f"{split}_labels", data=labels)
                print(f"[make_synthetic_shapenet] {split}: {data.shape} -> {args.root}")
            # label id -> synset id; the loader translates synsets to category names
            f.create_dataset("label_names", data=np.array(
                [SYNSET_IDS[c].encode() for c in KIND_TO_CATEGORY]))
        return 0

    if args.renders:
        from PIL import Image

        from dpfx_torch.data.svr import render_cloud

    for split in SPLITS:
        ds = dataset(split)
        for i in range(len(ds)):
            syn = SYNSET_IDS[KIND_TO_CATEGORY[ds.label(i) % len(KIND_TO_CATEGORY)]]
            d = os.path.join(args.root, syn, split)
            os.makedirs(d, exist_ok=True)
            # the render tree has no split level: the split goes into the model id
            model = f"model_{split}_{i:06d}"
            cloud = ds[i]
            np.save(os.path.join(d, f"{model}.npy"), cloud)
            if args.renders:
                rdir = os.path.join(args.renders, syn, model, "rendering")
                os.makedirs(rdir, exist_ok=True)
                for v in range(args.views):
                    img = render_cloud(cloud, size=args.imgsize, view=v)
                    Image.fromarray((img * 255).astype(np.uint8)).save(
                        os.path.join(rdir, f"{v:02d}.png"))
        print(f"[make_synthetic_shapenet] {split}: {len(ds)} clouds x {args.points} pts over "
              f"{len(ds.label_names)} kinds -> {args.root}"
              + (f" (+{args.views} views/model -> {args.renders})" if args.renders else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
