"""Pack a dataset into one float32 ``.npy`` cloud stack [S, N_stored, 3]
for the native loader (``dpfx_torch.native.NativeBatcher``), with a sidecar
``<out>.meta.json`` that records the normalization already applied.

    python -m dpfx_torch.tools.pack_dataset CONFIG [key=value ...] --split train \\
        --out packed.npy [--n-stored 4096]

Each cloud is subsampled to ``--n-stored`` points with one
``numpy.random.default_rng(0)`` drawn in dataset order, so the stack and
its sidecar equal those of the JAX package's ``tools/pack_dataset.py``.
Train on it with ``python -m dpfx_torch.train CONFIG data.packed_path=<out>``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("overrides", nargs="*", help="dotted.key=value overrides")
    ap.add_argument("--split", default="train")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-stored", type=int, default=4096)
    args = ap.parse_args(argv)

    import numpy as np

    from dpfx_torch.config import load_config
    from dpfx_torch.data import build_dataset, sample_cloud

    t0 = time.perf_counter()
    cfg = load_config(args.config, overrides=args.overrides)
    ds = build_dataset(cfg.data, args.split)
    rng = np.random.default_rng(0)
    stack = np.stack([sample_cloud(ds[i], args.n_stored, rng)
                      for i in range(len(ds))]).astype(np.float32)
    np.save(args.out, stack)
    out_npy = args.out if args.out.endswith(".npy") else args.out + ".npy"
    with open(out_npy + ".meta.json", "w") as f:
        json.dump({"normalize_applied": cfg.data.normalize, "dataset": cfg.data.dataset,
                   "category": cfg.data.category, "split": args.split,
                   "n_stored": args.n_stored}, f)
    print(f"[dpfx_torch] packed {stack.shape} ({stack.nbytes / 1e6:.1f} MB) in "
          f"{time.perf_counter() - t0:.2f} s -> {out_npy}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
