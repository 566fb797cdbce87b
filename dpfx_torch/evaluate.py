"""Evaluate a trained model with the PyTorch port.

Usage:
    python -m dpfx_torch.evaluate configs/<exp>.yaml [key=value ...] [--step N]
        [--weights W] [--limit S] [--out results.jsonl] [--impl auto|plain]
        [--device cuda|cpu]

The task follows the config's ``experiment``:
  ae  -> reconstruction CD/EMD on the test split (``recon-cd``, ``recon-emd``)
  gen -> sample |test| clouds, then MMD/COV/1-NNA for each of
         ``eval.metrics`` and JSD
  svr -> not ported yet (the image encoders, ROADMAP Queue 1 #9)

The weights are ``--weights`` (a ``.pt`` state dict or a flattened flax
``.npz``, see ``dpfx_torch.checkpoint``) or else the trainer's
``params_<step>.pt`` under ``train.ckpt_dir/name`` (``--step``, default the
newest). ``--limit`` caps the test set (label-stratified on labelled data).
``--impl auto`` computes CD and EMD with the CUDA kernels on the card (the
plain versions on the CPU); ``--impl plain`` with the plain versions
anywhere. The device defaults to cuda and the run fails without one;
``--device cpu`` runs the plain path. The last line printed is the results
JSON, also appended to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("overrides", nargs="*")
    ap.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    ap.add_argument("--weights", default=None, help="a .pt or .npz weights file (default: the "
                                                    "checkpoint of --step)")
    ap.add_argument("--limit", type=int, default=None, help="cap test-set size")
    ap.add_argument("--impl", default="auto", choices=["auto", "plain"])
    ap.add_argument("--out", default=None, help="append the results JSON to this file")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from dpfx_torch.checkpoint import checkpoint_path, restore_for_eval
    from dpfx_torch.config import load_config
    from dpfx_torch.data import build_dataset, eval_subset, load_all
    from dpfx_torch.metrics import evaluate_generation, evaluate_reconstruction

    # float32 products stay IEEE float32 on the card (the plain paths' contract)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args.config, overrides=args.overrides)
    if cfg.experiment == "svr":
        raise NotImplementedError("SVR evaluation needs the image encoders, not ported yet "
                                  "(ROADMAP Queue 1 #9)")
    if cfg.experiment not in ("ae", "gen"):
        raise ValueError(f"unknown experiment {cfg.experiment!r}")
    if args.weights:
        found = re.fullmatch(r"params_(\d+)\.pt", Path(args.weights).name)
        weights, step = args.weights, args.step if args.step is not None else (
            int(found.group(1)) if found else None)
    else:
        weights, step = checkpoint_path(cfg, args.step)
    model = restore_for_eval(cfg, weights, args.device)
    print(f"[dpfx_torch] evaluating {cfg.experiment} @ step {step} on {model.device}")

    test_ds = build_dataset(cfg.data, "test")
    indices, subset_labels = eval_subset(test_ds, args.limit)
    clouds = load_all(test_ds, cfg.data.n_points_eval, limit=args.limit, indices=indices)
    labels = subset_labels if cfg.data.category == "all" else None
    label_names = getattr(test_ds, "label_names", None)

    timings: dict = {}
    t0 = time.perf_counter()
    if cfg.experiment == "ae":
        results = evaluate_reconstruction(model, clouds, cfg, impl=args.impl, labels=labels,
                                          label_names=label_names)
    else:
        results = evaluate_generation(model, clouds, cfg, impl=args.impl, labels=labels,
                                      label_names=label_names, timings=timings)
    timings["total"] = time.perf_counter() - t0
    print("[dpfx_torch] wall s: " + json.dumps({k: round(v, 4) for k, v in timings.items()}))

    line = json.dumps({"step": step, "n_test": int(clouds.shape[0]), **results})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
