#!/usr/bin/env python
"""Export a dpfx (orbax) checkpoint's params for the PyTorch port.

Usage:
    python export_checkpoint_torch.py configs/<exp>.yaml [key=value ...] [--step N] \
        --out weights.npz

Restores the params of the run at ``train.ckpt_dir/name`` (the newest step,
or ``--step``) with ``dpfx.train.restore_for_eval`` and writes them as an
``.npz`` of the flax tree flattened with '/'-joined keys, the layout that
``dpfx_torch.checkpoint`` reads:

    python -m dpfx_torch.generate configs/<exp>.yaml --weights weights.npz

An SVR tree is written without the PointNet encoder, which the port's SVR
model does not have. Needs JAX and orbax; imports no torch.
"""

from __future__ import annotations

import argparse
import shlex
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("overrides", nargs="*", help="dotted.key=value overrides")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--out", required=True, help="the .npz to write")
    args = ap.parse_args(argv)

    import numpy as np
    from flax.traverse_util import flatten_dict

    from dpfx.config import load_config
    from dpfx.train import restore_for_eval

    cfg = load_config(args.config, overrides=args.overrides)
    _, params, step = restore_for_eval(cfg, args.step)
    tree = dict(params)
    if set(tree) == {"params"}:
        tree = dict(tree["params"])
    if cfg.experiment == "svr":
        tree.pop("encoder", None)
    flat = {k: np.asarray(v, np.float32) for k, v in flatten_dict(tree, sep="/").items()}
    out = args.out if args.out.endswith(".npz") else args.out + ".npz"
    np.savez(out, **flat)
    print(f"[dpfx] exported step {step} of {cfg.name} ({len(flat)} arrays) -> {out}")
    cmd = ["python", "-m", "dpfx_torch.generate", args.config, *args.overrides, "--weights", out]
    print(f"[dpfx] sample with: {' '.join(map(shlex.quote, cmd))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
