"""Sample point clouds from a trained model with the PyTorch port.

Usage:
    python -m dpfx_torch.generate configs/<exp>.yaml [key=value ...] --weights W \\
        [--n-clouds 64] [--n-points 2048] [--out samples.npy] [--seed 0] \\
        [--temperature T] [--latent-temperature T] [--device cuda|cpu]

``--weights`` is a ``.pt`` state dict written by the port or a flattened
flax ``.npz`` (see ``dpfx_torch.checkpoint``). The device defaults to cuda
and the run fails without one; ``--device cpu`` runs the plain path.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("overrides", nargs="*")
    ap.add_argument("--weights", required=True)
    ap.add_argument("--n-clouds", type=int, default=64)
    ap.add_argument("--n-points", type=int, default=None)
    ap.add_argument("--out", default="samples.npy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--png", default=None, help="not available in the port yet")
    ap.add_argument("--temperature", type=float, default=None,
                    help="point base-noise scale (default: eval.temperature)")
    ap.add_argument("--latent-temperature", type=float, default=None,
                    help="latent base-noise scale (default: eval.latent_temperature)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.png:
        ap.error("--png is not ported yet; save the .npy and render it with generate.py's montage")

    import numpy as np
    import torch

    from dpfx_torch.checkpoint import restore_for_eval
    from dpfx_torch.config import load_config
    from dpfx_torch.sampling import make_sampler

    cfg = load_config(args.config, overrides=args.overrides)
    model = restore_for_eval(cfg, args.weights, args.device)
    n_points = args.n_points or cfg.data.n_points_eval
    temp = cfg.eval.temperature if args.temperature is None else args.temperature
    ltemp = (cfg.eval.latent_temperature if args.latent_temperature is None
             else args.latent_temperature)
    sampler = make_sampler(model, args.n_clouds, n_points, temperature=temp,
                           latent_temperature=ltemp)
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    sampler(args.seed)  # warm-up: builds and loads the kernels on first use
    sync()
    t0 = time.perf_counter()
    clouds = sampler(args.seed)
    sync()
    dt = time.perf_counter() - t0
    clouds = clouds.cpu().numpy()
    np.save(args.out, clouds)
    print(f"[dpfx_torch] sampled {clouds.shape} on {model.device} in {dt * 1e3:.1f}ms "
          f"({args.n_clouds / dt:,.1f} clouds/s, {args.n_clouds * n_points / dt:,.0f} pts/s) "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
