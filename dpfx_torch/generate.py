"""Sample point clouds from a trained model with the PyTorch port.

Usage:
    python -m dpfx_torch.generate configs/<exp>.yaml [key=value ...] [--weights W | --step N] \\
        [--n-clouds 64] [--n-points 2048] [--out samples.npy] [--seed 0] \\
        [--png montage.png] [--temperature T] [--latent-temperature T] [--device cuda|cpu]

``--weights`` is a ``.pt`` state dict written by the port (by its trainer,
or by ``python -m dpfx_torch.convert_checkpoint`` from a reference-layout
checkpoint) or a flattened flax ``.npz`` (``export_checkpoint_torch.py``;
see ``dpfx_torch.checkpoint``). Without it the run's checkpoint is read, as
the JAX package's ``generate.py`` does: ``params_<step>.pt`` under
``train.ckpt_dir/name`` (``checkpoint_path``), the newest step or ``--step``. ``--png`` also writes a montage of the
first 16 clouds from 3 views (needs pillow). The device defaults to cuda
and the run fails without one; ``--device cpu`` runs the plain path. Under
torchrun (or ``parallel.coordinator``, see ``dpfx_torch.parallel``) each
process is a rank, the clouds are sampled across the ranks
(``make_sampler(group=...)``: ``--n-clouds`` a multiple of them), and rank 0
alone writes and prints.
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
    ap.add_argument("--weights", default=None, help="a .pt or .npz weights file (default: the "
                                                    "run's checkpoint of --step)")
    ap.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    ap.add_argument("--n-clouds", type=int, default=64)
    ap.add_argument("--n-points", type=int, default=None)
    ap.add_argument("--out", default="samples.npy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--png", default=None, help="also save a render montage PNG")
    ap.add_argument("--temperature", type=float, default=None,
                    help="point base-noise scale (default: eval.temperature)")
    ap.add_argument("--latent-temperature", type=float, default=None,
                    help="latent base-noise scale (default: eval.latent_temperature)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from dpfx_torch.config import load_config
    from dpfx_torch.parallel import init_from_config

    cfg = load_config(args.config, overrides=args.overrides)
    group, device = init_from_config(cfg.parallel, args.device)
    try:
        return _generate(args, cfg, group, device)
    finally:
        if group is not None:
            dist.destroy_process_group()


def _generate(args, cfg, group, device) -> int:
    import numpy as np
    import torch

    from dpfx_torch.checkpoint import checkpoint_path, restore_for_eval
    from dpfx_torch.parallel import is_coordinator
    from dpfx_torch.sampling import make_sampler

    weights, step = ((args.weights, None) if args.weights
                     else checkpoint_path(cfg, args.step))
    model = restore_for_eval(cfg, weights, device)
    n_points = args.n_points or cfg.data.n_points_eval
    temp = cfg.eval.temperature if args.temperature is None else args.temperature
    ltemp = (cfg.eval.latent_temperature if args.latent_temperature is None
             else args.latent_temperature)
    sampler = make_sampler(model, args.n_clouds, n_points, temperature=temp,
                           latent_temperature=ltemp, group=group)
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    sampler(args.seed)  # warm-up: builds and loads the kernels on first use
    sync()
    t0 = time.perf_counter()
    clouds = sampler(args.seed)
    sync()
    dt = time.perf_counter() - t0
    if not is_coordinator(group):
        return 0
    clouds = clouds.cpu().numpy()
    np.save(args.out, clouds)
    if args.png:
        from dpfx_torch.utils.viz import save_cloud_montage

        saved = save_cloud_montage(clouds, args.png)
        print(f"[dpfx_torch] montage -> {saved or 'skipped (no PIL)'}")
    src = "" if step is None else f" from step-{step} checkpoint"
    print(f"[dpfx_torch] sampled {clouds.shape}{src} on {model.device} in {dt * 1e3:.1f}ms "
          f"({args.n_clouds / dt:,.1f} clouds/s, {args.n_clouds * n_points / dt:,.0f} pts/s) "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
