"""Train a DPF model from a YAML config with the PyTorch port.

Usage:
    python -m dpfx_torch.train configs/<exp>.yaml [key=value ...] [--device cuda|cpu]

The device defaults to cuda and the run fails without one; ``--device cpu``
runs the plain path. Params-only checkpoints (``params_<step>.pt``) and
``metrics.jsonl`` go to ``train.ckpt_dir/name``; sample a checkpoint with
``python -m dpfx_torch.generate CONFIG --weights <ckpt>.pt``. Not ported
yet: resume, evaluation during training, and the datasets other than
``synthetic``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", help="YAML experiment config")
    ap.add_argument("overrides", nargs="*", help="dotted.key=value overrides")
    ap.add_argument("--strict-config", action="store_true", help="reject unknown YAML keys")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from dpfx_torch.config import load_config
    from dpfx_torch.data import build_dataset, iterate_batches, prefetch_batches
    from dpfx_torch.train import Trainer

    # float32 products stay IEEE float32 on the card (the plain paths' contract)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args.config, strict=args.strict_config, overrides=args.overrides)
    if cfg.experiment == "svr":
        raise NotImplementedError("SVR training is not ported yet (ROADMAP Queue 1 #9)")
    ignored = [k for k, on in (("data.device_resident", cfg.data.device_resident),
                               ("train.steps_per_call", cfg.train.steps_per_call > 1)) if on]
    if ignored:
        print(f"[dpfx_torch] {', '.join(ignored)}: TPU-build knobs, accepted and ignored "
              "(host batches, one step per call)")
    train_ds = build_dataset(cfg.data, "train")
    if cfg.train.epochs > 0:
        cfg.train.steps = cfg.train.epochs * max(len(train_ds) // cfg.train.batch_size, 1)
        print(f"[dpfx_torch] epochs={cfg.train.epochs} -> steps={cfg.train.steps}")
    trainer = Trainer(cfg, device=args.device)
    print(f"[dpfx_torch] experiment={cfg.experiment} name={cfg.name} device={trainer.device} "
          f"train={len(train_ds)} clouds; N={cfg.data.n_points} batch={cfg.train.batch_size}")
    batches = iterate_batches(train_ds, cfg.train.batch_size, cfg.data.n_points,
                              seed=cfg.train.seed)
    if cfg.data.num_workers > 0:
        batches = prefetch_batches(batches, depth=cfg.data.num_workers)
    trainer.fit(batches)
    print(f"[dpfx_torch] done at step {trainer.state.step}; checkpoints in {trainer.directory}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
