"""Train a DPF model from a YAML config with the PyTorch port.

Usage:
    python -m dpfx_torch.train configs/<exp>.yaml [key=value ...] [--resume] [--device cuda|cpu]

The device defaults to cuda and the run fails without one; ``--device cpu``
runs the plain path. ``train.steps_per_call`` steps run per call (on the
card, replays of one step captured in a CUDA graph); with
``data.device_resident`` the split is loaded onto the device once and each
step's batch is drawn and gathered there; an SVR run (``experiment: svr``)
loads its paired render stack too and gathers each step's images with the
clouds' ids. The validation split is
evaluated every ``train.eval_every`` steps and once at the end (unless the
cadence has just done so). Full-state checkpoints (``params_<step>.pt``
and ``state_<step>.ckpt``, the newest ``train.ckpt_keep`` kept, 0 keeps
all) and ``metrics.jsonl`` go to ``train.ckpt_dir/name``; ``--resume``
continues from the newest one, and ``train.recover_on_divergence``
restores it at a lower lr after a divergence. Sample a checkpoint with
``python -m dpfx_torch.generate CONFIG --weights <ckpt>.pt``. A run that is
neither resident nor SVR reads ``data.packed_path``, a stack written by
``python -m dpfx_torch.tools.pack_dataset``, through the native C++ loader
(``dpfx_torch.native``; a failed build of it raises).

Data parallel, one process per GPU (``dpfx_torch.parallel``): a lone
process with ``parallel.data_axis=n`` starts n ranks on this host, one card
each (-1, the default: every visible card; on ``--device cpu`` n gloo
processes, and -1 is one), and raises when n is above the visible cards.
A process that torchrun started (``RANK``, ``WORLD_SIZE``, ...), or one
given ``parallel.coordinator=host:port`` with ``parallel.num_processes``
and ``parallel.process_id``, is one rank itself. Each rank loads its rows
of every batch (resident with ``parallel.resident_sharding: sharded``: its
block of the split; packed: a loader of B/D clouds of its own seed); rank
0 prints, logs and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import sys


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", help="YAML experiment config")
    ap.add_argument("overrides", nargs="*", help="dotted.key=value overrides")
    ap.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    ap.add_argument("--strict-config", action="store_true", help="reject unknown YAML keys")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)

    from dpfx_torch.config import load_config
    from dpfx_torch.parallel import ranks_to_spawn, spawn

    cfg = load_config(args.config, strict=args.strict_config, overrides=args.overrides)
    n = ranks_to_spawn(cfg.parallel, args.device)
    if n > 1:
        spawn("dpfx_torch.train.__main__", "run", n, (argv,))
        return 0
    return run(argv)


def run(argv) -> int:
    """One rank of the run (the whole run in a process without a group)."""
    args = _parse(argv)

    import torch
    import torch.distributed as dist

    from dpfx_torch.config import load_config
    from dpfx_torch.parallel import init_from_config

    # float32 products stay IEEE float32 on the card (the plain paths' contract)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args.config, strict=args.strict_config, overrides=args.overrides)
    group, device = init_from_config(cfg.parallel, args.device)
    try:
        return _train(cfg, args, group, device)
    finally:
        if group is not None:
            dist.destroy_process_group()


def _train(cfg, args, group, device) -> int:
    from dpfx_torch.data import (build_dataset, iterate_batches, prefetch_batches, preload_clouds,
                                 preload_images)
    from dpfx_torch.parallel import process_local_rows, rank_seed, world_rank
    from dpfx_torch.train import Trainer

    svr = cfg.experiment == "svr"
    world, rank = world_rank(group)
    say = print if rank == 0 else (lambda *a, **k: None)    # the other ranks print nothing
    image_size = cfg.model.image_encoder.image_size
    train_ds = build_dataset(cfg.data, "train", image_size)
    val_ds = build_dataset(cfg.data, "val", image_size)
    if cfg.train.epochs > 0:
        cfg.train.steps = cfg.train.epochs * max(len(train_ds) // cfg.train.batch_size, 1)
        say(f"[dpfx_torch] epochs={cfg.train.epochs} -> steps={cfg.train.steps}")
    trainer = Trainer(cfg, device=device, group=group)
    layout = cfg.parallel.resident_sharding if cfg.data.device_resident else "host-fed"
    say(f"[dpfx_torch] experiment={cfg.experiment} name={cfg.name} device={trainer.device} "
        f"train={len(train_ds)} val={len(val_ds)} clouds; N={cfg.data.n_points} "
        f"batch={cfg.train.batch_size}" + (f" images={image_size}px" if svr else "")
        + (f"; {world} ranks, {layout}" if group is not None else ""))
    if args.resume:
        trainer.maybe_resume()

    def val_batches():
        return iterate_batches(val_ds, cfg.eval.batch_size, cfg.data.n_points_eval, seed=0,
                               shuffle=False, epochs=1, drop_last=False, with_images=svr)

    if cfg.data.device_resident:
        local = {}
        if group is not None and cfg.parallel.resident_sharding == "sharded":
            # each rank loads only its padded block of the split
            s = len(train_ds)
            start, stop = process_local_rows(s, world, rank)
            rows = [g % s for g in range(start, stop)]
            local = dict(clouds_are_local_shard=True, logical_rows=s)
            say(f"[dpfx_torch] sharded resident split: rows [{start}, {stop}) of {s} a rank")
        else:
            rows = None
        clouds = preload_clouds(train_ds, indices=rows)
        images = preload_images(train_ds, indices=rows) if svr else None
        say(f"[dpfx_torch] device-resident split: {clouds.shape[0]} clouds x {clouds.shape[1]} "
            f"stored pts ({clouds.nbytes / 1e6:.0f} MB -> {trainer.device})"
            + (f" + renders {'x'.join(map(str, images.shape[1:]))} "
               f"({images.nbytes / 1e6:.0f} MB)" if svr else "")
            + f"; steps_per_call={trainer.steps_per_call}")
        trainer.fit_auto(resident_clouds=clouds, resident_images=images,
                         val_batches_fn=val_batches, **local)
    else:
        # an SVR run reads its (cloud, view) pairs from its dataset, as dpfx's does
        packed = bool(cfg.data.packed_path) and not svr
        loaders = []        # the native loader of the current stream

        def make_batches():
            # a callable, so that a divergence recovery restarts the stream
            if packed:
                from dpfx_torch.native import NativeBatcher

                for old in loaders:
                    old.close()
                # the stack already carries the dataset's normalization; each rank
                # draws its own B/D clouds a step, seeded by (train.seed, rank)
                nb = NativeBatcher(cfg.data.packed_path, cfg.train.batch_size // world,
                                   cfg.data.n_points, normalize="none",
                                   seed=cfg.train.seed if group is None else
                                   rank_seed(cfg.train.seed, rank),
                                   n_workers=max(cfg.data.num_workers, 2))
                loaders[:] = [nb]
                say(f"[dpfx_torch] native loader: {nb.n_items} clouds x {nb.n_stored} pts "
                    f"from {cfg.data.packed_path}; steps_per_call={trainer.steps_per_call}")
                return iter(nb)
            batches = iterate_batches(
                train_ds, cfg.train.batch_size, cfg.data.n_points, seed=cfg.train.seed,
                with_images=svr, batch_shard=None if group is None else
                process_local_rows(cfg.train.batch_size, world, rank))
            if cfg.data.num_workers > 0:
                batches = prefetch_batches(batches, depth=cfg.data.num_workers)
            return batches

        try:
            trainer.fit_auto(make_batches, val_batches_fn=val_batches)
        finally:
            for nb in loaders:
                nb.close()
    if trainer.last_eval_step != trainer.state.host_step:
        trainer.evaluate(val_batches())
    trainer.writer.close()
    say(f"[dpfx_torch] done at step {trainer.state.host_step}; checkpoints in "
        f"{trainer.directory}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
