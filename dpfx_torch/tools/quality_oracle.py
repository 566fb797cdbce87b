"""The two brackets around a generation-quality table: the suite run with
real clouds standing in for the generated set (the counterpart of the JAX
package's ``tools/quality_oracle.py``).

    python -m dpfx_torch.tools.quality_oracle CONFIG [key=value ...] [--limit 400]
        [--metrics cd,emd] [--impl auto|plain] [--skip-noise] [--out results.jsonl]
        [--device cuda|cpu]

* ``train_vs_test``: S clouds of the train split against S of the test
  split, the "perfect generator" row (MMD at the data's own pairing cost,
  high COV, 1-NNA near 0.5, JSD near 0);
* ``noise_vs_test``: Gaussian clouds at the test set's standard deviation
  (``numpy.random.default_rng(0)``), the "broken generator" row (1-NNA near
  1).

A model's row means something as far as it sits near the first. Both
splits take the evaluation CLI's subset (``eval_subset``: label-stratified
where ``--limit`` caps a labelled, multi-class split), and the suite runs
with the config's ``eval.jsd_resolution``, ``eval.pairwise_precision`` and
``eval.jsd_frame``, and the labels where ``data.category`` is ``all``.
``--impl auto`` computes CD and EMD with the CUDA kernels on the card (the
plain versions on the CPU), ``--impl plain`` with the plain versions
anywhere. Under torchrun (``dpfx_torch.parallel``) the matrices are
row-sharded over the ranks and rank 0 prints. Each row is printed as one
JSON line (and appended to ``--out``), then the kernel launches.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("overrides", nargs="*")
    ap.add_argument("--limit", type=int, default=400)
    ap.add_argument("--metrics", default=None, help="override eval.metrics, e.g. cd,emd")
    ap.add_argument("--impl", default="auto", choices=["auto", "plain"])
    ap.add_argument("--skip-noise", action="store_true")
    ap.add_argument("--out", default=None, help="append result JSON lines here")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from dpfx_torch.config import load_config
    from dpfx_torch.data import build_dataset, eval_subset, load_all
    from dpfx_torch.metrics import compute_all_metrics
    from dpfx_torch.parallel import init_from_config, is_coordinator
    from dpfx_torch.tools._common import launches_line, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(args.config, overrides=args.overrides)
    group, device = init_from_config(cfg.parallel, args.device)
    try:
        metrics = args.metrics.split(",") if args.metrics else list(cfg.eval.metrics)
        size = cfg.model.image_encoder.image_size
        test_ds = build_dataset(cfg.data, "test", size)
        train_ds = build_dataset(cfg.data, "train", size)
        ti, test_labels = eval_subset(test_ds, args.limit)
        ri, _ = eval_subset(train_ds, args.limit)
        ref = load_all(test_ds, cfg.data.n_points_eval, limit=args.limit, indices=ti)
        fake_real = load_all(train_ds, cfg.data.n_points_eval, limit=args.limit, indices=ri)
        labels = test_labels if cfg.data.category == "all" else None
        say = print if is_coordinator(group) else (lambda *a, **k: None)
        s = ref.shape[0]
        say(f"# oracle: S={s} N={ref.shape[1]} metrics={metrics} on {device}")
        reset_launch_counts()

        common = dict(metrics=metrics, impl=args.impl, jsd_resolution=cfg.eval.jsd_resolution,
                      ref_labels=labels, label_names=getattr(test_ds, "label_names", None),
                      precision=cfg.eval.pairwise_precision or None,
                      jsd_frame=cfg.eval.jsd_frame, group=group)
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa
        rows = []
        r = compute_all_metrics(on(fake_real), on(ref), **common)
        rows.append({"oracle": "train_vs_test", "n": s, **r})
        say(json.dumps(rows[-1]))
        if not args.skip_noise:
            rng = np.random.default_rng(0)
            noise = rng.normal(scale=float(np.std(ref)), size=ref.shape).astype(np.float32)
            r = compute_all_metrics(on(noise), on(ref), **common)
            rows.append({"oracle": "noise_vs_test", "n": s, **r})
            say(json.dumps(rows[-1]))
        if args.out and is_coordinator(group):
            with open(args.out, "a") as f:
                for row in rows:
                    f.write(json.dumps(row) + "\n")
        say(launches_line())
        return 0
    finally:
        if group is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
