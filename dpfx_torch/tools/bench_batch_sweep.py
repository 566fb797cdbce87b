"""Train-step throughput and MFU against the batch size, on the flagship
model (the counterpart of the JAX package's ``tools/bench_batch_sweep.py``).

    python -m dpfx_torch.tools.bench_batch_sweep [--batches 64,128,256] [--reps 20]
        [--device cpu]

For each B it prints a markdown row ``| B | ms/step | pts/s | MFU |``:

* ms/step is the flagship's train step (loss, backward, clip and Adam, with
  the fused point-flow and encoder kernels) on one batch of B x N N(0, 1)
  points (N from ``DPFX_SWEEP_N``, default 2048) and a fixed eps, captured
  in a CUDA graph and timed as ``reps`` replays between CUDA events
  (``graph_time_ms``; eagerly on the host clock on the CPU);
* the FLOP of a step come from ``chain_cost_per_step`` on the plain step
  (both fused flags off), run once: aten's products, forward and backward.
  The fused kernels do the same products where no counter sees them;
* MFU is FLOP / time / 989e12, the H100 SXM's dense bf16 peak (the chip
  smoke's ``PEAK_BF16_FLOPS``). On the CPU it prints ``-``: that peak is
  not the CPU's.

The kernel launches of the run are printed last.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import torch

H100_BF16_PEAK = 989e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batches", default="64,128,256")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from dpfx_torch.config.flagship import flagship_config, flagship_model
    from dpfx_torch.tools._common import card, launch_counters, launches_line, reset_launch_counts
    from dpfx_torch.train import init_state, make_optimizer, make_train_step
    from dpfx_torch.train.trainer import _make_step
    from dpfx_torch.utils.profiling import chain_cost_per_step, graph_time_ms

    n = int(os.environ.get("DPFX_SWEEP_N", "2048"))
    cfg = flagship_config()
    model = flagship_model(args.device, cfg)
    dev = model.device
    torch.backends.cuda.matmul.allow_tf32 = False
    tx = make_optimizer(cfg.train)
    state = init_state(model, tx)
    step = _make_step(model, tx, cfg)
    cfg_plain = copy.deepcopy(cfg)
    cfg_plain.train.fused_point_flow = False
    cfg_plain.train.fused_encoder = False
    step_plain = make_train_step(model, tx, cfg_plain)
    on_card = dev.type == "cuda"
    reset_launch_counts()

    print(f"# batch sweep: N={n} reps={args.reps} device={card(dev)}; MFU against "
          f"{H100_BF16_PEAK / 1e12:g} TFLOP/s bf16 dense" if on_card else
          f"# batch sweep: N={n} reps={args.reps} device=cpu; MFU not computed")
    counted = {}
    print("| B | ms/step | pts/s | MFU |")
    print("|---|---|---|---|")
    for b in [int(s) for s in args.batches.split(",")]:
        g = torch.Generator(device=dev).manual_seed(b)
        x = torch.randn((b, n, 3), generator=g, device=dev)
        eps = torch.randn((b, cfg.model.dz), generator=g, device=dev)

        def body_plain(st, i):
            st, m = step_plain(st, {"x": x, "eps": eps})
            return st, m["loss"]

        flops, _ = chain_cost_per_step(body_plain, state)
        counted[b] = flops
        t = graph_time_ms(lambda: step(state, x, eps, None)["loss"], args.reps,
                          launch_counters())
        dt = t["ms"]
        del t
        if on_card:
            torch.cuda.empty_cache()
        mfu = (f"{flops / (dt / 1e3) / H100_BF16_PEAK:.2%}" if on_card and flops
               else ("-" if flops else "nan"))
        print(f"| {b} | {dt:.3f} | {b * n / dt * 1000:,.0f} | {mfu} |", flush=True)
    print(f"# FLOP/step of the plain step (aten products): {counted}")
    print(launches_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
