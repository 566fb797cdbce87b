"""Serving table for the flagship sampling path: latency per call and
throughput against the batch size (the counterpart of the JAX package's
``tools/bench_serving.py``).

    python -m dpfx_torch.tools.bench_serving [--device cpu]
    Env: DPFX_SERVE_BATCHES ("1,4,16,64,256,1024"), DPFX_SERVE_N (2048),
         DPFX_SERVE_REPS (30), DPFX_SERVE_XLA (1: also time the plain path,
         ``make_plain_sampler``: both flows through their modules, no
         kernel), DPFX_SAMPLE_FUSED_LATENT (1: the latent inverse through
         the fused kernels, else the module)

Each batch size B times ``make_sampler(model, B, N)`` on the flagship,
freshly initialised (seeded; ``fused_sample``, and the latent inverse that
the header names) with ``chain_time_ms``: ``reps`` calls, each with its
own seed, between two CUDA events. The time is the card's wherever the card stays
busy and the host's where it does not: with the latent inverse through the
module, a small batch is host-bound (its launches outlast its kernels), as
a production host would see it. The kernel launches of the run are printed
last.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from dpfx_torch.config.flagship import flagship_model
    from dpfx_torch.sampling import make_plain_sampler, make_sampler
    from dpfx_torch.tools._common import card, launches_line, reset_launch_counts
    from dpfx_torch.utils.profiling import chain_time_ms

    n = int(os.environ.get("DPFX_SERVE_N", "2048"))
    reps = int(os.environ.get("DPFX_SERVE_REPS", "30"))
    batches = [int(b) for b in
               os.environ.get("DPFX_SERVE_BATCHES", "1,4,16,64,256,1024").split(",")]
    paths = [("fused", make_sampler)]
    if os.environ.get("DPFX_SERVE_XLA") == "1":
        paths.append(("plain", make_plain_sampler))
    model = flagship_model(args.device)
    latent = ("fused kernels (DPFX_SAMPLE_FUSED_LATENT=1)"
              if os.environ.get("DPFX_SAMPLE_FUSED_LATENT") == "1" else "module")
    reset_launch_counts()

    print(f"# serving bench: N={n} reps={reps} device={card(model.device)} "
          f"latent inverse={latent}")
    print(f"{'path':6} {'B':>5} {'ms/call':>9} {'clouds/s':>10} {'pts/s':>12}")
    for name, make in paths:
        for b in batches:
            sample = make(model, b, n)

            def step(carry, i):
                out = sample(i)
                return carry, out[0, 0, 0]

            dt = chain_time_ms(step, None, reps)
            print(f"{name:6} {b:>5} {dt:>9.3f} {b / dt * 1000.0:>10.1f} "
                  f"{b * n / dt * 1000.0:>12.0f}", flush=True)
    print(launches_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
