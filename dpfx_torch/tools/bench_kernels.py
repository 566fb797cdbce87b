"""Each kernel against its plain PyTorch twin, timed on the same inputs (the
counterpart of the JAX package's ``tools/bench_kernels.py``, with its cases
and shapes), as one JSON object.

    python -m dpfx_torch.tools.bench_kernels [reps] [--device cpu]
    Env (shapes): DPFX_KB_B (16), DPFX_KB_N (2048), DPFX_KB_PAIRS (64),
                  DPFX_KB_EMD_PAIRS (16), DPFX_KB_SAMPLE_B (256)

Cases: Chamfer forward and forward+backward on B diagonal pairs
(``chamfer``: ``nnd_fwd``, and ``nnd_bwd`` through autograd), the Chamfer
matrix at PAIRS x PAIRS (``chamfer_pairwise``: ``cd_pairwise``), EMD on B
diagonal pairs (``emd``: ``emd_batched``), the EMD matrix at EMD_PAIRS x
EMD_PAIRS in fast and exact mode (``emd_pairwise``), and the flagship's
sampler at SAMPLE_B x N (``make_sampler``: ``fused_sample``, the latent
inverse through the module; its plain twin ``make_plain_sampler``, both
flows through their modules). Each case gives ``*_kernel_ms`` (the
wrapper, which launches the kernel on a CUDA tensor) and ``*_plain_ms``
(the plain version of the same function on the same device); the keys keep
the JAX tool's stems, with ``kernel``/``plain`` for ``pallas``/``jnp``. The
pairwise cases take ``min(reps, 3)`` reps, as the JAX tool's do.

Times come from ``chain_time_ms``: a warm-up chain and a timed chain of
``reps`` calls, each input perturbed by a negligible carry term, between
CUDA events on the card (``"protocol": "cuda-events"``; the host clock on
the CPU, where both sides are the plain version). The kernel launches of
the run are printed last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def perturbed(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x plus a carry-dependent, numerically negligible term."""
    return x + c * 1e-30


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("reps", nargs="?", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from dpfx_torch.config.flagship import flagship_model
    from dpfx_torch.device import resolve_device
    from dpfx_torch.ops import chamfer as cd
    from dpfx_torch.ops import emd as em
    from dpfx_torch.sampling import make_plain_sampler, make_sampler
    from dpfx_torch.tools._common import card, launches_line, reset_launch_counts
    from dpfx_torch.utils.profiling import chain_time_ms

    dev = resolve_device(args.device)
    reps = args.reps
    b = int(os.environ.get("DPFX_KB_B", "16"))
    n = int(os.environ.get("DPFX_KB_N", "2048"))
    pairs = int(os.environ.get("DPFX_KB_PAIRS", "64"))
    epairs = int(os.environ.get("DPFX_KB_EMD_PAIRS", "16"))
    sb = int(os.environ.get("DPFX_KB_SAMPLE_B", "256"))
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    zero = torch.zeros((), device=dev)
    reset_launch_counts()
    res = {}

    def timed(fn, r=reps):
        def step(c, i):
            return c + 1.0, fn(c, i)
        return round(chain_time_ms(step, zero, r), 4)

    # CD on B diagonal pairs, forward and forward+backward
    x, y = randn(b, n, 3), randn(b, n, 3)
    for side, fwd in (("kernel", cd.chamfer), ("plain", cd.chamfer_plain)):
        res[f"cd_fwd_b{b}_{side}_ms"] = timed(lambda c, i: fwd(perturbed(x, c), y).sum())

        def fwdbwd(c, i, fwd=fwd):
            xx = perturbed(x, c).requires_grad_(True)
            return torch.autograd.grad(fwd(xx, y).sum(), xx)[0].sum()
        res[f"cd_fwdbwd_b{b}_{side}_ms"] = timed(fwdbwd)

    # the CD matrix, PAIRS x PAIRS
    xs, ys = randn(pairs, n, 3), randn(pairs, n, 3)
    for side, fn in (("kernel", cd.chamfer_pairwise), ("plain", cd.chamfer_pairwise_plain)):
        res[f"cd_pairwise_{pairs}x{pairs}_{side}_ms"] = timed(
            lambda c, i: fn(perturbed(xs, c), ys).sum(), min(reps, 3))

    # EMD on B diagonal pairs
    for side, fn in (("kernel", em.emd_nograd), ("plain", em.emd_plain)):
        res[f"emd_fwd_b{b}_{side}_ms"] = timed(lambda c, i: fn(perturbed(x, c), y).sum())

    # the EMD matrix, EMD_PAIRS x EMD_PAIRS, fast and exact
    for precision in ("fast", "exact"):
        for side, fn in (("kernel", em.emd_pairwise), ("plain", em.emd_pairwise_plain)):
            res[f"emd_pairwise_{epairs}x{epairs}_{precision}_{side}_ms"] = timed(
                lambda c, i: fn(perturbed(xs[:epairs], c), ys[:epairs],
                             precision=precision).sum(), min(reps, 3))

    # the flagship's sampler at SAMPLE_B x N
    model = flagship_model(dev)
    for side, sample in (("kernel", make_sampler(model, sb, n)),
                         ("plain", make_plain_sampler(model, sb, n))):
        res[f"sample_fused_b{sb}_{side}_ms"] = timed(lambda c, i: sample(i)[0, 0, 0])

    res["reps"] = reps
    res["protocol"] = "cuda-events" if dev.type == "cuda" else "host-clock"
    res["device"] = card(dev)
    print(json.dumps(res))
    print(launches_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
