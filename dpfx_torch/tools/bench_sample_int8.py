"""int8 weights in the fused sampler against bf16 ones, timed in turns, with
the quantisation error (the counterpart of the JAX package's
``tools/bench_sample_int8.py``).

    python -m dpfx_torch.tools.bench_sample_int8 [--run-flow] [--device cpu]
    Env: DPFX_INT8_CKPT (a config; default
         configs/flagship_quality_v3_aug_100k.yaml), DPFX_INT8_B (256),
         DPFX_INT8_N (2048), DPFX_INT8_REPS (30)

The model is the flagship's point flow (32 layers, H=128, bf16, scale cap
3); with ``--run-flow`` it is the model of ``DPFX_INT8_CKPT``'s config
(its point flow's width, depth, dtype and activation). Its weights come
from the newest checkpoint of ``DPFX_INT8_CKPT``'s run
(``checkpoint_path``: ``train.ckpt_dir/name/params_<step>.pt``) when that
config has the same point flow and a checkpoint exists; otherwise they are
a fresh seeded initialisation, and the ``weights`` key says so. Only
trained weights make the error meaningful: a fresh initialisation zeroes
each coupling's output layer, so its output does not depend on the
quantised weights at all (the error is vacuous: 0), and random weights make
an unstable flow whose amplification swamps the quantisation.

First the parity: one seed through both modes (the same Philox noise), the
RMS of their difference against the RMS of the bf16 clouds, and the
median, 99.9th percentile and maximum of each point's distance between
the two (an RMS over half a million points can be carried by the few
that the flow throws far out). Then
``fused_sample`` in bf16 and in int8, timed with ``chain_time_ms`` in turns
(bf16, int8, int8, bf16; each side the mean of its two). One JSON line with
the JAX tool's keys and the per-point ones, then the kernel launches.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

INT8_CONFIG = {
    "experiment": "gen", "name": "int8ab",
    "model": {"dz": 128,
              "point_flow": {"n_layers": 32, "hidden": 128, "n_hidden": 2,
                             "compute_dtype": "bfloat16", "scale_cap": 3.0},
              "latent_flow": {"n_layers": 14, "hidden": 256, "n_hidden": 2,
                              "compute_dtype": "bfloat16", "scale_cap": 3.0},
              "encoder": {"compute_dtype": "bfloat16"}},
}


def load_weights(cfg, ckpt_config: str, device):
    """(model, source): the trained model of ``ckpt_config``'s newest
    checkpoint when its point flow is ``cfg``'s, else a fresh one."""
    from dpfx_torch.checkpoint import checkpoint_path, restore_for_eval
    from dpfx_torch.config import load_config
    from dpfx_torch.config.flagship import flagship_model

    if os.path.isfile(ckpt_config):
        tcfg = load_config(ckpt_config)
        if tcfg.model.point_flow == cfg.model.point_flow:
            try:
                path, step = checkpoint_path(tcfg)
            except FileNotFoundError:
                pass
            else:
                return restore_for_eval(tcfg, path, device), f"{tcfg.name}@{step}"
    return flagship_model(device, cfg), "fresh init (no checkpoint of this point flow)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run-flow", action="store_true",
                    help="the model of DPFX_INT8_CKPT's config, not the flagship's point flow")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from dpfx_torch.config import config_from_dict, load_config
    from dpfx_torch.device import resolve_device
    from dpfx_torch.models.dpf import dtype_of
    from dpfx_torch.ops.fused_sampler import (fused_sample_points, quantize_flow_params,
                                              stack_point_flow_params)
    from dpfx_torch.tools._common import card, launches_line, reset_launch_counts
    from dpfx_torch.utils.profiling import chain_time_ms

    dev = resolve_device(args.device)
    b = int(os.environ.get("DPFX_INT8_B", "256"))
    n = int(os.environ.get("DPFX_INT8_N", "2048"))
    reps = int(os.environ.get("DPFX_INT8_REPS", "30"))
    ckpt = os.environ.get("DPFX_INT8_CKPT", "configs/flagship_quality_v3_aug_100k.yaml")
    cfg = load_config(ckpt) if args.run_flow else config_from_dict(INT8_CONFIG)
    model, src = load_weights(cfg, ckpt, dev)
    pf = cfg.model.point_flow
    dtype = dtype_of(pf.compute_dtype)
    with torch.no_grad():
        sp = stack_point_flow_params(model.point_flow)
        qp = quantize_flow_params(sp)
    z = torch.randn((b, cfg.model.dz), generator=torch.Generator(device=dev).manual_seed(7),
                    device=dev)
    reset_launch_counts()

    def f16(seed):
        return fused_sample_points(sp, z, seed, n, dtype=dtype, activation=pf.activation)

    def f8(seed):
        return fused_sample_points(sp, z, seed, n, dtype=dtype, activation=pf.activation,
                                   quantized=qp)

    # parity first: the same seed draws the same noise in both modes
    x16, x8 = f16(3), f8(3)
    rms = float(((x16 - x8) ** 2).mean().sqrt())
    scale = float((x16 ** 2).mean().sqrt())
    # per point: the RMS can be carried by a few tail points the flow throws far out
    dist = (x16 - x8).norm(dim=-1).flatten().float()
    q50, q999 = torch.quantile(dist[:: max(1, dist.numel() // 2**24)],
                               torch.tensor([0.5, 0.999], device=dist.device)).tolist()

    def chain(fn):
        return chain_time_ms(lambda c, i: (c, fn(i)[0, 0, 0]), None, reps)

    turns = [chain(fn) for fn in (f16, f8, f8, f16)]
    t16, t8 = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    print(json.dumps({
        "bf16_ms": round(t16, 4), "int8_ms": round(t8, 4),
        "speedup": round(t16 / t8, 4),
        "bf16_pts_per_s": round(b * n / t16 * 1000),
        "int8_pts_per_s": round(b * n / t8 * 1000),
        "quant_rms_error": rms, "coord_rms": scale,
        "rel_rms": round(rms / scale, 5),
        "point_err_median": q50, "point_err_p999": q999, "point_err_max": float(dist.max()),
        "protocol": "cuda-events in turns" if dev.type == "cuda" else "host-clock in turns",
        "shapes": [b, n, reps],
        "weights": src,
        "device": card(dev),
    }))
    print(launches_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
