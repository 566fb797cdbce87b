#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: build the kernels, hold each one
against its plain PyTorch version at the flagship widths, drive the main
path (flagship sampling) through the normal entry points, and report.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints its result on its own line; any failure raises and the
script exits non-zero without a result line):
  1. the card's name and power limit; build every kernel with nvcc (sm_90a);
  2. kernel vs plain version at K=32, H=128, dz=128, B=8, N=2048 and a
     ragged N=2000: f32 and bf16 for fused_inverse, bf16 for fused_sample
     against the plain inverse of the noise it drew, noise moments at
     tau=1 and 1.1, and same-seed determinism;
  3. the main path at full width (configs/flagship_quality_v3_aug_100k.yaml,
     random seeded weights): dpfx_torch.generate.main for 64 clouds, the
     timed make_sampler(64, 2048), make_decoder and DPF.reconstruct on
     Gaussian-blob clouds; launch counts are zeroed just before and read
     just after;
  4. one JSON line with every kernel's error, time, plain time and bound
     at the main path's shapes (B=64, N=2048, bf16);
  5. a torch.profiler breakdown of make_sampler(64, 2048): device-busy
     time, idle share and the kernels that take the time;
  6. the card line again, then the last line: {"ok": true, "device": {...}}.
It needs no network and starts no process that outlives it (nvcc and
nvidia-smi are waited for).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "flagship_quality_v3_aug_100k.yaml"
WORK = ROOT / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# tolerances of kernel vs plain version (max abs error over the outputs)
# on O(1)-O(10) clouds. f32: both sum in IEEE f32, in other orders, through
# 32 layers (seen: 4e-6). bf16: the operands round identically, but a sum
# that lands on the other side of a bf16 rounding boundary flips one hidden
# unit by one ulp and 32 layers carry it on (seen: max 4e-3, p99.9 2e-4).
TOL_F32 = 1e-4
TOL_BF16_MAX = 5e-2
TOL_BF16_P999 = 2e-3


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def errors(a, b):
    import torch

    e = (a.float() - b.float()).abs().flatten()
    return float(e.max()), float(torch.quantile(e[:: max(1, e.numel() // 2**24)], 0.999))


def bound(sp, b: int, n: int, with_ut: bool):
    """Least time for one call: FLOP over the bf16 tensor-core peak, and
    bytes (each input read once, each output written once) over HBM."""
    k, h, _ = sp.wx.shape
    nh1 = sp.wh.shape[1]
    flops = 2.0 * b * n * k * (3 * h + nh1 * h * h + 6 * h)
    weights = 2 * (k * h * 3 + k * nh1 * h * h + k * 6 * h) + 4 * (k * nh1 * h + k * 6 + k * 3)
    nbytes = 4 * b * k * h + weights + 4 * 3 * b * n * (2 if with_ut else 1)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2

    from dpfx_torch import generate
    from dpfx_torch.compat import randomize_
    from dpfx_torch.config import load_config
    from dpfx_torch.models import DPF
    from dpfx_torch.ops import _build
    from dpfx_torch.ops import fused_sampler as fs
    from dpfx_torch.sampling import make_decoder, make_sampler

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")

    # ---- 1. build
    t0 = time.perf_counter()
    built = _build.build_all(force=True)
    print(f"build: {json.dumps({k: round(v, 2) for k, v in built.items()})} "
          f"total {time.perf_counter() - t0:.2f}s")
    for line in _build.ptxas_log("fused_sampler").splitlines():
        if "Used" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    # ---- 2. kernel vs plain at flagship widths
    cfg = load_config(str(CONFIG))
    pf = cfg.model.point_flow
    # 0.02: at 0.05 the random 32-layer inverse is unstable (|x| reaches
    # 1e7-1e10); at 0.02 the clouds stay O(1), as a trained
    # flow's do, and the out layers are still far from the identity
    model = randomize_(DPF(cfg), seed=0, scale=0.02).to(dev).eval()
    sp = fs.stack_point_flow_params(model.point_flow)
    k, h, _ = sp.wx.shape
    check((k, h, cfg.model.dz) == (32, 128, 128), f"flagship widths, got K={k} H={h}")
    g = torch.Generator(device=dev).manual_seed(1)
    for n in (2048, 2000):
        ut = torch.randn((8, 3, n), generator=g, device=dev)
        z = torch.randn((8, cfg.model.dz), generator=g, device=dev)
        hz = fs.z_projection(sp, z)
        for dtype in (torch.float32, torch.bfloat16):
            xk = fs.fused_inverse_transposed(sp, ut, z, dtype=dtype, activation=pf.activation)
            xp = fs.fused_inverse_transposed_plain(sp, ut, hz, dtype, pf.activation)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(xk).all()), f"fused_inverse finite N={n} {dtype}")
            emax, e999 = errors(xk, xp)
            print(f"kernel-vs-plain fused_inverse N={n} {dtype}: max_abs={emax:.3e} "
                  f"p99.9={e999:.3e} (|x|max={float(xp.abs().max()):.2f})")
            if dtype == torch.float32:
                check(emax <= TOL_F32, f"fused_inverse f32 N={n}: {emax} > {TOL_F32}")
            else:
                check(emax <= TOL_BF16_MAX and e999 <= TOL_BF16_P999,
                      f"fused_inverse bf16 N={n}: max {emax}, p99.9 {e999}")
        for tau in (1.0, 1.1):
            x, u = fs.fused_sample_points(sp, z, 1234, n, dtype=torch.bfloat16,
                                          activation=pf.activation, noise_scale=tau,
                                          return_noise=True)
            xp = fs.fused_inverse_transposed_plain(sp, u.transpose(1, 2).contiguous(), hz,
                                                   torch.bfloat16, pf.activation)
            emax, e999 = errors(x, xp.transpose(1, 2))
            mean, var = float(u.mean()), float(u.var())
            x2 = fs.fused_sample_points(sp, z, 1234, n, dtype=torch.bfloat16,
                                        activation=pf.activation, noise_scale=tau)
            x3 = fs.fused_sample_points(sp, z, 1235, n, dtype=torch.bfloat16,
                                        activation=pf.activation, noise_scale=tau)
            print(f"kernel-vs-plain fused_sample N={n} tau={tau}: max_abs={emax:.3e} "
                  f"p99.9={e999:.3e} noise mean={mean:.4f} var/tau^2={var / tau**2:.4f}")
            check(emax <= TOL_BF16_MAX and e999 <= TOL_BF16_P999,
                  f"fused_sample vs plain inverse of its noise: max {emax}, p99.9 {e999}")
            # 49k draws: the standard errors are 0.0045 (mean) and 0.0064 (var)
            check(abs(mean) < 0.025 and abs(var / tau**2 - 1) < 0.035, "noise moments")
            check(torch.equal(x, x2), "same seed gives the same clouds")
            check(not torch.equal(x, x3), "another seed gives other clouds")

    # ---- 3. the main path at full width
    WORK.mkdir(parents=True, exist_ok=True)
    weights, samples = WORK / "flagship_random.pt", WORK / "samples.npy"
    torch.save({kk: v.cpu() for kk, v in model.state_dict().items()}, weights)
    blobs_g = torch.Generator().manual_seed(2)
    blobs = (torch.randn((16, 1, 3), generator=blobs_g)
             + 0.2 * torch.randn((16, 2048, 3), generator=blobs_g)).to(dev)

    fs.reset_launch_counts()
    rc = generate.main([str(CONFIG), "--weights", str(weights), "--n-clouds", "64",
                        "--out", str(samples), "--seed", "3"])
    sampler = make_sampler(model, 64, 2048, temperature=cfg.eval.temperature,
                           latent_temperature=cfg.eval.latent_temperature)
    sample_ms = cuda_ms(lambda: sampler(4), iters=20)
    clouds = sampler(5)
    decoded = make_decoder(model, 2048)(model.encode(blobs)[0], 6)
    recon = model.reconstruct(blobs, generator=torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    main_launches = dict(fs.launches)

    import numpy as np

    gen = np.load(samples)
    check(rc == 0 and gen.shape == (64, 2048, 3) and bool(np.isfinite(gen).all()),
          f"generate output {gen.shape}")
    for name, t, shape in (("sample", clouds, (64, 2048, 3)), ("decode", decoded, (16, 2048, 3)),
                           ("reconstruct", recon, (16, 2048, 3))):
        check(tuple(t.shape) == shape and bool(torch.isfinite(t).all()), f"{name} {tuple(t.shape)}")
    for kname, count in main_launches.items():
        check(count > 0, f"kernel {kname} was not launched on the main path")
    print(f"main path: launches {json.dumps(main_launches)}; make_sampler(64, 2048) "
          f"{sample_ms:.3f} ms/batch, {64 / sample_ms * 1e3:,.1f} clouds/s, "
          f"{64 * 2048 / sample_ms * 1e3:,.0f} points/s; sample std {float(clouds.std()):.3f}")

    # ---- 4. per-kernel numbers at the main path's shapes (B=64, N=2048, bf16)
    b, n = 64, 2048
    z = torch.randn((b, cfg.model.dz), generator=g, device=dev)
    ut = torch.randn((b, 3, n), generator=g, device=dev)
    hz = fs.z_projection(sp, z)
    act, bf = pf.activation, torch.bfloat16
    xk = fs.fused_inverse_transposed(sp, ut, z, dtype=bf, activation=act)
    xp = fs.fused_inverse_transposed_plain(sp, ut, hz, bf, act)
    inv_err = errors(xk, xp)[0]
    xs, us = fs.fused_sample_points(sp, z, 8, n, dtype=bf, activation=act, return_noise=True)
    smp_err = errors(xs, fs.fused_inverse_transposed_plain(
        sp, us.transpose(1, 2).contiguous(), hz, bf, act).transpose(1, 2))[0]
    inv_ms = cuda_ms(lambda: fs.fused_inverse_transposed(sp, ut, z, dtype=bf, activation=act), 20)
    smp_ms = cuda_ms(lambda: fs.fused_sample_points(sp, z, 9, n, dtype=bf, activation=act), 20)
    plain_inv_ms = cuda_ms(lambda: fs.fused_inverse_transposed_plain(
        sp, ut, fs.z_projection(sp, z), bf, act), 3, warmup=1)
    plain_smp_ms = cuda_ms(lambda: fs.fused_sample_points_plain(
        sp, fs.z_projection(sp, z), 9, n, bf, act), 3, warmup=1)
    b_inv, by_inv, flops = bound(sp, b, n, with_ut=True)
    b_smp, by_smp, _ = bound(sp, b, n, with_ut=False)
    src = "dpfx_torch/ops/csrc/fused_sampler.cu"
    kernels = [
        {"name": "fused_inverse", "route": "cuda", "source": src,
         "replaces": "dpfx/ops/fused_sampler.py:112", "launches": main_launches["fused_inverse"],
         "max_abs_err": inv_err, "ms": inv_ms, "plain_ms": plain_inv_ms, "bound_ms": b_inv,
         "bound_by": by_inv, "library_ms": None},
        {"name": "fused_sample", "route": "cuda", "source": src,
         "replaces": "dpfx/ops/fused_sampler.py:309", "launches": main_launches["fused_sample"],
         "max_abs_err": smp_err, "ms": smp_ms, "plain_ms": plain_smp_ms, "bound_ms": b_smp,
         "bound_by": by_smp, "library_ms": None},
    ]
    check(inv_err <= TOL_BF16_MAX and smp_err <= TOL_BF16_MAX, "B=64 kernel errors")
    print(f"kernel rates at B={b} N={n}: fused_inverse {flops / inv_ms / 1e9:.1f} TFLOP/s, "
          f"fused_sample {flops / smp_ms / 1e9:.1f} TFLOP/s ({card})")
    print(json.dumps({"kernels": kernels}))

    # ---- 5. where the main path's time goes (torch.profiler, 5 sampler calls)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sampler(10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(5):
            sampler(11 + i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: an aten op's entry repeats its kernels' time
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    check(any("fused_inverse_kernel" in e.key for e in dev_events),
          "the profiler saw the fused kernel on the device")
    busy_us = sum(e.self_device_time_total for e in dev_events)
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profile make_sampler(64, 2048) x5: wall {wall_us / 5e3:.3f} ms/batch, device busy "
          f"{busy_us / 5e3:.3f} ms/batch, idle share {1 - busy_us / wall_us:.3f} under the "
          f"profiler, {1 - busy_us / 5e3 / sample_ms:.3f} against phase 3's unprofiled "
          f"{sample_ms:.3f} ms/batch; top: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 5e3:.3f} ms x{e.count // 5}"
                      for e in top))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
