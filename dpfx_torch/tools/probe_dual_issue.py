"""Dual-issue probe: does independent FP32/MUFU work run under a serial
tensor-core chain on the card?

The port's counterpart of ``tools/probe_dual_issue.py``. Three modes of
one kernel (``csrc/dual_issue.cu``), on the same grid, timed by
``chain_time_ms``:

  A  a serial chain of L products x <- bf16(W_i x) ([H, H] by [H, T],
     float32 accumulation; each depends on the last)
  B  the same chain and, in the same warps, L independent steps
     v <- exp(v / 4) - 1 on a separate [8, T] buffer (no data dependence
     on x)
  C  the v-chain alone

If t(B) - t(A) is small against t(C), the v-chain rode for free under the
tensor-core chain, and overlapping independent clouds' coupling math with
another cloud's products has headroom of about t(C). If t(B) ~ t(A) + t(C),
the two serialise. At L=32, G=16, H=128, T=2048 the v-chain is ~8.4 M exps
(~2 us of MUFU at its peak) against ~34 GFLOP of products (~35 us at the
bf16 tensor-core peak), so the answer is no finer than that ratio allows.

Usage: python -m dpfx_torch.tools.probe_dual_issue [--device cpu]
Env:   PROBE_L (32), PROBE_G (16)

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises). ``launches`` counts the
kernel launches of each mode.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import sys
from typing import Dict, Tuple

import torch

Tensor = torch.Tensor

H, T = 128, 2048
COLUMNS = 128                 # columns of x per block
MODES = {"A": (True, False), "B": (True, True), "C": (False, True)}
LABELS = {"A": "A mxu-only", "B": "B mxu+vpu", "C": "C vpu-only"}

# kernel launches per mode; chip_smoke.py zeroes these around the tool's run
launches: Dict[str, int] = {f"dual_issue_{m}": 0 for m in MODES}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def mode_of(do_mxu: bool, do_vpu: bool) -> str:
    for m, flags in MODES.items():
        if flags == (do_mxu, do_vpu):
            return m
    raise ValueError("at least one of do_mxu and do_vpu must be set")


def dual_issue_plain(w: Tensor, x: Tensor, v: Tensor, *, do_mxu: bool,
                     do_vpu: bool) -> Tuple[Tensor, Tensor]:
    """w [L, H, H] (bf16 values), x [G, H, T], v [G, 8, T] float32 ->
    (ox [G, H, T], ov [G, 8, T]) float32: x rounded to bf16, then per step
    x <- bf16(W_i x) with float32 accumulation (do_mxu) and v <- exp(v/4) - 1
    in float32 (do_vpu)."""
    mode_of(do_mxu, do_vpu)
    xb = x.to(torch.bfloat16)
    v = v.float()
    for i in range(w.shape[0]):
        if do_mxu:
            xb = torch.matmul(w[i].float(), xb.float()).to(torch.bfloat16)
        if do_vpu:
            v = torch.exp(v * 0.25) - 1.0
    return xb.float(), v


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from dpfx_torch.ops import _build

    lib = _build.load("dual_issue")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dpfx_dual_issue.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.dpfx_dual_issue.restype = ctypes.c_int
    return lib


def dual_issue_kernel(w: Tensor, x: Tensor, v: Tensor, *, do_mxu: bool,
                      do_vpu: bool) -> Tuple[Tensor, Tensor]:
    """The kernel (the counterpart of ``_kernel``,
    ``tools/probe_dual_issue.py:43``): same contract as ``dual_issue_plain``;
    w in bf16, H = 128, T a multiple of 128."""
    if not x.is_cuda:
        return dual_issue_plain(w, x, v, do_mxu=do_mxu, do_vpu=do_vpu)
    mode = mode_of(do_mxu, do_vpu)
    n_layers = w.shape[0]
    g, h, t = x.shape
    if w.dtype != torch.bfloat16 or tuple(w.shape[1:]) != (H, H) or h != H:
        raise ValueError(f"the kernel takes bf16 w [L, {H}, {H}] and x [G, {H}, T], got "
                         f"{w.dtype} {tuple(w.shape)} and {tuple(x.shape)}")
    if t % COLUMNS or tuple(v.shape) != (g, 8, t):
        raise ValueError(f"T must be a multiple of {COLUMNS} and v [G, 8, T], got x "
                         f"{tuple(x.shape)}, v {tuple(v.shape)}")
    for name, a in dict(w=w, x=x, v=v).items():
        if not (a.is_cuda and a.device == x.device):
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, is on {a.device}")
    w, x, v = w.contiguous(), x.float().contiguous(), v.float().contiguous()
    ox, ov = torch.empty_like(x), torch.empty_like(v)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().dpfx_dual_issue(w.data_ptr(), x.data_ptr(), v.data_ptr(), ox.data_ptr(),
                                     ov.data_ptr(), n_layers, g, h, t, int(do_mxu), int(do_vpu),
                                     stream)
    if err != 0:
        raise RuntimeError(f"dual-issue kernel launch failed: cudaError {err}")
    launches[f"dual_issue_{mode}"] += 1
    return ox, ov


def probe_inputs(n_layers: int, g: int, device, seed: int = 0):
    """w [L, H, H] bf16 at scale 0.05, x [G, H, T] and v [G, 8, T] unit
    normal, from a seeded ``torch.Generator``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    w = (0.05 * torch.randn((n_layers, H, H), generator=gen, device=device)).to(torch.bfloat16)
    x = torch.randn((g, H, T), generator=gen, device=device)
    v = torch.randn((g, 8, T), generator=gen, device=device)
    return w, x, v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from dpfx_torch.device import resolve_device
    from dpfx_torch.utils.profiling import chain_time_ms

    dev = resolve_device(args.device)
    n_layers = int(os.environ.get("PROBE_L", "32"))
    g = int(os.environ.get("PROBE_G", "16"))
    w, x0, v0 = probe_inputs(n_layers, g, dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"L={n_layers} G={g} H={H} T={T} device={name}")
    ms = {}
    for m, (mxu, vpu) in MODES.items():
        def step(carry, i, mxu=mxu, vpu=vpu):
            # the outputs feed the next call, so every call has new inputs
            ox, ov = dual_issue_kernel(w, carry[0], carry[1], do_mxu=mxu, do_vpu=vpu)
            return (ox, ov), ox[0, 0, 0] + ov[0, 0, 0]

        ms[m] = chain_time_ms(step, (x0, v0), reps=30)
        print(f"{LABELS[m]}: {ms[m]:.3f} ms ({ms[m] / (g * n_layers) * 1000:.2f} us/grid-layer)",
              flush=True)
    extra = ms["B"] - ms["A"]
    verdict = "rides for free" if extra < 0.5 * ms["C"] else "serialises"
    # the v-chain's time against the products' at the H100's peak rates
    # (MUFU: 132 SMs x 16 x 1.98 GHz; bf16 tensor cores: 989 TFLOP/s): the
    # finest overlap the probe can resolve
    share = (g * n_layers * 8 * T / 4.18e12) / (2.0 * g * n_layers * H * H * T / 989e12)
    print(f"t(B) - t(A) = {extra:.3f} ms against t(C) = {ms['C']:.3f} ms: the v-chain "
          f"{verdict}; t(C)/t(A) = {ms['C'] / ms['A']:.3f} (at the peak rates the v-chain is "
          f"{share:.3f} of the products' time, so the answer is no finer than that)")
    print(f"launches {json.dumps({k: n for k, n in launches.items() if n})}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
