"""Decomposition probe for the fused point-flow backward, on the card.

The port's counterpart of ``tools/bench_fused_bwd.py``: it times reduced
variants of the training backward to attribute its cost. In bf16 the
variants run the training backward's own body (``csrc/flow_bwd_rows.cuh``,
the body of ``fused_backward_kernel``) on the 8-row layout:

  lib       the port's production kernel (``fused_backward_kernel``) on the
            3-row slice of the same weights: a 3-row function, so its time
            compares with ``full``'s but its values do not
  full      the backward on the 8-row layout: dx, dhz and every weight
            gradient
  nowg      what only the weight gradients need left out (dx only)
  walk      only the inverse walk (conditioner recompute and inverse; x_0
            in dx's place)
  rolled    ``full`` with the layer loop kept rolled (``#pragma unroll 1``)
  ilv<S>[r] ``full`` with each block's warps in S groups (S = 2, 4), each
            group on its own tiles of 128 / S points with its own barrier,
            so one group's products can overlap another's coupling math
            (``r``: rolled)

So full - nowg (the weight gradients), nowg - walk (the cotangent chain)
and walk (the recompute and the inverse) split the backward that training
runs; the line before the launches gives them as shares of ``full``, and
``full / lib``.

The 8-row layout is the JAX probe's: u and du [B, 8, N], wx [K, H, 8] (no
mask folded in: the conditioner reads all 8 rows), wout [K, 8, H], the
shift from rows 3-5 (``roll(st, 5)``) and the translation cotangent
``roll(dy * inv, 3)``; rows 3-7 pass through every layer. The kernels are
``csrc/bench_fused_bwd.cu``; see its header for the design and the bound.

Usage: python -m dpfx_torch.tools.bench_fused_bwd [variant ...] [--device cpu]
Env:   DPFX_PROBE_B (64), DPFX_PROBE_TILES ("128": points per block tile
       of the non-interleaved variants, a comma list to sweep; the bf16
       variants are built for 128 points, and any other tile, or one whose
       shared memory exceeds 227 KB, prints FAILED),
       DPFX_PROBE_REPS (20), DPFX_PROBE_VMEM (a TPU scoped-memory knob,
       accepted and ignored)

Each line gives ms per call (``chain_time_ms``: CUDA events on the card)
and μs per tile (a tile of one cloud, the grid step of the JAX tool) or per
block (interleaved: the JAX tool's block, one cloud). With full, nowg and
walk timed, the line before the last gives the split; the last line gives
the launches of each kernel in the run.

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises). ``launches`` counts the
kernel launches of each wrapper and variant.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dpfx_torch.models.coupling import make_masks
from dpfx_torch.ops._build import SMEM_LIMIT

Tensor = torch.Tensor

N = 2048
K, H, NH = 32, 128, 1        # flagship point flow: 32 layers, hidden 128, n_hidden=2
CAP = 3.0
ROWS = 8
KERNEL_HIDDEN = (128,)       # the probe kernels are built for the flagship width
MODES = {"full": 0, "nowg": 1, "walk": 2}
ILV_STRIPES = (2, 4)
# the forms the kernel library is built for (csrc/bench_fused_bwd.cu):
# (tile, mode, rolled) of the probe kernel; (stripes, rolled) and the tile
# argument of the interleaved one (bf16: the block's 128 points, 128 /
# stripes a group; f32: each stripe's tile)
BUILT = {
    torch.bfloat16: {(128, m, r) for m in MODES for r in (False, True)},
    torch.float32: {(32, m, False) for m in MODES} | {(32, "full", True)},
}
ILV_BUILT = {torch.bfloat16: {(s, r) for s in ILV_STRIPES for r in (False, True)},
             torch.float32: {(s, False) for s in ILV_STRIPES}}
ILV_TILE = {torch.bfloat16: 128, torch.float32: 16}
TILE = {torch.bfloat16: 128, torch.float32: 32}   # the default tile of the probe kernel
GRAD_NAMES = ("dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout")

# kernel launches per wrapper and variant; chip_smoke.py zeroes these
# around the tool's run
launches: Dict[str, int] = {
    **{f"probe_bwd_{m}{'_rolled' if r else ''}": 0 for m in MODES for r in (False, True)},
    **{f"ilv_bwd_{s}{'r' if r else ''}": 0 for s in ILV_STRIPES for r in (False, True)},
}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def masks8(n_layers: int, device=None) -> Tensor:
    """[K, 8, 1] float32: the point flow's masks in rows 0-2, rows 3-7 1
    (pass-through), as ``dpfx/ops/fused_train.py:120``."""
    masks = np.ones((n_layers, ROWS), np.float32)
    masks[:, :3] = make_masks(3, n_layers)
    return torch.from_numpy(masks[..., None]).to(device)


# ---------------------------------------------------------------- plain version

def probe_bwd_plain(w: Dict[str, Tensor], u: Tensor, hz: Tensor, du: Tensor, dld: Tensor, *,
                    mode: str, n_points: int, cap: float = CAP,
                    dtype: torch.dtype = torch.bfloat16) -> Tuple[Tensor, ...]:
    """The probe backward's arithmetic in torch ops on the 8-row layout.

    w: wx [K, H, 8], wh [K, NH, H, H], bh [K, NH, H, 1], wout [K, 8, H],
    bout [K, 8, 1]; u, du [B, 8, Np]; hz [B, K, H, 1]; dld [B]. Columns at
    or beyond ``n_points`` take no log-det cotangent (they keep their du).
    Products take operands rounded to ``dtype`` with float32 accumulation;
    ``dtype=torch.float64`` computes everything in float64 instead (a
    reference for the float32 versions). Returns (dx, dhz, dwx, dwh, dbh,
    dwout, dbout) in float32 (float64 there), shaped as their inputs;
    ``nowg`` leaves dhz and the weight gradients at zero, ``walk`` also
    returns x_0 in dx's place."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    rnd = lambda a: a.to(dtype).to(acc)
    wx, wh, bh, wout, bout = (w[k].to(acc) for k in ("wx", "wh", "bh", "wout", "bout"))
    n_layers, nh = wx.shape[0], wh.shape[1]
    masks = masks8(n_layers, u.device).to(acc)
    y, dy = u.to(acc), du.to(acc)
    valid = (torch.arange(y.shape[2], device=u.device) < n_points).to(acc)
    g_ld = dld.to(acc)[:, None, None]
    hz = hz.to(acc)
    full = mode == "full"
    dhz = torch.zeros_like(hz)
    dwx, dwh, dbh = torch.zeros_like(wx), torch.zeros_like(wh), torch.zeros_like(bh)
    dwout, dbout = torch.zeros_like(wout), torch.zeros_like(bout)
    for k in reversed(range(n_layers)):
        mask = masks[k]
        inv = 1.0 - mask
        h = torch.relu(torch.einsum("hc,bcn->bhn", rnd(wx[k]), rnd(y)) + hz[:, k])
        hs = [h]
        for j in range(nh):
            h = torch.relu(torch.einsum("oi,bin->bon", rnd(wh[k, j]), rnd(h)) + bh[k, j])
            hs.append(h)
        st = torch.einsum("rh,bhn->brn", rnd(wout[k]), rnd(hs[-1])) + bout[k]
        th = torch.tanh(st / cap)
        es = torch.exp(cap * th)
        tt = torch.roll(st, 5, dims=1)
        xk = torch.where(mask > 0, y, (y - tt) / es)
        if mode == "walk":
            y = xk
            continue
        ds = dy * xk * es * inv + (g_ld * inv) * valid
        dst = ds * (1.0 - th * th) + torch.roll(dy * inv, 3, dims=1)
        dh = torch.einsum("rh,brn->bhn", rnd(wout[k]), rnd(dst))
        if full:
            dwout[k] = torch.einsum("brn,bhn->rh", rnd(dst), rnd(hs[-1]))
            dbout[k] = dst.sum((0, 2))[:, None]
        for j in reversed(range(nh)):
            dh = dh * (hs[j + 1] > 0)
            if full:
                dwh[k, j] = torch.einsum("bon,bin->oi", rnd(dh), rnd(hs[j]))
                dbh[k, j] = dh.sum((0, 2))[:, None]
            dh = torch.einsum("oi,bon->bin", rnd(wh[k, j]), rnd(dh))
        dh = dh * (hs[0] > 0)
        if full:
            dwx[k] = torch.einsum("bhn,bcn->hc", rnd(dh), rnd(xk))
            dhz[:, k] = dh.sum(2)[..., None]
        dy = torch.where(mask > 0, dy, dy * es) + torch.einsum("hc,bhn->bcn", rnd(wx[k]),
                                                                 rnd(dh))
        y = xk
    return (y if mode == "walk" else dy), dhz, dwx, dwh, dbh, dwout, dbout


# ---------------------------------------------------------------- kernel launch

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from dpfx_torch.ops import _build

    lib = _build.load("bench_fused_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dpfx_probe_bwd.argtypes = [
        p, p, p, p,                   # y (in: u; out: x_0 in walk), dy (in: du; out: dx), dld, hz
        p, p, p, p, p, p,             # wx, wh, bh, wout, bout, masks
        p, p, p, p, p,                # weight-grad partials, dhz partials, dw out, dhz out, dWh scratch
        i, i, i, i, i, i, f,          # B, Np, n_points, K, H, n_hidden-1, cap
        i, i, i, i, i, i, p,          # bf16, mode, rolled, tile, stripes, blocks, stream
    ]
    lib.dpfx_probe_bwd_smem_bytes.argtypes = [i, i, i, i, i]
    for fn in (lib.dpfx_probe_bwd, lib.dpfx_probe_bwd_smem_bytes):
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(hidden: int, n_hidden_m1: int, dtype: torch.dtype, tile: int,
               stripes: int = 1) -> int:
    """Dynamic shared memory of one block, as the kernel library lays it out
    (a mirror of ``dpfx_probe_bwd_smem_bytes``: bf16 ``MmaSmem`` of
    ``csrc/flow_bwd_rows.cuh``, the same for every mode and group count;
    f32 ``Smem`` of ``csrc/bench_fused_bwd.cu``). Change it with them: the
    card test ``test_probe_smem_mirror_matches_the_library`` holds the two
    equal."""
    r128 = lambda v: -(-v // 128) * 128
    if dtype == torch.bfloat16:
        ld, mt = hidden + 8, 128
        stage = r128(n_hidden_m1 * hidden * ld * 2) + 2 * r128(8 * ld * 2)
        o = (2 * (n_hidden_m1 + 1) * r128(mt * ld * 2) + 2 * r128(8 * (mt + 8) * 2)
             + r128(8 * hidden * 4) + 8 * 16 * 8 * 4)
        return o + (2 if o + 2 * stage <= SMEM_LIMIT else 1) * stage
    ld, nb = hidden + 1, max(n_hidden_m1, 1)
    block = (nb * r128(hidden * ld * 4)
             + (n_hidden_m1 * r128(hidden * (hidden + 4) * 4) if stripes == 1 else 0)
             + r128(8 * 256 * 4) + 2 * r128(ROWS * hidden * 4) + 2 * r128(ROWS * 4)
             + r128(nb * hidden * 4))
    group = ((n_hidden_m1 + 1) * r128(tile * ld * 4) + r128(tile // 16 * hidden * 4)
             + 5 * r128(ROWS * tile * 4) + 3 * r128(hidden * 4) + 2 * r128(ROWS * hidden * 4)
             + r128(ROWS * 4) + r128(nb * hidden * 4))
    return block + stripes * group


def check_form(dtype: torch.dtype, mode: str, rolled: bool, tile: int, stripes: int = 1,
               n: Optional[int] = None, hidden: int = H, n_hidden_m1: int = NH) -> None:
    """Raise ValueError unless the kernel library is built for this form
    (``BUILT``, ``ILV_BUILT``, ``ILV_TILE``) and its shared memory fits a
    block; ``n`` is the points per cloud (the f32 stripes divide it)."""
    if dtype not in BUILT:
        raise ValueError(f"kernel compute dtype must be float32 or bfloat16, got {dtype}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    if stripes == 1 and (tile, mode, bool(rolled)) not in BUILT[dtype]:
        raise ValueError(f"the probe kernel is built for (tile, mode, rolled) in "
                         f"{sorted(BUILT[dtype])} in {dtype}, got {(tile, mode, bool(rolled))}")
    if stripes != 1 and (stripes not in ILV_STRIPES or mode != "full"
                         or (dtype == torch.float32 and n is not None and n % stripes)):
        raise ValueError(f"the interleaved kernel takes mode full and stripes in {ILV_STRIPES} "
                         f"(in float32: that divide N={n}), got {mode!r}, {stripes}")
    if stripes > 1 and ((stripes, bool(rolled)) not in ILV_BUILT[dtype]
                        or tile != ILV_TILE[dtype]):
        raise ValueError(f"the interleaved kernel is built for (stripes, rolled) in "
                         f"{sorted(ILV_BUILT[dtype])}, tile {ILV_TILE[dtype]} in {dtype}, got "
                         f"{(stripes, bool(rolled))}, tile {tile}")
    need = smem_bytes(hidden, n_hidden_m1, dtype, tile, stripes)
    if need > SMEM_LIMIT:
        raise ValueError(f"tile={tile} stripes={stripes} n_hidden-1={n_hidden_m1} in {dtype} "
                         f"needs {need} B of shared memory, more than the {SMEM_LIMIT} B a "
                         "block may use")


def grid(dtype: torch.dtype, tile: int, stripes: int, b: int, n: int, sms: int):
    """(blocks, gradient slices, dhz tiles per cloud) of a launch: bf16, a
    persistent grid of at most one block per SM with ``stripes`` groups a
    block, one slice per group, the groups' tiles of tile / stripes points;
    f32, the same grid with one slice per block, or (stripes) one block per
    cloud writing dhz itself."""
    if dtype == torch.bfloat16:
        nt = -(-n // (tile // stripes))
        blocks = min(-(-b * nt // stripes), sms)
        return blocks, blocks * stripes, nt
    if stripes == 1:
        nt = -(-n // tile)
        return min(b * nt, sms), min(b * nt, sms), nt
    return b, b, 0


def _launch(w, u, hz, du, dld, *, mode, n_points, cap, dtype, rolled, tile, stripes):
    wx, wh, bh, wout, bout = (w[k] for k in ("wx", "wh", "bh", "wout", "bout"))
    n_layers, hidden, rows = wx.shape
    nh1 = wh.shape[1]
    b, _, n = u.shape
    dev = u.device
    if hidden not in KERNEL_HIDDEN or rows != ROWS:
        raise ValueError(f"the probe kernels are built for wx [K, {KERNEL_HIDDEN}, {ROWS}], "
                         f"got {tuple(wx.shape)}")
    if tuple(u.shape[:2]) != (b, ROWS) or du.shape != u.shape:
        raise ValueError(f"u and du must be [B, {ROWS}, N], got {tuple(u.shape)}, {tuple(du.shape)}")
    if not 0 <= n_points <= n:
        raise ValueError(f"n_points must lie in [0, {n}], got {n_points}")
    check_form(dtype, mode, rolled, tile, stripes, n, hidden, nh1)
    tensors = dict(wx=wx, wh=wh, bh=bh, wout=wout, bout=bout, u=u, hz=hz, du=du, dld=dld)
    for name, t in tensors.items():
        if not (t.is_cuda and t.device == dev):
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, is on {t.device}")
    f32 = lambda t: t.float().contiguous()
    cast = lambda t: t.to(dtype).contiguous()
    y, dy = f32(u).clone(), f32(du).clone()
    per_layer = 2 * ROWS * hidden + nh1 * hidden * hidden + nh1 * hidden + ROWS
    blocks, slices, nt = grid(dtype, tile, stripes, b, n,
                              torch.cuda.get_device_properties(dev).multi_processor_count)
    # gradient scratch and outputs, which only the full mode writes
    full = mode == "full"
    f32_ilv = dtype == torch.float32 and stripes > 1
    empty = lambda *shape, need=True: (torch.empty(shape, device=dev, dtype=torch.float32)
                                       if full and need else None)
    part = empty(slices, n_layers, per_layer)
    dhz_part = empty(b, nt, n_layers, hidden, need=not f32_ilv)
    awh = empty(b, stripes, max(nh1, 1), hidden, hidden, need=f32_ilv)
    dw = empty(n_layers, per_layer)
    dhz = empty(b, n_layers, hidden)
    cwx, cwh, cwout = cast(wx), cast(wh), cast(wout)
    fbh, fbout, fhz, fdld = f32(bh), f32(bout), f32(hz), f32(dld)
    masks = masks8(n_layers, dev).contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().dpfx_probe_bwd(
            y.data_ptr(), dy.data_ptr(), fdld.data_ptr(), fhz.data_ptr(),
            cwx.data_ptr(), cwh.data_ptr() if nh1 else None, fbh.data_ptr() if nh1 else None,
            cwout.data_ptr(), fbout.data_ptr(), masks.data_ptr(),
            ptr(part), ptr(dhz_part), ptr(dw), ptr(dhz), ptr(awh),
            b, n, n_points, n_layers, hidden, nh1, float(cap),
            int(dtype == torch.bfloat16), MODES[mode], int(rolled), tile, stripes, blocks, stream)
    if err != 0:
        raise RuntimeError(f"probe backward kernel launch failed: cudaError {err}")
    zeros = lambda t: torch.zeros(t.shape, device=dev, dtype=torch.float32)
    if not full:
        dx = y if mode == "walk" else dy
        return (dx, zeros(hz), zeros(wx), zeros(wh), zeros(bh), zeros(wout), zeros(bout))
    o = 0
    def take(size, shape):
        nonlocal o
        out = dw[:, o:o + size].reshape(n_layers, *shape)
        o += size
        return out
    dwx = take(ROWS * hidden, (hidden, ROWS))
    dwh = take(nh1 * hidden * hidden, (nh1, hidden, hidden))
    dbh = take(nh1 * hidden, (nh1, hidden, 1))
    dwout = take(ROWS * hidden, (ROWS, hidden))
    dbout = take(ROWS, (ROWS, 1))
    return dy, dhz[..., None], dwx, dwh, dbh, dwout, dbout


def probe_bwd_kernel(w, u, hz, du, dld, *, mode: str, n_points: int, cap: float = CAP,
                     dtype: torch.dtype = torch.bfloat16, rolled: bool = False,
                     tile: Optional[int] = None):
    """The probe kernel (the counterpart of ``_kernel``,
    ``tools/bench_fused_bwd.py:49``): same contract as ``probe_bwd_plain``.
    ``rolled`` keeps the layer loop rolled; ``tile`` is the points per
    block tile (default ``TILE``: 128 in bf16, 32 in f32, as the production
    backward). Bit-identical from run to run."""
    if not u.is_cuda:
        return probe_bwd_plain(w, u, hz, du, dld, mode=mode, n_points=n_points, cap=cap,
                               dtype=dtype)
    tile = tile or TILE.get(dtype, 0)
    out = _launch(w, u, hz, du, dld, mode=mode, n_points=n_points, cap=cap, dtype=dtype,
                  rolled=rolled, tile=tile, stripes=1)
    launches[f"probe_bwd_{mode}{'_rolled' if rolled else ''}"] += 1
    return out


def ilv_bwd_kernel(w, u, hz, du, dld, *, stripes: int, rolled: bool = False,
                   n_points: Optional[int] = None, cap: float = CAP,
                   dtype: torch.dtype = torch.bfloat16):
    """The interleaved kernel (the counterpart of ``_ilv_kernel``,
    ``tools/bench_fused_bwd.py:155``): ``probe_bwd_plain``'s ``full`` with
    the points in ``stripes`` independent chains (bf16: groups of a block's
    warps, each on its own tiles; f32: one block per cloud, its points in
    stripes). ``n_points`` defaults to all of u's columns (the Pallas
    variant has no such mask and is defined only there)."""
    n_points = u.shape[2] if n_points is None else n_points
    if not u.is_cuda:
        return probe_bwd_plain(w, u, hz, du, dld, mode="full", n_points=n_points, cap=cap,
                               dtype=dtype)
    out = _launch(w, u, hz, du, dld, mode="full", n_points=n_points, cap=cap, dtype=dtype,
                  rolled=rolled, tile=ILV_TILE.get(dtype, 0), stripes=stripes)
    launches[f"ilv_bwd_{stripes}{'r' if rolled else ''}"] += 1
    return out


def production_slice(w, u, hz, du):
    """The 3-row slice of the probe's inputs in the production backward's
    layout (``fused_backward_kernel``): the mask folded into wx [K, H, 3],
    wout [K, 6, H], bout [K, 6], masks [K, 3], hz [B, K, H], u and du
    [B, 3, N]. Its function is the probe's only where wx's columns 3-7,
    u's and du's rows 3-7 and wout's and bout's rows 6-7 are zero."""
    n_layers = w["wx"].shape[0]
    m3 = masks8(n_layers, u.device)[:, :3, 0]
    return dict(wx=(w["wx"][:, :, :3] * m3[:, None, :]).contiguous(), wh=w["wh"].contiguous(), bh=w["bh"][..., 0].contiguous(),
                wout=w["wout"][:, :6].contiguous(), bout=w["bout"][:, :6, 0].contiguous(),
                masks=m3.contiguous(), hz=hz[..., 0].contiguous(),
                u=u[:, :3].contiguous(), du=du[:, :3].contiguous())


# ---------------------------------------------------------------- the tool

def flagship_inputs(b: int, device, seed: int = 0):
    """The JAX tool's inputs at its scales (0.3 / 0.1 / 0.1 / 0.05 / 0.01 for
    wx, wh, bh, wout, bout; 0.1 for hz; unit u and du; dld = 1), drawn with
    a seeded ``torch.Generator``."""
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=device)
    w = {"wx": 0.3 * rn(K, H, ROWS), "wh": 0.1 * rn(K, NH, H, H), "bh": 0.1 * rn(K, NH, H, 1),
         "wout": 0.05 * rn(K, ROWS, H), "bout": 0.01 * rn(K, ROWS, 1)}
    u0 = rn(b, ROWS, N)
    hz = 0.1 * rn(b, K, H, 1)
    du = rn(b, ROWS, N)
    dld = torch.ones((b,), device=device)
    return w, u0, hz, du, dld


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("variants", nargs="*",
                    help="lib full nowg walk rolled ilv<S>[r] (default: lib full nowg walk rolled)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from dpfx_torch.device import resolve_device
    from dpfx_torch.utils.profiling import chain_time_ms

    dev = resolve_device(args.device)
    which = args.variants or ["lib", "full", "nowg", "walk", "rolled"]
    b = int(os.environ.get("DPFX_PROBE_B", "64"))
    tiles = [int(t) for t in os.environ.get("DPFX_PROBE_TILES", "128").split(",")]
    reps = int(os.environ.get("DPFX_PROBE_REPS", "20"))
    if "DPFX_PROBE_VMEM" in os.environ:
        print("  DPFX_PROBE_VMEM is the TPU's scoped-VMEM limit: ignored on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    w, u0, hz, du, dld = flagship_inputs(b, dev)
    bf = torch.bfloat16
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"B={b} N={N} K={K} H={H} reps={reps} device={name}")

    def timed(call):
        def body(c, i):
            outs = call(u0 + c * 1e-3)
            return c + 1.0, outs[0][0, 0, :8].sum()
        return chain_time_ms(body, torch.zeros((), device=dev), reps=reps)

    ms_of = {}
    if "lib" in which:
        from dpfx_torch.ops import fused_train as ft

        p = production_slice(w, u0, hz, du)
        bwd = ft.fused_backward_kernel if dev.type == "cuda" else ft.fused_backward_plain
        pw = (p["wx"], p["wh"], p["bh"], p["wout"], p["bout"], p["masks"], CAP)
        ms = ms_of["lib"] = timed(lambda uu: bwd(*pw, uu[:, :3].contiguous(), p["hz"], p["du"],
                                                 dld, bf))
        print(f"  lib (fused_backward_kernel, 3 rows: its values are not the probe's) "
              f"{ms:8.2f} ms  {ms * 1000 / b:6.1f} us/cloud")

    for v in which:
        if not v.startswith("ilv"):
            continue
        stripes = int(v[3:].rstrip("r") or "2")
        rolled = v.endswith("r")
        try:
            ms = timed(lambda uu, s=stripes, r=rolled: ilv_bwd_kernel(
                w, uu, hz, du, dld, stripes=s, rolled=r, dtype=bf))
        except ValueError as e:
            print(f"  {v:6s}  FAILED: {str(e).splitlines()[0][:90]}")
            continue
        tile_bytes, total = ilv_slice_bytes(stripes, b, N, K, H, NH)
        print(f"  {v:6s}  {ms:8.2f} ms  {ms * 1000 / b:6.1f} us/block  dWh slice "
              f"{tile_bytes / 1024:.0f} KiB per group tile, {total / 1e9:.2f} GB in all "
              f"({total / ms / 1e6:.0f} GB/s)")

    for tile in tiles:
        g = b * -(-N // tile)
        for v, mode, rolled in (("full", "full", False), ("nowg", "nowg", False),
                                ("walk", "walk", False), ("rolled", "full", True)):
            if v not in which:
                continue
            try:
                ms = timed(lambda uu, m=mode, r=rolled, t=tile: probe_bwd_kernel(
                    w, uu, hz, du, dld, mode=m, n_points=N, dtype=bf, rolled=r, tile=t))
            except ValueError as e:
                print(f"  {v:6s} tile={tile:4d}  FAILED: {str(e).splitlines()[0][:90]}")
                continue
            print(f"  {v:6s} tile={tile:4d}  {ms:8.2f} ms  {ms * 1000 / g:6.1f} us/tile")
            ms_of.setdefault(v, ms)
    line = split_line(ms_of)
    if line:
        print(line)
    print(f"launches {json.dumps({k: n for k, n in launches.items() if n})}")
    return 0


def ilv_slice_bytes(stripes: int, b: int, n: int, n_layers: int, hidden: int,
                    n_hidden_m1: int) -> Tuple[int, int]:
    """The dWh traffic of the bf16 interleaved forms, which ``full`` keeps
    in registers: each group tile reads its group's f32 slice of every
    hidden dWh and writes it back (the first tile of a slice and layer
    only writes). Returns (bytes per group tile, bytes of the whole run at
    most), so that an ilv time can be read apart from its slice traffic."""
    per_tile = 2 * n_hidden_m1 * hidden * hidden * 4
    group_tiles = b * -(-n // (ILV_TILE[torch.bfloat16] // stripes)) * n_layers
    return per_tile, per_tile * group_tiles


def split_line(ms: Dict[str, float]) -> Optional[str]:
    """The backward's split as shares of ``full`` from the times of full,
    nowg and walk (each variant's first tile), and ``full / lib`` where lib
    was timed; None unless full, nowg and walk were."""
    if not all(v in ms for v in ("full", "nowg", "walk")):
        return None
    full = ms["full"]
    lib = f"{full / ms['lib']:.3f}" if "lib" in ms else "not measured"
    return (f"split of full: weight gradients (full - nowg) {(full - ms['nowg']) / full:.1%}, "
            f"cotangent chain (nowg - walk) {(ms['nowg'] - ms['walk']) / full:.1%}, recompute "
            f"and inverse (walk) {ms['walk'] / full:.1%}; full / lib {lib}")


if __name__ == "__main__":
    sys.exit(main())
