"""Fused point-flow forward (with the per-cloud log-det) and its backward,
for training.

Replaces the two Pallas TPU kernels of ``dpfx/ops/fused_train.py``:
``_fwd_kernel`` (all K couplings forward, u and the log-det) and
``_bwd_kernel`` (one reverse walk that stores no forward chain: dx, dhz
and every weight gradient). The CUDA kernels are in
``csrc/fused_train.cu``; see its header for the design and what bounds
them. ``_FusedForward`` wraps the pair as one ``torch.autograd.Function``,
so the backward kernel provides the gradient.

Layout at the kernels: the transposed cloud ``xt [B, 3, N]`` (float32),
the weights of ``StackedFlowParams`` (mask folded into Wx) and the
per-cloud z-projection ``hz [B, K, H]``, which stays one float32 einsum in
torch on both sides (``z_projection``), as in the JAX package.

Rounding follows the Pallas kernels: matmul operands in the compute dtype
with float32 accumulation, bias and ``hz`` added in float32, relu in
float32, one cast; the coupling arithmetic and the log-det are float32.
The backward casts every cotangent to the compute dtype before a product
and sums bias and ``hz`` gradients in float32.

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches the kernels for a CUDA tensor (or raises). ``launches`` counts the
kernel launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from dpfx_torch.models.dpf import dtype_of
from dpfx_torch.ops.fused_sampler import (
    KERNEL_HIDDEN,
    SMEM_LIMIT,
    WIDER,
    kernel_hidden,
    stack_point_flow_params,
    z_projection,
)

Tensor = torch.Tensor

# kernel launches per wrapper; chip_smoke.py zeroes these around the main path
launches: Dict[str, int] = {"fused_train_fwd": 0, "fused_train_bwd": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


MAX_HIDDEN = KERNEL_HIDDEN[-1]
MAX_N_HIDDEN = 4       # conditioner depths every width takes
STREAM_HIDDEN = (128, 256)   # widths the stream layout is built for
# deeper conditioners where the mma (bf16) or block-wide (f32) layouts hold
# the forward and the backward: the deepest n_hidden they take at each
# kernel width, by the library's smem_bytes (the card test
# test_layout_depths_match_the_library holds the table to it)
LAYOUT_N_HIDDEN = {"bfloat16": {32: 9, 64: 4, 128: 2, 256: 1},
                   "float32": {32: 17, 64: 5, 128: 2, 256: 0}}


def fused_train_supported(flow_cfg) -> bool:
    """The kernels' domain: a relu conditioner (the backward needs its
    derivative), no actnorm, 1 <= hidden <= 256 (padded up to the kernels'
    widths by ``stack_point_flow_params``) with n_hidden 1-4 in either
    compute dtype, and deeper conditioners where the mma or block-wide
    layouts hold them (``LAYOUT_N_HIDDEN``)."""
    if (flow_cfg.activation != "relu" or flow_cfg.use_actnorm
            or not 1 <= flow_cfg.hidden <= MAX_HIDDEN or flow_cfg.n_hidden < 1):
        return False
    deepest = LAYOUT_N_HIDDEN[flow_cfg.compute_dtype][kernel_hidden(flow_cfg.hidden)]
    return flow_cfg.n_hidden <= max(MAX_N_HIDDEN, deepest)


# ---------------------------------------------------------------- plain version

def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' working type: float32, or float64 for the f64
    reference (``dtype=torch.float64``, every operand and sum in f64)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _rnd(dtype: torch.dtype):
    acc = _acc(dtype)
    return lambda a: a.to(dtype).to(acc)


def _hidden_chain(wx: Tensor, wh: Tensor, bh: Tensor, hz: Tensor, k: int, x: Tensor,
                  dtype: torch.dtype) -> List[Tensor]:
    """Conditioner activations h_0..h_last of layer k on x [B, 3, N], each
    float32 after relu (the kernels round them to ``dtype`` before use)."""
    rnd = _rnd(dtype)
    h = torch.relu(torch.einsum("hc,bcn->bhn", rnd(wx[k]), rnd(x)) + hz[:, k, :, None])
    hs = [h]
    for j in range(wh.shape[1]):
        h = torch.relu(torch.einsum("oi,bin->bon", rnd(wh[k, j]), rnd(h)) + bh[k, j][:, None])
        hs.append(h)
    return hs


def fused_forward_plain(wx: Tensor, wh: Tensor, bh: Tensor, wout: Tensor, bout: Tensor,
                        masks: Tensor, cap: float, xt: Tensor, hz: Tensor,
                        dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """xt [B, 3, N] -> (u [B, 3, N], log-det [B]): the forward kernel's
    arithmetic in torch ops (``dtype=torch.float64`` on f64 inputs: the f64
    reference)."""
    rnd = _rnd(dtype)
    x = xt.to(_acc(dtype))
    ld = torch.zeros_like(x[:, 0])
    for k in range(wx.shape[0]):
        hs = _hidden_chain(wx, wh, bh, hz, k, x, dtype)
        st = torch.einsum("rh,bhn->brn", rnd(wout[k]), rnd(hs[-1])) + bout[k][:, None]
        s = cap * torch.tanh(st[:, :3] / cap)
        keep = masks[k][:, None] > 0
        ld = ld + ((1.0 - masks[k][:, None]) * s).sum(1)
        x = torch.where(keep, x, x * torch.exp(s) + st[:, 3:])
    return x, ld.sum(1)


def fused_backward_plain(wx: Tensor, wh: Tensor, bh: Tensor, wout: Tensor, bout: Tensor,
                         masks: Tensor, cap: float, u: Tensor, hz: Tensor, du: Tensor,
                         dld: Tensor, dtype: torch.dtype):
    """The backward kernel's arithmetic: one reverse walk from the forward
    output u, each layer's input rebuilt by the closed-form inverse and its
    conditioner recomputed from the passthrough rows (identical in the
    layer's input and output). Returns (dx, dhz, dwx, dwh, dbh, dwout,
    dbout), all float32 (float64 for ``dtype=torch.float64`` on f64
    inputs: the f64 reference that an f32 result's drift is read from)."""
    rnd = _rnd(dtype)
    acc = _acc(dtype)
    y, dy = u.to(acc), du.to(acc)
    g_ld = dld.to(acc)[:, None, None]
    dhz = torch.zeros_like(hz)
    dwx, dwh, dbh = torch.zeros_like(wx), torch.zeros_like(wh), torch.zeros_like(bh)
    dwout, dbout = torch.zeros_like(wout), torch.zeros_like(bout)
    for k in reversed(range(wx.shape[0])):
        hs = _hidden_chain(wx, wh, bh, hz, k, y, dtype)
        st = torch.einsum("rh,bhn->brn", rnd(wout[k]), rnd(hs[-1])) + bout[k][:, None]
        th = torch.tanh(st[:, :3] / cap)
        es = torch.exp(cap * th)
        keep = masks[k][:, None] > 0
        inv = 1.0 - masks[k][:, None]
        xk = torch.where(keep, y, (y - st[:, 3:]) / es)
        ds = dy * xk * es * inv + g_ld * inv
        dst = torch.cat([ds * (1.0 - th * th), dy * inv], 1)          # [B, 6, N]
        dh = torch.einsum("rh,brn->bhn", rnd(wout[k]), rnd(dst))
        dwout[k] = torch.einsum("brn,bhn->rh", rnd(dst), rnd(hs[-1]))
        dbout[k] = dst.sum((0, 2))
        for j in reversed(range(wh.shape[1])):
            dh = dh * (hs[j + 1] > 0)
            dwh[k, j] = torch.einsum("bon,bin->oi", rnd(dh), rnd(hs[j]))
            dbh[k, j] = dh.sum((0, 2))
            dh = torch.einsum("oi,bon->bin", rnd(wh[k, j]), rnd(dh))
        dh = dh * (hs[0] > 0)
        dwx[k] = torch.einsum("bhn,bcn->hc", rnd(dh), rnd(xk))
        dhz[:, k] = dh.sum(2)
        dy = torch.where(keep, dy, dy * es) + torch.einsum("hc,bhn->bcn", rnd(wx[k]), rnd(dh))
        y = xk
    return dy, dhz, dwx, dwh, dbh, dwout, dbout


# ---------------------------------------------------------------- kernel launch

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from dpfx_torch.ops import _build

    lib = _build.load("fused_train")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dpfx_fused_train_fwd.argtypes = [
        p, p, p, p,                   # xt, hz, u, ld partials [B, ntiles]
        p, p, p, p, p, p,             # wx, wh, bh, wout, bout, masks
        i, i, i, i, i, f, i, p,       # B, N, K, H, n_hidden-1, cap, bf16, stream
    ]
    lib.dpfx_fused_train_bwd.argtypes = [
        p, p, p, p,                   # y (in: u; scratch), dy (in: du; out: dx), dld, hz
        p, p, p, p, p, p,             # wx, wh, bh, wout, bout, masks
        p, p, p, p,                   # weight-grad partials, dhz partials, dw out, dhz out
        i, i, i, i, i, f, i, i, p,    # B, N, K, H, n_hidden-1, cap, bf16, blocks, stream
    ]
    lib.dpfx_fused_train_smem_bytes.argtypes = [i, i, i, i]
    lib.dpfx_fused_train_tile_points.argtypes = [i, i]
    for fn in (lib.dpfx_fused_train_fwd, lib.dpfx_fused_train_bwd,
               lib.dpfx_fused_train_smem_bytes, lib.dpfx_fused_train_tile_points):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _stream_lib() -> ctypes.CDLL:
    """The stream layout's entry points (a library built before it has
    none: the flagship's path never asks for them)."""
    lib = _lib()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dpfx_fused_train_stream_fwd.argtypes = lib.dpfx_fused_train_fwd.argtypes
    lib.dpfx_fused_train_stream_bwd.argtypes = [
        p, p, p, p,                   # y, dy, dld, hz
        p, p, p, p, p, p,             # wx, wh, bh, wout, bout, masks
        p, p, p, p, p,                # partials, dhz partials, dWh sums, dw out, dhz out
        i, i, i, i, i, f, i, i, p,    # B, N, K, H, n_hidden-1, cap, bf16, blocks, stream
    ]
    lib.dpfx_fused_train_stream_smem_bytes.argtypes = [i, i, i, i]
    lib.dpfx_fused_train_stream_tile_points.argtypes = [i, i, i, i]
    for fn in (lib.dpfx_fused_train_stream_fwd, lib.dpfx_fused_train_stream_bwd,
               lib.dpfx_fused_train_stream_smem_bytes, lib.dpfx_fused_train_stream_tile_points):
        fn.restype = ctypes.c_int
    return lib


def uses_stream(hidden: int, n_hidden_m1: int, dtype: torch.dtype) -> bool:
    """The layout, chosen from the shapes for the forward and the backward
    together: the stream layout where the mma (bf16) or block-wide (f32)
    layout of either overflows a block's shared memory, so that the
    backward's recompute is the forward's arithmetic; else those, whose
    instances are the same as before the stream layout existed."""
    return any(smem_bytes(hidden, n_hidden_m1, dtype, bwd) > SMEM_LIMIT for bwd in (False, True))


def _tiles(n: int, dtype: torch.dtype, backward: bool,
           stream: Optional[Tuple[int, int]] = None) -> int:
    """Tiles of a cloud of n points, at the kernel library's points per
    forward block or per backward tile (``stream``: (H, n_hidden-1) of the
    stream layout)."""
    bf = int(dtype == torch.bfloat16)
    t = (_stream_lib().dpfx_fused_train_stream_tile_points(*stream, bf, int(backward)) if stream
         else _lib().dpfx_fused_train_tile_points(bf, int(backward)))
    return (n + t - 1) // t


def smem_bytes(hidden: int, n_hidden_m1: int, dtype: torch.dtype, backward: bool) -> int:
    """Dynamic shared memory of one forward or backward block, as the
    kernel library lays it out."""
    return _lib().dpfx_fused_train_smem_bytes(hidden, n_hidden_m1, int(dtype == torch.bfloat16),
                                              int(backward))


def _check(wx: Tensor, dtype: torch.dtype, tensors: Dict[str, Tensor]) -> None:
    k, h, _ = wx.shape
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel compute dtype must be float32 or bfloat16, got {dtype}")
    if h not in KERNEL_HIDDEN:
        raise ValueError(f"the fused train kernels are built for hidden in {KERNEL_HIDDEN} "
                         f"(stack_point_flow_params pads up to them), got {h}; wider point "
                         f"flows: {WIDER}")
    dev = wx.device
    for name, t in tensors.items():
        if not (t.is_cuda and t.device == dev):
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, is on {t.device}")
        if not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a contiguous float32 tensor")


def _check_smem(h: int, nh1: int, dtype: torch.dtype, backward: bool) -> bool:
    """Raise where no layout fits; returns whether the stream layout runs."""
    if not uses_stream(h, nh1, dtype):
        return False
    if h not in STREAM_HIDDEN:
        raise ValueError(f"hidden={h}, n_hidden={nh1 + 1} in {dtype} overflows the shared memory "
                         f"of the mma and block-wide layouts, and the stream layout is built "
                         f"for hidden in {STREAM_HIDDEN}")
    need = _stream_lib().dpfx_fused_train_stream_smem_bytes(h, nh1, int(dtype == torch.bfloat16),
                                                            int(backward))
    if need > SMEM_LIMIT:
        raise ValueError(f"hidden={h}, n_hidden={nh1 + 1} in {dtype} needs {need} B of shared "
                         f"memory in the stream layout, more than the {SMEM_LIMIT} B a block "
                         f"may use")
    return True


def _weights(wx, wh, wout, dtype):
    """Weight operands in the compute dtype (the cast is the kernels' rounding)."""
    return tuple(w.to(dtype).contiguous() for w in (wx, wh, wout))


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fused_forward_kernel(wx, wh, bh, wout, bout, masks, cap, xt, hz, dtype):
    """The forward kernel: same contract as ``fused_forward_plain``."""
    k, h, _ = wx.shape
    nh1 = wh.shape[1]
    b, _, n = xt.shape
    _check(wx, dtype, dict(wx=wx, wh=wh, bh=bh, wout=wout, bout=bout, masks=masks, xt=xt, hz=hz))
    wide = _check_smem(h, nh1, dtype, backward=False)
    u = torch.empty_like(xt)
    ld_part = torch.empty((b, _tiles(n, dtype, False, (h, nh1) if wide else None)),
                          device=xt.device, dtype=torch.float32)
    cwx, cwh, cwout = _weights(wx, wh, wout, dtype)
    stream = torch.cuda.current_stream(xt.device).cuda_stream
    fwd = _stream_lib().dpfx_fused_train_stream_fwd if wide else _lib().dpfx_fused_train_fwd
    with torch.cuda.device(xt.device):
        err = fwd(
            xt.data_ptr(), hz.data_ptr(), u.data_ptr(), ld_part.data_ptr(),
            cwx.data_ptr(), cwh.data_ptr() if nh1 else None, bh.data_ptr() if nh1 else None,
            cwout.data_ptr(), bout.data_ptr(), masks.data_ptr(),
            b, n, k, h, nh1, float(cap), int(dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused train forward kernel launch failed: cudaError {err}")
    launches["fused_train_fwd"] += 1
    return u, ld_part.sum(1)


def _backward_call(wx, wh, bh, wout, bout, masks, cap, u, hz, du, dld, dtype):
    """Launch the backward kernel and the reductions of its partials.
    Returns (y, dx, dw, dhz): y is the layer input the kernel rebuilt last
    (the flow's input, rebuilt from u), dw the [K, per-layer] gradients."""
    k, h, _ = wx.shape
    nh1 = wh.shape[1]
    b, _, n = u.shape
    _check(wx, dtype, dict(wx=wx, wh=wh, bh=bh, wout=wout, bout=bout, masks=masks, u=u, hz=hz,
                           du=du, dld=dld))
    wide = _check_smem(h, nh1, dtype, backward=True)
    nt = _tiles(n, dtype, True, (h, nh1) if wide else None)
    blocks = min(b * nt, _sm_count(u.device))
    per_layer = 3 * h + nh1 * h * h + nh1 * h + 6 * h + 6
    dev = u.device
    y, dx = u.clone(), du.clone()
    part = torch.empty((blocks, k, per_layer), device=dev, dtype=torch.float32)
    dhz_part = torch.empty((b, nt, k, h), device=dev, dtype=torch.float32)
    dw = torch.empty((k, per_layer), device=dev, dtype=torch.float32)
    dhz = torch.empty((b, k, h), device=dev, dtype=torch.float32)
    # the stream layout's per-block dWh sums (L2-resident scratch)
    wacc = torch.empty((blocks, nh1, h, h), device=dev, dtype=torch.float32) if wide else None
    cwx, cwh, cwout = _weights(wx, wh, wout, dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [y.data_ptr(), dx.data_ptr(), dld.data_ptr(), hz.data_ptr(),
            cwx.data_ptr(), cwh.data_ptr() if nh1 else None, bh.data_ptr() if nh1 else None,
            cwout.data_ptr(), bout.data_ptr(), masks.data_ptr(),
            part.data_ptr(), dhz_part.data_ptr()]
    if wide:
        ptrs.append(wacc.data_ptr() if nh1 else None)
    bwd = _stream_lib().dpfx_fused_train_stream_bwd if wide else _lib().dpfx_fused_train_bwd
    with torch.cuda.device(dev):
        err = bwd(*ptrs, dw.data_ptr(), dhz.data_ptr(),
                  b, n, k, h, nh1, float(cap), int(dtype == torch.bfloat16), blocks, stream)
    if err != 0:
        raise RuntimeError(f"fused train backward kernel launch failed: cudaError {err}")
    launches["fused_train_bwd"] += 1
    return y, dx, dw, dhz


def fused_backward_kernel(wx, wh, bh, wout, bout, masks, cap, u, hz, du, dld, dtype):
    """The backward kernel, then the fixed-order reduction of its per-block
    weight-gradient partials and per-tile dhz partials: same contract as
    ``fused_backward_plain``, and bit-identical from run to run."""
    k, h, _ = wx.shape
    nh1 = wh.shape[1]
    _, dx, dw, dhz = _backward_call(wx, wh, bh, wout, bout, masks, cap, u, hz, du, dld, dtype)
    o = 0
    def take(size, shape):
        nonlocal o
        out = dw[:, o:o + size].reshape(k, *shape)
        o += size
        return out
    dwx = take(3 * h, (h, 3))
    dwh = take(nh1 * h * h, (nh1, h, h))
    dbh = take(nh1 * h, (nh1, h))
    dwout = take(6 * h, (6, h))
    dbout = take(6, (6,))
    return dx, dhz, dwx, dwh, dbh, dwout, dbout


# ---------------------------------------------------------------- autograd

class _FusedForward(torch.autograd.Function):
    """(wx, wh, bh, wout, bout, xt, hz) -> (u, log-det); the backward kernel
    gives every gradient. The residual is u, not xt: the backward rebuilds
    each layer's input from its output."""

    @staticmethod
    def forward(ctx, wx, wh, bh, wout, bout, xt, hz, masks, cap, dtype):
        fwd = fused_forward_kernel if xt.is_cuda else fused_forward_plain
        u, ld = fwd(wx, wh, bh, wout, bout, masks, cap, xt, hz, dtype)
        ctx.save_for_backward(wx, wh, bh, wout, bout, masks, u, hz)
        ctx.cap, ctx.dtype = cap, dtype
        return u, ld

    @staticmethod
    def backward(ctx, du, dld):
        wx, wh, bh, wout, bout, masks, u, hz = ctx.saved_tensors
        du = torch.zeros_like(u) if du is None else du.float().contiguous()
        dld = (torch.zeros(u.shape[0], device=u.device) if dld is None
               else dld.float().contiguous())
        bwd = fused_backward_kernel if u.is_cuda else fused_backward_plain
        dx, dhz, dwx, dwh, dbh, dwout, dbout = bwd(wx, wh, bh, wout, bout, masks, ctx.cap, u,
                                                   hz, du, dld, ctx.dtype)
        return dwx, dwh, dbh, dwout, dbout, dx, dhz, None, None, None


def fused_point_flow_recon_ll(model, x: Tensor, z: Tensor, flow_cfg) -> Tensor:
    """Per-cloud reconstruction log-likelihood sum_i log p(x_i | z) of a DPF
    ``model`` through the fused kernel pair. x [B, N, 3], z [B, dz] -> [B].

    Drop-in for ``model.point_flow.log_prob(x, z).sum(-1)`` inside the ELBO
    (the same math, with the kernels' rounding)."""
    sp = stack_point_flow_params(model.point_flow)
    xt = x.transpose(1, 2).float().contiguous()
    u, ld = _FusedForward.apply(sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, xt, z_projection(sp, z),
                                sp.masks, sp.scale_cap, dtype_of(flow_cfg.compute_dtype))
    return -0.5 * (u * u + math.log(2.0 * math.pi)).sum((1, 2)) + ld
