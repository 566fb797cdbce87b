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
kernel launches of each wrapper, ``layout_launches`` the same by layout.

Layouts, chosen from the shapes for the forward and the backward together
(``_layout``): in f32 at H = 128 and 256 the f32 layout (``uses_f32``:
``csrc/flow_f32.cuh``, the f32 sampler's register-tiled device code, Wh
streamed with cp.async); else the mma layout (bf16) or the block-wide one
(f32) where a block holds the shape; else, in bf16, the cluster layout
(``csrc/flow_cluster.cuh``: one layer split across a thread-block cluster
of H / 64 CTAs; ``uses_cluster``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Tuple

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
# the same launches by the layout that ran them ("parent": mma or block-wide)
LAYOUTS = ("parent", "cluster", "f32")
layout_launches: Dict[str, int] = {f"{lay}_{d}": 0 for lay in LAYOUTS for d in ("fwd", "bwd")}


def reset_launch_counts() -> None:
    for counts in (launches, layout_launches):
        for k in counts:
            counts[k] = 0


MAX_HIDDEN = KERNEL_HIDDEN[-1]
MAX_N_HIDDEN = 4       # conditioner depths every width takes
# widths past whose depths the mma and block-wide layouts overflow, where the
# cluster (bf16) and f32 layouts take the deeper conditioners
WIDE_HIDDEN = (128, 256)
CLUSTER_COLUMNS = 64   # hidden columns each CTA of a cluster owns
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
def _cluster_lib() -> ctypes.CDLL:
    """The cluster layout's entry points (``csrc/flow_cluster.cuh``)."""
    lib = _lib()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dpfx_fused_train_cluster_fwd.argtypes = [
        p, p, p, p, p,                # xt, hz, u, ld partials [B, ntiles], carry [C, B, 4, N]
        p, p, p, p, p, p,             # wx, wh, bh, wout, bout, masks
        i, i, i, i, i, f, i, p,       # B, N, K, H, n_hidden-1, cap, clusters, stream
    ]
    lib.dpfx_fused_train_cluster_bwd.argtypes = [
        p, p, p, p, p,                # u, du, y out, dx out, carry [C, B, 9, N]
        p, p,                         # dld, hz
        p, p, p, p, p, p,             # wx, wh, bh, wout, bout, masks
        p, p, p, p,                   # partials, dhz partials, dw out, dhz out
        i, i, i, i, i, f, i, p,       # B, N, K, H, n_hidden-1, cap, clusters, stream
    ]
    lib.dpfx_fused_train_cluster_smem_bytes.argtypes = [i, i, i]
    lib.dpfx_fused_train_cluster_tile_points.argtypes = [i, i, i]
    lib.dpfx_fused_train_cluster_grid.argtypes = [i, i, i]
    lib.dpfx_fused_train_cluster_part_row.argtypes = [i, i]
    for fn in (lib.dpfx_fused_train_cluster_fwd, lib.dpfx_fused_train_cluster_bwd,
               lib.dpfx_fused_train_cluster_smem_bytes, lib.dpfx_fused_train_cluster_tile_points,
               lib.dpfx_fused_train_cluster_grid, lib.dpfx_fused_train_cluster_part_row):
        fn.restype = ctypes.c_int
    lib.dpfx_fused_train_error_string.argtypes = [i]
    lib.dpfx_fused_train_error_string.restype = ctypes.c_char_p
    return lib


def _error_text(err: int) -> str:
    return _cluster_lib().dpfx_fused_train_error_string(err).decode()


def overflows_block(hidden: int, n_hidden_m1: int, dtype: torch.dtype) -> bool:
    """Whether the mma (bf16) or block-wide (f32) layout of the forward or
    the backward overflows a block's shared memory (the layout is chosen
    for both together, so that the backward's recompute is the forward's
    arithmetic): then the cluster layout takes the shape in bf16
    (``uses_cluster``)."""
    return any(smem_bytes(hidden, n_hidden_m1, dtype, bwd) > SMEM_LIMIT for bwd in (False, True))


def uses_cluster(hidden: int, n_hidden_m1: int, dtype: torch.dtype) -> bool:
    """The cluster layout: the bf16 shapes at H = 128 and 256 with n_hidden
    <= ``MAX_N_HIDDEN`` that ``overflows_block`` sends past the mma layout
    and whose cluster plan fits a block forward and backward, by the
    library's ``dpfx_fused_train_cluster_smem_bytes`` (H=128 with n_hidden
    3-4, H=256 with n_hidden 2-4)."""
    if (dtype != torch.bfloat16 or hidden not in WIDE_HIDDEN
            or n_hidden_m1 >= MAX_N_HIDDEN or not overflows_block(hidden, n_hidden_m1, dtype)):
        return False
    need = _cluster_lib().dpfx_fused_train_cluster_smem_bytes
    return all(need(hidden, n_hidden_m1, bwd) <= SMEM_LIMIT for bwd in (0, 1))


@functools.lru_cache(maxsize=None)
def _f32_lib() -> ctypes.CDLL:
    """The f32 layout's entry points (``csrc/flow_f32.cuh``; a library
    built before it has none)."""
    lib = _cluster_lib()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dpfx_fused_train_f32_fwd.argtypes = [
        p, p, p, p,                   # xt, hz, u, ld partials [B, ntiles]
        p, p, p, p, p, p,             # wx, wh, bh, wout, bout, masks
        i, i, i, i, i, f, p,          # B, N, K, H, n_hidden-1, cap, stream
    ]
    lib.dpfx_fused_train_f32_bwd.argtypes = [
        p, p, p, p,                   # y (in: u; scratch), dy (in: du; out: dx), dld, hz
        p, p, p, p, p, p,             # wx, wh, bh, wout, bout, masks
        p, p, p, p,                   # partials, dhz partials, dw out, dhz out
        i, i, i, i, i, f, i, p,       # B, N, K, H, n_hidden-1, cap, blocks, stream
    ]
    for fn in (lib.dpfx_fused_train_f32_smem_bytes, lib.dpfx_fused_train_f32_tile_points):
        fn.argtypes = [i, i, i]
    lib.dpfx_fused_train_f32_part_row.argtypes = [i, i]
    for fn in (lib.dpfx_fused_train_f32_fwd, lib.dpfx_fused_train_f32_bwd,
               lib.dpfx_fused_train_f32_smem_bytes, lib.dpfx_fused_train_f32_tile_points,
               lib.dpfx_fused_train_f32_part_row):
        fn.restype = ctypes.c_int
    return lib


def uses_f32(hidden: int, n_hidden_m1: int, dtype: torch.dtype) -> bool:
    """The f32 layout: f32 at H = 128 and 256 with n_hidden <=
    ``MAX_N_HIDDEN`` (the shapes past the block-wide layout, H=256 with
    n_hidden 1-4 and H=128 with n_hidden 3-4, and H=128 with n_hidden 1-2,
    where the block-wide pair fits but timed slower in turns:
    ``python -m dpfx_torch.tools.bwd_ab PARENT --hidden 128 --dtype float32``
    against a build that routes there)."""
    return dtype == torch.float32 and hidden in WIDE_HIDDEN and n_hidden_m1 < MAX_N_HIDDEN


def _tiles(n: int, dtype: torch.dtype, backward: bool, layout: str,
           shape: Tuple[int, int]) -> int:
    """Tiles of a cloud of n points, at the kernel library's points per
    forward block or per backward tile of ``layout`` (``_layout``'s names;
    ``shape`` is (H, n_hidden-1))."""
    bf, bw = int(dtype == torch.bfloat16), int(backward)
    if layout == "f32":
        t = _f32_lib().dpfx_fused_train_f32_tile_points(*shape, bw)
    elif layout == "cluster":
        t = _cluster_lib().dpfx_fused_train_cluster_tile_points(*shape, bw)
    else:
        t = _lib().dpfx_fused_train_tile_points(bf, bw)
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


def _layout(h: int, nh1: int, dtype: torch.dtype, backward: bool) -> str:
    """The layout that runs ("parent": mma or block-wide, "cluster", "f32");
    raises where none fits."""
    if uses_f32(h, nh1, dtype):
        need = _f32_lib().dpfx_fused_train_f32_smem_bytes(h, nh1, int(backward))
        if need > SMEM_LIMIT:
            raise ValueError(f"hidden={h}, n_hidden={nh1 + 1} in f32 needs {need} B of shared "
                             f"memory in the f32 layout, more than the {SMEM_LIMIT} B a block "
                             f"may use")
        return "f32"
    if not overflows_block(h, nh1, dtype):
        return "parent"
    if uses_cluster(h, nh1, dtype):
        return "cluster"
    raise ValueError(f"hidden={h}, n_hidden={nh1 + 1} in {dtype} overflows the shared memory "
                     f"of the mma and block-wide layouts and is not a shape of the cluster or "
                     f"f32 layouts")


def _weights(wx, wh, wout, dtype):
    """Weight operands in the compute dtype (the cast is the kernels' rounding)."""
    return tuple(w.to(dtype).contiguous() for w in (wx, wh, wout))


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def _cluster_grid(h: int, nh1: int, backward: bool, device_index: int) -> int:
    """Clusters of the cluster layout's persistent grid: as many as the card
    holds at once (a second wave would double the time)."""
    with torch.cuda.device(device_index):
        n = _cluster_lib().dpfx_fused_train_cluster_grid(h, nh1, int(backward))
    if n <= 0:
        raise RuntimeError(f"the card holds no cluster of the fused train "
                           f"{'backward' if backward else 'forward'} at hidden={h}, "
                           f"n_hidden={nh1 + 1}")
    return n


def fused_forward_kernel(wx, wh, bh, wout, bout, masks, cap, xt, hz, dtype):
    """The forward kernel: same contract as ``fused_forward_plain``."""
    k, h, _ = wx.shape
    nh1 = wh.shape[1]
    b, _, n = xt.shape
    _check(wx, dtype, dict(wx=wx, wh=wh, bh=bh, wout=wout, bout=bout, masks=masks, xt=xt, hz=hz))
    layout = _layout(h, nh1, dtype, backward=False)
    u = torch.empty_like(xt)
    nt = _tiles(n, dtype, False, layout, (h, nh1))
    ld_part = torch.empty((b, nt), device=xt.device, dtype=torch.float32)
    cwx, cwh, cwout = _weights(wx, wh, wout, dtype)
    stream = torch.cuda.current_stream(xt.device).cuda_stream
    weights = [cwx.data_ptr(), cwh.data_ptr() if nh1 else None, bh.data_ptr() if nh1 else None,
               cwout.data_ptr(), bout.data_ptr(), masks.data_ptr()]
    with torch.cuda.device(xt.device):
        if layout == "cluster":
            carry = torch.empty((h // CLUSTER_COLUMNS, b, 4, n), device=xt.device,
                                dtype=torch.float32)
            err = _cluster_lib().dpfx_fused_train_cluster_fwd(
                xt.data_ptr(), hz.data_ptr(), u.data_ptr(), ld_part.data_ptr(), carry.data_ptr(),
                *weights, b, n, k, h, nh1, float(cap),
                _cluster_grid(h, nh1, False, xt.device.index or 0), stream)
        elif layout == "f32":
            err = _f32_lib().dpfx_fused_train_f32_fwd(
                xt.data_ptr(), hz.data_ptr(), u.data_ptr(), ld_part.data_ptr(), *weights,
                b, n, k, h, nh1, float(cap), stream)
        else:
            err = _lib().dpfx_fused_train_fwd(
                xt.data_ptr(), hz.data_ptr(), u.data_ptr(), ld_part.data_ptr(), *weights,
                b, n, k, h, nh1, float(cap), int(dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused train forward kernel launch failed ({layout} layout): "
                           f"cudaError {err} ({_error_text(err)})")
    launches["fused_train_fwd"] += 1
    layout_launches[f"{layout}_fwd"] += 1
    return u, ld_part.sum(1)


def _backward_call(wx, wh, bh, wout, bout, masks, cap, u, hz, du, dld, dtype):
    """Launch the backward kernel and the reductions of its partials.
    Returns (y, dx, dw, dhz): y is the layer input the kernel rebuilt last
    (the flow's input, rebuilt from u), dw the [K, per-layer] gradients (the
    f32 layout and the cluster layout's walk pad a layer's row to a multiple
    of 4 floats at its end)."""
    k, h, _ = wx.shape
    nh1 = wh.shape[1]
    b, _, n = u.shape
    _check(wx, dtype, dict(wx=wx, wh=wh, bh=bh, wout=wout, bout=bout, masks=masks, u=u, hz=hz,
                           du=du, dld=dld))
    layout = _layout(h, nh1, dtype, backward=True)
    nt = _tiles(n, dtype, True, layout, (h, nh1))
    dev = u.device
    blocks = min(b * nt, _cluster_grid(h, nh1, True, dev.index or 0) if layout == "cluster"
                 else _sm_count(dev))
    per_layer = 3 * h + nh1 * h * h + nh1 * h + 6 * h + 6
    if layout == "f32":   # each layer's partial padded to a multiple of 4 floats
        per_layer = _f32_lib().dpfx_fused_train_f32_part_row(h, nh1)
    elif layout == "cluster":   # padded where the backward walks
        per_layer = _cluster_lib().dpfx_fused_train_cluster_part_row(h, nh1)
    part = torch.empty((blocks, k, per_layer), device=dev, dtype=torch.float32)
    dhz_part = torch.empty((b, nt, k, h), device=dev, dtype=torch.float32)
    dw = torch.empty((k, per_layer), device=dev, dtype=torch.float32)
    dhz = torch.empty((b, k, h), device=dev, dtype=torch.float32)
    cwx, cwh, cwout = _weights(wx, wh, wout, dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    weights = [cwx.data_ptr(), cwh.data_ptr() if nh1 else None, bh.data_ptr() if nh1 else None,
               cwout.data_ptr(), bout.data_ptr(), masks.data_ptr()]
    with torch.cuda.device(dev):
        if layout == "cluster":
            y, dx = torch.empty_like(u), torch.empty_like(du)
            carry = torch.empty((h // CLUSTER_COLUMNS, b, 9, n), device=dev, dtype=torch.float32)
            err = _cluster_lib().dpfx_fused_train_cluster_bwd(
                u.data_ptr(), du.data_ptr(), y.data_ptr(), dx.data_ptr(), carry.data_ptr(),
                dld.data_ptr(), hz.data_ptr(), *weights, part.data_ptr(), dhz_part.data_ptr(),
                dw.data_ptr(), dhz.data_ptr(), b, n, k, h, nh1, float(cap), blocks, stream)
        elif layout == "f32":
            y, dx = u.clone(), du.clone()
            err = _f32_lib().dpfx_fused_train_f32_bwd(
                y.data_ptr(), dx.data_ptr(), dld.data_ptr(), hz.data_ptr(), *weights,
                part.data_ptr(), dhz_part.data_ptr(), dw.data_ptr(), dhz.data_ptr(),
                b, n, k, h, nh1, float(cap), blocks, stream)
        else:
            y, dx = u.clone(), du.clone()
            err = _lib().dpfx_fused_train_bwd(
                y.data_ptr(), dx.data_ptr(), dld.data_ptr(), hz.data_ptr(), *weights,
                part.data_ptr(), dhz_part.data_ptr(), dw.data_ptr(), dhz.data_ptr(),
                b, n, k, h, nh1, float(cap), int(dtype == torch.bfloat16), blocks, stream)
    if err != 0:
        raise RuntimeError(f"fused train backward kernel launch failed ({layout} layout): "
                           f"cudaError {err} ({_error_text(err)})")
    launches["fused_train_bwd"] += 1
    layout_launches[f"{layout}_bwd"] += 1
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
