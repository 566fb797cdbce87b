"""Fused PointNet encoder: the per-point MLP and the max-pool over the
points, forward and backward.

Replaces the two Pallas TPU kernels of ``dpfx/ops/fused_encoder.py``:
``_fwd_kernel`` (per-point MLP 3->128->128->256->512 in the flagship, relu,
max over the points) and ``_bwd_kernel`` (recompute, max-pool VJP, dx and
the gradients of every point layer). The CUDA kernels are in
``csrc/fused_encoder.cu``; see its header for the design and what bounds
them. ``_FusedPool`` wraps them as one ``torch.autograd.Function``.

Rounding follows flax's ``nn.Dense(dtype=compute_dtype)``, as the Pallas
kernel does: operands in the compute dtype, the product accumulated in
float32 and rounded to the compute dtype, the bias added in the compute
dtype, relu in the compute dtype. The pooled feature is float32.

Max-pool ties follow ``jnp.max``'s VJP: the cotangent splits evenly among
every point of the cloud that reaches the maximum (mask / count), and a
feature whose maximum is 0 (every pre-activation <= 0) gets none, through
relu' of the last layer. The forward emits each tile's maximum and the
count of its points at that maximum, so the backward knows the count over
the whole cloud before it starts. The backward's cotangent reaches only a
cloud's critical points (those at some live feature's maximum), so it
selects them first and walks the layers down on them alone
(``pool_backward_plain`` says how).

The FC heads stay in torch (``fused_pointnet_posterior``). Every wrapper
takes its plain PyTorch version for a tensor on the CPU and launches the
kernels for a CUDA tensor (or raises); ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from dpfx_torch.models.coupling import dense
from dpfx_torch.models.encoders import PointNetEncoder
from dpfx_torch.ops.fused_sampler import SMEM_LIMIT

Tensor = torch.Tensor

# kernel launches per wrapper; chip_smoke.py zeroes these around the main path
launches: Dict[str, int] = {"fused_encoder_fwd": 0, "fused_encoder_bwd": 0}

MAX_LAYERS = 8          # point layers the kernels take


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def fused_encoder_supported(enc_cfg) -> bool:
    """relu point layers, 1..MAX_LAYERS of them, of any widths whose
    padding to multiples of 16 (``pad_point_layers``) fits a block's shared
    memory in the compute dtype (``smem_mirror``). The kernels tile the
    points, so unlike the Pallas kernel (one whole cloud per grid step,
    N <= 8192) any N is taken."""
    widths = list(enc_cfg.point_widths)
    if enc_cfg.activation != "relu" or not 1 <= len(widths) <= MAX_LAYERS \
            or min(widths) < 1:
        return False
    dtype = torch.bfloat16 if enc_cfg.compute_dtype == "bfloat16" else torch.float32
    return smem_mirror([3] + [padded(w) for w in widths], dtype) <= SMEM_LIMIT


def padded(width: int) -> int:
    """A point width rounded up to the kernels' multiple of 16."""
    return -(-width // 16) * 16


def pad_point_layers(ws: Sequence[Tensor], bs: Sequence[Tensor]
                     ) -> Tuple[List[Tensor], List[Tensor]]:
    """The point layers with every width zero-padded to a multiple of 16
    (the input's 3 columns stay). Exact: a padded channel has zero weights
    and bias, so it is relu(0) = 0, and the next layer's columns for it are
    zero; the last layer's padded channels pool to 0 and are dropped before
    the head. Differentiable (``F.pad``: the padded entries' gradients are
    dropped)."""
    pws, pbs = [], []
    for w, b in zip(ws, bs):
        o, i = w.shape
        po, pi = padded(o) - o, (padded(i) - i if i != 3 else 0)
        pws.append(F.pad(w, (0, pi, 0, po)) if po or pi else w)
        pbs.append(F.pad(b, (0, po)) if po else b)
    return pws, pbs


def encoder_point_weights(encoder: PointNetEncoder) -> Tuple[List[Tensor], List[Tensor]]:
    """The point layers' weights [out, in] and biases [out], as the module's
    own parameters (gradients reach them)."""
    layers = [getattr(encoder, f"point_{i}") for i in range(encoder.n_point)]
    return [m.weight for m in layers], [m.bias for m in layers]


# ---------------------------------------------------------------- plain version

def _chain(ws: Sequence[Tensor], bs: Sequence[Tensor], x: Tensor, dtype: torch.dtype
           ) -> List[Tensor]:
    """[x f32, h_1 .. h_L in dtype]: Dense rounding, relu in dtype."""
    hs = [x.float()]
    for w, b in zip(ws, bs):
        y = (hs[-1].to(dtype).float() @ w.to(dtype).float().t()).to(dtype) + b.to(dtype)
        hs.append(torch.relu(y))
    return hs


def pool_forward_plain(ws: Sequence[Tensor], bs: Sequence[Tensor], x: Tensor,
                       dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
    """x [B, N, 3] -> (g [B, W] f32 max over the points, count [B, W] f32 of
    the points at that max)."""
    h = _chain(ws, bs, x, dtype)[-1].float()
    g = h.amax(1)
    return g, (h == g[:, None]).sum(1).float()


def pool_backward_plain(ws: Sequence[Tensor], bs: Sequence[Tensor], x: Tensor, g: Tensor,
                        cnt: Tensor, dg: Tensor, dtype: torch.dtype):
    """The backward kernels' arithmetic, in their three steps.

    Select: the chain over every point and the tie mask of the last layer,
    h_L == g where g > 0 (on a tie h_L > 0 <=> g > 0); a point with a tie
    bit is critical. Gather the critical points, cloud by cloud in point
    order. Walk: recompute h_1 .. h_{L-1} on them alone, dh_L = mask * dg /
    max(count, 1), and the reverse walk with every cotangent rounded to
    ``dtype`` before a product. Every other point adds exactly 0 to every
    gradient, and its dx is 0. Returns (dx [B, N, 3], [dW_i], [db_i]),
    float32."""
    rnd = lambda a: a.to(dtype).float()
    h_last = _chain(ws, bs, x, dtype)[-1].float()
    mask = (h_last == g[:, None]) & (g[:, None] > 0)
    bi, ni = mask.any(-1).nonzero(as_tuple=True)
    hs = _chain(ws[:-1], bs[:-1], x[bi, ni], dtype)
    dh = torch.where(mask[bi, ni], (dg / cnt.clamp_min(1.0))[bi], 0.0)
    dws, dbs = [None] * len(ws), [None] * len(ws)
    for i in reversed(range(len(ws))):
        dws[i] = rnd(dh).t() @ rnd(hs[i])
        dbs[i] = dh.sum(0)
        dh = rnd(dh) @ rnd(ws[i])
        if i > 0:
            dh = dh * (hs[i].float() > 0)
    dx = torch.zeros_like(x, dtype=torch.float32)
    dx[bi, ni] = dh
    return dx, dws, dbs


# ---------------------------------------------------------------- kernel launch

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from dpfx_torch.ops import _build

    lib = _build.load("fused_encoder")
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    pp = ctypes.POINTER(ctypes.c_void_p)
    lib.dpfx_fused_encoder_fwd.argtypes = [
        p, pp, pp, ip, i,             # x [B, N, 3], weights, biases, widths, L
        p, p,                         # tile max [B, nt, W], tile count [B, nt, W]
        i, i, i, p,                   # B, N, bf16, stream
    ]
    lib.dpfx_fused_encoder_bwd.argtypes = [
        p, pp, pp, ip, i,             # x, weights, biases, widths, L
        p, p, p,                      # g [B, W], count [B, W], dg [B, W]
        p, p, p, p,                   # dx [B, N, 3], per-block partials, reduced grads, rows
        i, i, i, i, p,                # B, N, bf16, blocks, stream
    ]
    lib.dpfx_fused_encoder_smem_bytes.argtypes = [ip, i, i]
    lib.dpfx_fused_encoder_tile_points.argtypes = [ip, i, i]
    lib.dpfx_fused_encoder_bwd_blocks.argtypes = [ip, i, i, i, i, i]
    lib.dpfx_fused_encoder_bwd_scratch_bytes.argtypes = [ip, i, i, i, i]
    for fn in (lib.dpfx_fused_encoder_fwd, lib.dpfx_fused_encoder_bwd,
               lib.dpfx_fused_encoder_smem_bytes, lib.dpfx_fused_encoder_tile_points,
               lib.dpfx_fused_encoder_bwd_blocks):
        fn.restype = ctypes.c_int
    lib.dpfx_fused_encoder_bwd_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _widths(widths: Sequence[int]):
    return (ctypes.c_int * len(widths))(*widths), len(widths) - 1


def _tiles(widths: Sequence[int], n: int, dtype: torch.dtype) -> int:
    """Forward tiles of a cloud of n points, at the kernel library's points
    per tile for these widths and dtype."""
    t = _lib().dpfx_fused_encoder_tile_points(*_widths(widths), int(dtype == torch.bfloat16))
    return (n + t - 1) // t


def smem_bytes(widths: Sequence[int], dtype: torch.dtype) -> int:
    """The most dynamic shared memory one block of the mode's kernels takes,
    as the kernel library lays it out; ``widths`` = (3, W_1 .. W_L)."""
    return _lib().dpfx_fused_encoder_smem_bytes(*_widths(widths), int(dtype == torch.bfloat16))


def smem_mirror(widths: Sequence[int], dtype: torch.dtype) -> int:
    """``smem_bytes`` computed here, byte for byte the kernel library's
    carve-ups (``csrc/fused_encoder.cu``: ``EncSmem`` of the block-wide
    design; in bf16 the rows design's ``TileSmem`` and ``WalkSmem`` where
    it fits, as ``rows_design`` decides); ``widths`` = (3, W_1 .. W_L),
    multiples of 16."""
    r = lambda n: (n + 127) // 128 * 128
    nl = len(widths) - 1

    def block(es, pad, t):
        return (r(t * 3 * 4) + sum(r(t * (w + pad) * es) for w in widths[1:])
                + r(8 * 256 * 4) + r(t // 16 * max(widths[1:]) * 4))

    if dtype != torch.bfloat16:
        return block(4, 1, 32)
    stored = max(widths[1:nl], default=0)
    mw = -(-widths[nl] // 32)
    ld0 = widths[1] + 8
    tile = r(8 * 16 * (stored + 8) * 2) + (r(2 * 32 * (stored + 8) * 2) if nl > 1 else 0) \
        + r(8 * ld0 * 2)
    fwd, sel = tile + r(2 * 8 * 32 * 8), tile + r(128 * mw * 4) + r(128 * 4)
    walk = (sum(r(64 * (w + 8) * 2) for w in widths[1:nl]) + r(64 * (widths[nl] + 8) * 2)
            + (r(2 * 64 * (stored + 8) * 2) if nl > 1 else 0) + r(8 * ld0 * 2)
            + r(64 * mw * 4) + r(4 * (stored + 1) * 4) + r(64 * 3 * 4) + 4 * r(64 * 4)
            + r(8 * 4))
    if stored <= 16 * 16 and max(fwd, sel, walk) <= SMEM_LIMIT:
        return max(fwd, sel, walk)
    return block(2, 8, 64)


def _check(ws, x, dtype, extra: Dict[str, Tensor]) -> List[int]:
    widths = [3] + [int(w.shape[0]) for w in ws]
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel compute dtype must be float32 or bfloat16, got {dtype}")
    if not 1 <= len(ws) <= MAX_LAYERS:
        raise ValueError(f"the fused encoder kernels take 1..{MAX_LAYERS} point layers, "
                         f"got {len(ws)}")
    if any(w % 16 for w in widths[1:]):
        raise ValueError(f"the fused encoder kernels need point widths that are multiples "
                         f"of 16, got {widths[1:]}")
    need = smem_bytes(widths, dtype)
    if need > SMEM_LIMIT:
        raise ValueError(f"point widths {widths[1:]} in {dtype} need {need} B of shared "
                         f"memory, more than the {SMEM_LIMIT} B a block may use")
    for name, t in [("x", x)] + list(extra.items()):
        if not (t.is_cuda and t.device == x.device):
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, is on {t.device}")
        if not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    return widths


def _operands(ws, bs, widths, dtype):
    """Weights and biases in the compute dtype, and the ctypes arrays of
    their pointers (the tensors are returned to keep them alive)."""
    cws = [w.detach().to(dtype).contiguous() for w in ws]
    cbs = [b.detach().to(dtype).contiguous() for b in bs]
    n = len(ws)
    wp = (ctypes.c_void_p * n)(*[w.data_ptr() for w in cws])
    bp = (ctypes.c_void_p * n)(*[b.data_ptr() for b in cbs])
    wd = (ctypes.c_int * (n + 1))(*widths)
    return cws, cbs, wp, bp, wd


def pool_forward_kernel(ws, bs, x, dtype):
    """The forward kernel: same contract as ``pool_forward_plain``. The
    kernel writes each tile's max and its count at that max; the per-cloud
    max and count follow in two small torch reductions."""
    widths = _check(ws, x, dtype, {})
    b, n, _ = x.shape
    pmax = torch.empty((b, _tiles(widths, n, dtype), widths[-1]), device=x.device,
                       dtype=torch.float32)
    pcnt = torch.empty_like(pmax)
    keep = _operands(ws, bs, widths, dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().dpfx_fused_encoder_fwd(
            x.data_ptr(), keep[2], keep[3], keep[4], len(ws), pmax.data_ptr(), pcnt.data_ptr(),
            b, n, int(dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused encoder forward kernel launch failed: cudaError {err}")
    launches["fused_encoder_fwd"] += 1
    g = pmax.amax(1)
    return g, ((pmax == g[:, None]) * pcnt).sum(1)


def pool_backward_kernel(ws, bs, x, g, cnt, dg, dtype):
    """The backward kernels (bf16: select, then the walk over the critical
    rows on a persistent grid; f32: one persistent kernel), then the
    fixed-order reduction of the grid's gradient slices: same contract as
    ``pool_backward_plain``, bit-identical from run to run, and no host
    sync (the number of critical rows stays on the card)."""
    widths = _check(ws, x, dtype, dict(g=g, cnt=cnt, dg=dg))
    b, n, _ = x.shape
    bf = int(dtype == torch.bfloat16)
    wd, nl = _widths(widths)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = _lib().dpfx_fused_encoder_bwd_blocks(wd, nl, bf, b, n, sms)
    scratch = _lib().dpfx_fused_encoder_bwd_scratch_bytes(wd, nl, bf, b, n)
    sizes = [widths[i + 1] * widths[i] for i in range(len(ws))] + widths[1:]
    dx = torch.empty_like(x)
    part = torch.empty((blocks, sum(sizes)), device=x.device, dtype=torch.float32)
    flat = torch.empty(sum(sizes), device=x.device, dtype=torch.float32)
    rows = torch.empty(max(scratch, 1), device=x.device, dtype=torch.uint8)
    keep = _operands(ws, bs, widths, dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().dpfx_fused_encoder_bwd(
            x.data_ptr(), keep[2], keep[3], keep[4], len(ws), g.data_ptr(), cnt.data_ptr(),
            dg.data_ptr(), dx.data_ptr(), part.data_ptr(), flat.data_ptr(), rows.data_ptr(),
            b, n, bf, blocks, stream)
    if err != 0:
        raise RuntimeError(f"fused encoder backward kernel launch failed: cudaError {err}")
    launches["fused_encoder_bwd"] += 1
    pieces = list(torch.split(flat, sizes))
    dws = [p.view(widths[i + 1], widths[i]) for i, p in enumerate(pieces[:len(ws)])]
    return dx, dws, pieces[len(ws):]


# ---------------------------------------------------------------- autograd

class _FusedPool(torch.autograd.Function):
    """(x, dtype, *weights, *biases) -> pooled g [B, W_last] float32."""

    @staticmethod
    def forward(ctx, x, dtype, *params):
        n = len(params) // 2
        ws, bs = params[:n], params[n:]
        x = x.float().contiguous()
        fwd = pool_forward_kernel if x.is_cuda else pool_forward_plain
        g, cnt = fwd(ws, bs, x, dtype)
        ctx.save_for_backward(x, g, cnt, *params)
        ctx.dtype = dtype
        return g

    @staticmethod
    def backward(ctx, dg):
        x, g, cnt, *params = ctx.saved_tensors
        n = len(params) // 2
        bwd = pool_backward_kernel if x.is_cuda else pool_backward_plain
        dx, dws, dbs = bwd(params[:n], params[n:], x, g, cnt, dg.float().contiguous(),
                           ctx.dtype)
        return (dx, None, *dws, *dbs)


def fused_pointnet_posterior(encoder: PointNetEncoder, x: Tensor) -> Tuple[Tensor, Tensor]:
    """(mu, logvar) of q(z|X) through the fused pooled-feature kernels.
    Drop-in for ``encoder(x)``: the same math, the FC heads in torch."""
    ws, bs = encoder_point_weights(encoder)
    width = ws[-1].shape[0]
    g = _FusedPool.apply(x, encoder.dtype, *(t for ts in pad_point_layers(ws, bs) for t in ts))
    g = g[:, :width]   # the padded channels' pool is dropped before the head
    for i in range(encoder.n_head):
        g = encoder.act(dense(getattr(encoder, f"head_{i}"), g, encoder.dtype))
    mu, logvar = dense(encoder.gauss, g, encoder.dtype).float().chunk(2, dim=-1)
    return mu, torch.clamp(logvar, -10.0, 10.0)
