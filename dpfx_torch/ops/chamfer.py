"""Chamfer distance: per-point squared nearest-neighbour distances with
their gradients, and the pairwise CD matrix, through the CUDA kernels of
``csrc/chamfer.cu``.

Counterpart of ``dpfx/ops/chamfer.py``. Its Pallas kernels
``_nnd_fwd_pallas`` (diagonal pairs) and ``_cd_pallas_pairwise`` (the
[S1, S2] matrix) become one kernel over a list of cloud pairs, and
``_nnd_bwd_pallas`` (the backward of ``nn_distances``) a second one; see
the source for the design and what bounds each.

    dl[i] = min_j ||x_i - y_j||^2,  dr[j] = min_i ||x_i - y_j||^2
    CD(X, Y) = mean_i dl[i] + mean_j dr[j]

Squared distances are ``max((|x|^2 + |y|^2) - 2 x.y, 0)`` with every
operation rounded on its own, in IEEE f32 whatever
``torch.backends.cuda.matmul.allow_tf32`` says (the products are
elementwise, not a matmul): the kernel computes the same expression, so a
distance is equal in both bit for bit. ``precision="fast"`` rounds the
coordinates to bf16 for x.y (the norms stay f32) and each distance to bf16,
as the Pallas fast mode does.

``nn_distances``, ``chamfer`` and ``chamfer_parts`` are differentiable, as
``dpfx``'s are: the backward tests ``d <= dmin`` against the forward's own
minima (the same distances, bit for bit) and splits a tie's gradient
evenly, as ``_nnd_bwd_pallas`` does (not one argmin, as ``impl="jnp"``
does). ``chamfer_pairwise`` has no gradient, as in ``dpfx``: an input that
requires grad raises.

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises). ``launches`` counts the
kernel launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from dpfx_torch.ops._build import SMEM_LIMIT

Tensor = torch.Tensor

# kernel launches per wrapper; chip_smoke.py zeroes these around the main path
launches: Dict[str, int] = {"nnd_fwd": 0, "nnd_bwd": 0, "cd_pairwise": 0}

MAX_POINTS = 4096          # the kernels keep both clouds of a pair in shared memory
PLAIN_CHUNK_ELEMS = 2**26  # distance elements per chunk of a plain version (256 MB f32)


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def refuse_grad(what: str, *ts: Tensor) -> None:
    """Raise for an input that requires grad: ``what`` has no gradient, as
    in ``dpfx`` (whose function of that name has no VJP)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(f"{what} has no gradient, as in dpfx: call it under "
                                  "torch.no_grad() or on detached inputs")


# ---------------------------------------------------------------- plain versions

def _norm2(x: Tensor) -> Tensor:
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def sqdist_matrix(x: Tensor, y: Tensor, fast: bool = False) -> Tensor:
    """[.., N, 3], [.., M, 3] -> [.., N, M] squared distances in IEEE f32
    (f64 for f64 inputs, a reference), ``max((|x|^2 + |y|^2) - 2 x.y, 0)``.
    ``fast``: x.y from bf16-rounded coordinates and the result rounded to
    bf16 (returned as f32)."""
    if x.dtype != torch.float64:
        x, y = x.float(), y.float()
    x2, y2 = _norm2(x), _norm2(y)
    if fast:
        x, y = x.bfloat16().float(), y.bfloat16().float()
    xy = (x[..., :, None, 0] * y[..., None, :, 0] + x[..., :, None, 1] * y[..., None, :, 1]
          + x[..., :, None, 2] * y[..., None, :, 2])
    d = torch.clamp_min(x2[..., :, None] + y2[..., None, :] - 2.0 * xy, 0.0)
    return d.bfloat16().float() if fast else d


def _pair_chunk(n: int, m: int) -> int:
    return max(1, PLAIN_CHUNK_ELEMS // (n * m))


def nn_distances_plain(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(dl [B,N], il [B,N], dr [B,M], ir [B,M]): the minima and their argmins."""
    out = []
    step = _pair_chunk(x.shape[-2], y.shape[-2])
    for s in range(0, x.shape[0], step):
        d = sqdist_matrix(x[s:s + step], y[s:s + step])
        dl, il = d.min(dim=-1)
        dr, ir = d.min(dim=-2)
        out.append((dl, il.int(), dr, ir.int()))
    return tuple(torch.cat(parts) for parts in zip(*out))


def nn_distances_backward_plain(x: Tensor, y: Tensor, dl: Tensor, dr: Tensor, gl: Tensor,
                                gr: Tensor) -> Tuple[Tensor, Tensor]:
    """(gx [B,N,3], gy [B,M,3]): the backward of the minima dl [B,N], dr [B,M]
    for the cotangents gl [B,N], gr [B,M], as ``_nnd_bwd_pallas`` computes it:
    the nearest neighbours are the masks d <= dl_i (rows) and d <= dr_j
    (columns) on the same distances as the forward, and a tie splits the
    gradient evenly. In f32 (f64 for f64 inputs, a reference)."""
    out = []
    step = _pair_chunk(x.shape[-2], y.shape[-2])
    for s in range(0, x.shape[0], step):
        xc, yc = x[s:s + step], y[s:s + step]
        d = sqdist_matrix(xc, yc)
        xc, yc = xc.to(d.dtype), yc.to(d.dtype)
        glc, grc = gl[s:s + step].to(d.dtype), gr[s:s + step].to(d.dtype)
        maskl = (d <= dl[s:s + step, :, None]).to(d.dtype)
        maskr = (d <= dr[s:s + step, None, :]).to(d.dtype)
        wl = glc[..., None] * maskl / maskl.sum(-1, keepdim=True).clamp_min(1.0)
        wr = grc[:, None, :] * maskr / maskr.sum(-2, keepdim=True).clamp_min(1.0)
        gx = (2.0 * glc[..., None] * xc - 2.0 * (wl @ yc)
              + 2.0 * xc * wr.sum(-1, keepdim=True) - 2.0 * (wr @ yc))
        gy = (2.0 * yc * (grc + wl.sum(-2))[..., None] - 2.0 * (wl.transpose(1, 2) @ xc)
              - 2.0 * (wr.transpose(1, 2) @ xc))
        out.append((gx, gy))
    return tuple(torch.cat(parts) for parts in zip(*out))


def chamfer_plain(x: Tensor, y: Tensor) -> Tensor:
    """CD per diagonal pair through the plain minima: [B,N,3], [B,M,3] -> [B]."""
    dl, _, dr, _ = nn_distances_plain(x, y)
    return dl.mean(-1) + dr.mean(-1)


def chamfer_pairwise_plain(xs: Tensor, ys: Tensor, precision: str = "exact") -> Tensor:
    """[S1,N,3] x [S2,M,3] -> [S1,S2] CD matrix, pairs taken in chunks."""
    fast = _fast(precision)
    s1, s2 = xs.shape[0], ys.shape[0]
    ii, jj = torch.meshgrid(torch.arange(s1, device=xs.device), torch.arange(s2, device=xs.device),
                            indexing="ij")
    ii, jj = ii.flatten(), jj.flatten()
    out = torch.empty(s1 * s2, dtype=torch.float32, device=xs.device)
    step = _pair_chunk(xs.shape[1], ys.shape[1])
    for s in range(0, s1 * s2, step):
        d = sqdist_matrix(xs[ii[s:s + step]], ys[jj[s:s + step]], fast)
        out[s:s + step] = d.min(dim=-1)[0].mean(-1) + d.min(dim=-2)[0].mean(-1)
    return out.view(s1, s2)


def _fast(precision: str) -> bool:
    if precision not in ("exact", "fast"):
        raise ValueError(f"precision must be 'exact' or 'fast', got {precision!r}")
    return precision == "fast"


# ---------------------------------------------------------------- kernel launch

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from dpfx_torch.ops import _build

    lib = _build.load("chamfer")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dpfx_chamfer_launch.argtypes = [p, p, p, i, i, i, i, p, p, p, p]
    lib.dpfx_chamfer_launch.restype = ctypes.c_int
    lib.dpfx_chamfer_smem_bytes.argtypes = [i, i]
    lib.dpfx_chamfer_smem_bytes.restype = ctypes.c_int
    lib.dpfx_nnd_bwd_launch.argtypes = [p, p, i, i, i, p, p, p, p, p, p, p]
    lib.dpfx_nnd_bwd_launch.restype = ctypes.c_int
    lib.dpfx_nnd_bwd_smem_bytes.argtypes = [i, i]
    lib.dpfx_nnd_bwd_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of one block, as the kernel library reports it."""
    return _lib().dpfx_chamfer_smem_bytes(n, m)


def bwd_smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of one block of the backward kernel."""
    return _lib().dpfx_nnd_bwd_smem_bytes(n, m)


def check_clouds(xs: Tensor, ys: Tensor, smem: int) -> Tuple[Tensor, Tensor]:
    """The kernels' conditions on a pair of cloud stacks (shared with the
    EMD wrappers): CUDA, one device, [S, N, 3], N and M in 1..MAX_POINTS.
    Returns both as contiguous float32."""
    if not (xs.is_cuda and ys.device == xs.device):
        raise ValueError(f"both clouds must be CUDA tensors on one device, got {xs.device}, {ys.device}")
    if xs.dim() != 3 or ys.dim() != 3 or xs.shape[-1] != 3 or ys.shape[-1] != 3:
        raise ValueError(f"clouds must be [S, N, 3], got {tuple(xs.shape)} and {tuple(ys.shape)}")
    n, m = xs.shape[1], ys.shape[1]
    if not (0 < n <= MAX_POINTS and 0 < m <= MAX_POINTS):
        raise ValueError(f"the kernels take 1..{MAX_POINTS} points per cloud, got N={n}, M={m}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"N={n}, M={m} needs {smem} B of shared memory, more than {SMEM_LIMIT}")
    return xs.float().contiguous(), ys.float().contiguous()


def pair_list(s1: int, s2: int, mode: str, device) -> Tensor:
    """[P, 2] int32 (left, right) cloud indices: "diag" (i, i), "full" every
    (i, j) row-major, "upper" the pairs j >= i of a square matrix."""
    if mode == "diag":
        ar = torch.arange(s1, device=device, dtype=torch.int32)
        return torch.stack([ar, ar], dim=1)
    if mode == "upper":
        return torch.triu_indices(s1, s2, device=device).t().int().contiguous()
    ii, jj = torch.meshgrid(torch.arange(s1, device=device), torch.arange(s2, device=device),
                            indexing="ij")
    return torch.stack([ii.flatten(), jj.flatten()], dim=1).int().contiguous()


def _launch(xs: Tensor, ys: Tensor, pairs: Tensor, fast: bool, cd=None, dl=None, dr=None) -> None:
    n, m = xs.shape[1], ys.shape[1]
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):
        err = _lib().dpfx_chamfer_launch(xs.data_ptr(), ys.data_ptr(), pairs.data_ptr(),
                                         pairs.shape[0], n, m, int(fast), ptr(cd), ptr(dl), ptr(dr),
                                         stream)
    if err != 0:
        raise RuntimeError(f"chamfer kernel launch failed: cudaError {err}")


def nnd_forward(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    """(dl [B,N], dr [B,M]) of diagonal pairs: the kernel for CUDA tensors,
    the plain version for CPU tensors. No autograd."""
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"diagonal pairs need equal batches, got {x.shape[0]} and {y.shape[0]}")
    if not x.is_cuda:
        dl, _, dr, _ = nn_distances_plain(x, y)
        return dl, dr
    x, y = check_clouds(x, y, smem_bytes(x.shape[1], y.shape[1]))
    b = x.shape[0]
    dl = torch.empty((b, x.shape[1]), dtype=torch.float32, device=x.device)
    dr = torch.empty((b, y.shape[1]), dtype=torch.float32, device=x.device)
    _launch(x, y, pair_list(b, b, "diag", x.device), False, dl=dl, dr=dr)
    launches["nnd_fwd"] += 1
    return dl, dr


def nnd_backward(x: Tensor, y: Tensor, dl: Tensor, dr: Tensor, gl: Tensor,
                 gr: Tensor) -> Tuple[Tensor, Tensor]:
    """(gx [B,N,3], gy [B,M,3]) from the forward's own minima dl, dr and the
    cotangents gl, gr: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if not x.is_cuda:
        return nn_distances_backward_plain(x, y, dl, dr, gl, gr)
    x, y = check_clouds(x, y, bwd_smem_bytes(x.shape[1], y.shape[1]))
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    if y.shape[0] != b or dl.shape != (b, n) or dr.shape != (b, m) or gl.shape != (b, n) \
            or gr.shape != (b, m):
        raise ValueError(f"nnd_backward shapes: x {tuple(x.shape)}, y {tuple(y.shape)}, dl "
                         f"{tuple(dl.shape)}, dr {tuple(dr.shape)}, gl {tuple(gl.shape)}, gr "
                         f"{tuple(gr.shape)}")
    vecs = [t.float().contiguous() for t in (dl, dr, gl, gr)]
    if any(t.device != x.device for t in vecs):
        raise ValueError("dl, dr, gl and gr must lie on the clouds' device")
    gx = torch.empty_like(x)
    gy = torch.empty_like(y)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().dpfx_nnd_bwd_launch(x.data_ptr(), y.data_ptr(), b, n, m,
                                         *(t.data_ptr() for t in vecs), gx.data_ptr(),
                                         gy.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nnd_bwd kernel launch failed: cudaError {err}")
    launches["nnd_bwd"] += 1
    return gx, gy


class _NNDistances(torch.autograd.Function):
    """``dpfx``'s ``nn_distances`` custom VJP: the backward reads the
    forward's minima, so its masks see the same distances."""

    @staticmethod
    def forward(ctx, x, y):
        dl, dr = nnd_forward(x, y)
        ctx.save_for_backward(x, y, dl, dr)
        return dl, dr

    @staticmethod
    @once_differentiable
    def backward(ctx, gl, gr):
        x, y, dl, dr = ctx.saved_tensors
        gl = torch.zeros_like(dl) if gl is None else gl
        gr = torch.zeros_like(dr) if gr is None else gr
        gx, gy = nnd_backward(x, y, dl, dr, gl, gr)
        return gx.to(x.dtype), gy.to(y.dtype)


# ---------------------------------------------------------------- public wrappers

def nn_distances(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    """(dl [B,N], dr [B,M]): squared NN distances both ways, diagonal pairs
    x [B,N,3], y [B,M,3]; differentiable in x and y."""
    return _NNDistances.apply(x, y)


def chamfer(x: Tensor, y: Tensor) -> Tensor:
    """CD per diagonal pair: x [B,N,3], y [B,M,3] -> [B]."""
    dl, dr = nn_distances(x, y)
    return dl.mean(-1) + dr.mean(-1)


def chamfer_parts(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    """Both directional means separately."""
    dl, dr = nn_distances(x, y)
    return dl.mean(-1), dr.mean(-1)


def chamfer_pairwise(xs: Tensor, ys: Tensor, precision: str = "exact",
                     symmetric: bool = False) -> Tensor:
    """Full pairwise CD matrix: xs [S1,N,3], ys [S2,M,3] -> [S1,S2].

    ``symmetric=True`` (a self-comparison: S1 == S2 and N == M) computes only
    the upper triangle and mirrors it: CD(x, y) == CD(y, x) exactly, so the
    matrix is the same at about half the cost."""
    refuse_grad("chamfer_pairwise", xs, ys)
    fast = _fast(precision)
    s1, n = xs.shape[0], xs.shape[1]
    s2, m = ys.shape[0], ys.shape[1]
    if symmetric and (s1 != s2 or n != m):
        raise ValueError("symmetric=True needs a self-comparison (S1==S2, N==M)")
    if not xs.is_cuda:
        return chamfer_pairwise_plain(xs, ys, precision)
    xs, ys = check_clouds(xs, ys, smem_bytes(n, m))
    pairs = pair_list(s1, s2, "upper" if symmetric else "full", xs.device)
    cd = torch.empty(pairs.shape[0], dtype=torch.float32, device=xs.device)
    _launch(xs, ys, pairs, fast, cd=cd)
    launches["cd_pairwise"] += 1
    if not symmetric:
        return cd.view(s1, s2)
    out = torch.empty((s1, s2), dtype=torch.float32, device=xs.device)
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    out[i, j] = cd
    out[j, i] = cd
    return out
