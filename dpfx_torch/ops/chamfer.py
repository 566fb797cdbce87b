"""Chamfer distance: per-point squared nearest-neighbour distances and the
pairwise CD matrix, through one CUDA kernel (``csrc/chamfer.cu``).

Counterpart of ``dpfx/ops/chamfer.py``. Its Pallas kernels
``_nnd_fwd_pallas`` (diagonal pairs) and ``_cd_pallas_pairwise`` (the
[S1, S2] matrix) become one kernel over a list of cloud pairs; see its
header for the design and what bounds it.

    dl[i] = min_j ||x_i - y_j||^2,  dr[j] = min_i ||x_i - y_j||^2
    CD(X, Y) = mean_i dl[i] + mean_j dr[j]

Squared distances are ``max((|x|^2 + |y|^2) - 2 x.y, 0)`` with every
operation rounded on its own, in IEEE f32 whatever
``torch.backends.cuda.matmul.allow_tf32`` says (the products are
elementwise, not a matmul): the kernel computes the same expression, so a
distance is equal in both bit for bit. ``precision="fast"`` rounds the
coordinates to bf16 for x.y (the norms stay f32) and each distance to bf16,
as the Pallas fast mode does.

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises). ``launches`` counts the
kernel launches of each wrapper. Gradients are not ported (ROADMAP Queue 2
#8): an input that requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from dpfx_torch.ops._build import SMEM_LIMIT

Tensor = torch.Tensor

# kernel launches per wrapper; chip_smoke.py zeroes these around the main path
launches: Dict[str, int] = {"nnd_fwd": 0, "cd_pairwise": 0}

MAX_POINTS = 4096          # the kernels keep both clouds of a pair in shared memory
PLAIN_CHUNK_ELEMS = 2**26  # distance elements per chunk of a plain version (256 MB f32)


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _no_grad_ported(*ts: Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError("the gradients of the CD and EMD kernels are not ported yet "
                                  "(ROADMAP Queue 2 #8): call under torch.no_grad() or detach")


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
    return lib


def smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of one block, as the kernel library reports it."""
    return _lib().dpfx_chamfer_smem_bytes(n, m)


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


# ---------------------------------------------------------------- public wrappers

def nn_distances(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    """(dl [B,N], dr [B,M]): squared NN distances both ways, diagonal pairs
    x [B,N,3], y [B,M,3]. The forward only."""
    _no_grad_ported(x, y)
    if not x.is_cuda:
        dl, _, dr, _ = nn_distances_plain(x, y)
        return dl, dr
    x, y = check_clouds(x, y, smem_bytes(x.shape[1], y.shape[1]))
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"diagonal pairs need equal batches, got {x.shape[0]} and {y.shape[0]}")
    b = x.shape[0]
    dl = torch.empty((b, x.shape[1]), dtype=torch.float32, device=x.device)
    dr = torch.empty((b, y.shape[1]), dtype=torch.float32, device=x.device)
    _launch(x, y, pair_list(b, b, "diag", x.device), False, dl=dl, dr=dr)
    launches["nnd_fwd"] += 1
    return dl, dr


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
    _no_grad_ported(xs, ys)
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
