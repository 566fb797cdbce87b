"""Approximate EMD (approxmatch): the matching cost of diagonal pairs and
the pairwise cost matrix, through one CUDA kernel (``csrc/emd.cu``).

Counterpart of ``dpfx/ops/emd.py``. Its Pallas kernels
``_emd_pallas_batched`` (with_grad=False) and ``_emd_pallas_pairwise``,
which share ``_emd_kernel_body``, become one kernel over a list of cloud
pairs; see its header for the design and what bounds it.

    factorl = max(n, m) / n ; factorr = max(n, m) / m
    remainl[i] = factorl ; remainr[j] = factorr
    for level in match_levels(n_iters):          # -4^7 .. -4^-1, then 0
        w_ij    = exp(level * d_ij) * remainr[j]  # d = squared distance
        ss_ij   = w_ij / (sum_j w_ij + 1e-9) * remainl[i]
        ratio_j = min(remainr[j] / (sum_i ss_ij + 1e-9), 1)
        match  += ss_ij * ratio_j
        remainl[i] -= sum_j ss_ij ratio_j ; remainr[j] -= ratio_j sum_i ss_ij
    EMD(X, Y) = sum_ij match_ij ||x_i - y_j|| / n

``precision="exact"`` is IEEE f32 throughout. ``"fast"`` (the pairwise
default, as in ``dpfx``) rounds where the Pallas fast mode rounds: x.y from
bf16 coordinates, d, w, ss, the row scale remainl / (rowsum + eps) and each
ss * sqrt(d) term to bf16; exp, sqrt and every sum in f32.

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises). ``launches`` counts the
kernel launches of each wrapper. The differentiable EMD (``dpfx``'s
``emd``) is not ported (ROADMAP Queue 2 #8): an input that requires grad
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List

import torch

from dpfx_torch.ops.chamfer import (PLAIN_CHUNK_ELEMS, _fast, _no_grad_ported, check_clouds,
                                    pair_list, sqdist_matrix)

Tensor = torch.Tensor

# kernel launches per wrapper; chip_smoke.py zeroes these around the main path
launches: Dict[str, int] = {"emd_batched": 0, "emd_pairwise": 0}

EPS = 1e-9
DEFAULT_ITERS = 10


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def match_levels(n_iters: int = DEFAULT_ITERS) -> List[float]:
    """Annealing schedule: j = n_iters-3 .. -2; level = -4^j, 0 at j=-2."""
    js = list(range(n_iters - 3, -3, -1))
    return [0.0 if j == -2 else -(4.0 ** j) for j in js]


def _factors(n: int, m: int):
    return max(n, m) / n, max(n, m) / m


# ---------------------------------------------------------------- plain versions

def approx_match_plain(x: Tensor, y: Tensor, n_iters: int = DEFAULT_ITERS) -> Tensor:
    """Transport plan match [.., N, M] for x [.., N, 3], y [.., M, 3] (f32;
    f64 for f64 inputs)."""
    n, m = x.shape[-2], y.shape[-2]
    factorl, factorr = _factors(n, m)
    d = sqdist_matrix(x, y)
    batch = x.shape[:-2]
    remainl = torch.full((*batch, n, 1), factorl, dtype=d.dtype, device=x.device)
    remainr = torch.full((*batch, 1, m), factorr, dtype=d.dtype, device=x.device)
    match = torch.zeros((*batch, n, m), dtype=d.dtype, device=x.device)
    for level in match_levels(n_iters):
        w = torch.exp(level * d) * remainr
        rowsum = w.sum(-1, keepdim=True)
        ss = w / (rowsum + EPS) * remainl
        colsum = ss.sum(-2, keepdim=True)
        ratio = torch.clamp_max(remainr / (colsum + EPS), 1.0)
        delta = ss * ratio
        match = match + delta
        remainl = torch.clamp_min(remainl - delta.sum(-1, keepdim=True), 0.0)
        remainr = torch.clamp_min(remainr - colsum * ratio, 0.0)
    return match


def match_cost_plain(x: Tensor, y: Tensor, match: Tensor) -> Tensor:
    return (match * torch.sqrt(sqdist_matrix(x, y))).sum((-2, -1))


def _emd_exact_plain(x: Tensor, y: Tensor, n_iters: int) -> Tensor:
    return match_cost_plain(x, y, approx_match_plain(x, y, n_iters)) / x.shape[-2]


def _emd_fast_plain(x: Tensor, y: Tensor, n_iters: int) -> Tensor:
    """The fast mode's arithmetic on pairs x [P,N,3], y [P,M,3] -> [P]:
    bf16 at the places the Pallas fast mode rounds (``emd.py:274-313``)."""
    n, m = x.shape[-2], y.shape[-2]
    factorl, factorr = _factors(n, m)
    d = sqdist_matrix(x, y, fast=True)
    dist = torch.sqrt(d)
    p = x.shape[0]
    remainl = torch.full((p, n), factorl, dtype=torch.float32, device=x.device)
    remainr = torch.full((p, m), factorr, dtype=torch.float32, device=x.device)
    cost = torch.zeros(p, dtype=torch.float32, device=x.device)
    for level in match_levels(n_iters):
        w = (torch.exp(level * d) * remainr[:, None, :]).bfloat16()
        wf = w.float()
        rowsum = wf.sum(-1)
        scale = (remainl / (rowsum + EPS)).bfloat16()
        ss = w * scale[..., None]                                   # bf16 product
        colsum = ss.float().sum(-2)
        cdist = (ss.float() * dist).bfloat16().float().sum(-2)
        ratio = torch.clamp_max(remainr / (colsum + EPS), 1.0)
        cost = cost + (ratio * cdist).sum(-1)
        wr = (wf * ratio[:, None, :]).sum(-1)
        remainl = torch.clamp_min(remainl - wr / (rowsum + EPS) * remainl, 0.0)
        remainr = torch.clamp_min(remainr - colsum * ratio, 0.0)
    return cost / n


def _over_pairs(fn, xs: Tensor, ys: Tensor, pairs: Tensor) -> Tensor:
    """fn on the listed (left, right) pairs, in chunks that keep the [N, M]
    intermediates near PLAIN_CHUNK_ELEMS elements each."""
    step = max(1, PLAIN_CHUNK_ELEMS // (xs.shape[1] * ys.shape[1]))
    out = [fn(xs[pairs[s:s + step, 0].long()], ys[pairs[s:s + step, 1].long()])
           for s in range(0, pairs.shape[0], step)]
    return torch.cat(out) if out else xs.new_zeros(0)


def emd_plain(x: Tensor, y: Tensor, n_iters: int = DEFAULT_ITERS) -> Tensor:
    """Exact EMD per diagonal pair: [B,N,3], [B,M,3] -> [B] (match cost / n),
    in f32 (f64 for f64 inputs, a reference)."""
    pairs = pair_list(x.shape[0], x.shape[0], "diag", x.device)
    return _over_pairs(lambda a, b: _emd_exact_plain(a, b, n_iters), x, y, pairs)


def emd_pairwise_plain(xs: Tensor, ys: Tensor, n_iters: int = DEFAULT_ITERS,
                       precision: str = "fast") -> Tensor:
    """[S1,N,3] x [S2,M,3] -> [S1,S2] EMD matrix, in the kernel's modes."""
    fn = _emd_fast_plain if _fast(precision) else _emd_exact_plain
    s1, s2 = xs.shape[0], ys.shape[0]
    pairs = pair_list(s1, s2, "full", xs.device)
    return _over_pairs(lambda a, b: fn(a, b, n_iters), xs, ys, pairs).view(s1, s2)


# ---------------------------------------------------------------- kernel launch

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from dpfx_torch.ops import _build

    lib = _build.load("emd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dpfx_emd_launch.argtypes = [p, p, p, i, i, i, i, i, f, f, p, p]
    lib.dpfx_emd_launch.restype = ctypes.c_int
    lib.dpfx_emd_smem_bytes.argtypes = [i, i]
    lib.dpfx_emd_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of one block, as the kernel library reports it."""
    return _lib().dpfx_emd_smem_bytes(n, m)


def _launch(xs: Tensor, ys: Tensor, pairs: Tensor, n_iters: int, fast: bool) -> Tensor:
    """Matching cost / n of every listed pair, [P]."""
    xs, ys = check_clouds(xs, ys, smem_bytes(xs.shape[1], ys.shape[1]))
    n, m = xs.shape[1], ys.shape[1]
    factorl, factorr = _factors(n, m)
    cost = torch.empty(pairs.shape[0], dtype=torch.float32, device=xs.device)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):
        err = _lib().dpfx_emd_launch(xs.data_ptr(), ys.data_ptr(), pairs.data_ptr(), pairs.shape[0],
                                     n, m, int(n_iters), int(fast), factorl, factorr,
                                     cost.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"emd kernel launch failed: cudaError {err}")
    return cost / n


# ---------------------------------------------------------------- public wrappers

def emd_nograd(x: Tensor, y: Tensor, n_iters: int = DEFAULT_ITERS) -> Tensor:
    """Exact (f32) EMD per diagonal pair: x [B,N,3], y [B,M,3] -> [B]."""
    _no_grad_ported(x, y)
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"diagonal pairs need equal batches, got {x.shape[0]} and {y.shape[0]}")
    if not x.is_cuda:
        return emd_plain(x, y, n_iters)
    out = _launch(x, y, pair_list(x.shape[0], x.shape[0], "diag", x.device), n_iters, fast=False)
    launches["emd_batched"] += 1
    return out


def emd_pairwise(xs: Tensor, ys: Tensor, n_iters: int = DEFAULT_ITERS,
                 precision: str = "fast") -> Tensor:
    """Full pairwise EMD matrix: xs [S1,N,3], ys [S2,M,3] -> [S1,S2].
    approxmatch is not argument-symmetric, so there is no triangle mode."""
    _no_grad_ported(xs, ys)
    fast = _fast(precision)
    if not xs.is_cuda:
        return emd_pairwise_plain(xs, ys, n_iters, precision)
    s1, s2 = xs.shape[0], ys.shape[0]
    out = _launch(xs, ys, pair_list(s1, s2, "full", xs.device), n_iters, fast)
    launches["emd_pairwise"] += 1
    return out.view(s1, s2)
