"""Approximate EMD (approxmatch): the matching cost of diagonal pairs, with
its gradients, and the pairwise cost matrix, through one CUDA kernel
(``csrc/emd.cu``).

Counterpart of ``dpfx/ops/emd.py``. Its Pallas kernels
``_emd_pallas_batched`` (with_grad False and True) and
``_emd_pallas_pairwise``, which share ``_emd_kernel_body``, become one
kernel over a list of cloud pairs; see its header for the design and what
bounds it.

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

``emd`` is differentiable, as ``dpfx``'s is: its gradients hold the
transport plan constant (``emd_grads_plain``, a copy of ``dpfx``'s
``emd_grads_jnp``), and the kernel computes them only when an input
requires grad. ``emd_nograd`` and ``emd_pairwise`` have no gradient, as in
``dpfx``: an input that requires grad raises.

``emd_sweeps_plain`` runs the kernel's own schedule in plain PyTorch: two
sweeps per level, the remainl update of level k fused with the row sums of
level k+1 (level k's exp taken as the fourth power of level k+1's), level 0
without an exp, the last remainl update only with gradients. The tests and
``chip_smoke.py`` hold it to ``emd_plain`` and the kernel to it.

The kernel has two layouts, routed as the Chamfer kernels' are
(``chamfer.large_layout``): up to 4096 points a cloud both clouds and the
per-point vectors sit in each CTA's shared memory; above it, up to
``chamfer.MAX_POINTS``, the large-cloud layout keeps them in global memory
and runs each sweep as a launch over blocks of ``large_own`` rows or
columns (``emd_large_plain`` is the plain version of its order of sums).

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises). ``launches`` counts the
kernel launches of each wrapper, ``layouts`` those of each layout ("pair"
or "large"), ``clusters`` the CTAs per pair the whole-pair launches took (a
thread-block cluster when above 1; ``cluster_size``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Set, Tuple

import torch
from torch.autograd.function import once_differentiable

from dpfx_torch.ops.chamfer import (PLAIN_CHUNK_ELEMS, _fast, check_clouds, large_layout,
                                    pair_list, refuse_grad, sqdist_matrix)

Tensor = torch.Tensor

# kernel launches per wrapper; chip_smoke.py zeroes these around the main path
launches: Dict[str, int] = {"emd_batched": 0, "emd_batched_grad": 0, "emd_pairwise": 0}
# the CTAs per pair (a cluster when above 1) of each wrapper's launches since
# reset_launch_counts
clusters: Dict[str, Set[int]] = {k: set() for k in launches}
# the launches of each wrapper by layout: "pair" (the whole-pair layout) or
# "large" (the large-cloud layout)
layouts: Dict[str, Dict[str, int]] = {k: {"pair": 0, "large": 0} for k in launches}

EPS = 1e-9
DEFAULT_ITERS = 10


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0
        clusters[k] = set()
        layouts[k] = {"pair": 0, "large": 0}


def _count(name: str, p: int, n: int, m: int) -> None:
    launches[name] += 1
    if large_layout(n, m):
        layouts[name]["large"] += 1
    else:
        layouts[name]["pair"] += 1
        clusters[name].add(cluster_size(p, n, m))


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


def _emd_grads_pairs(x: Tensor, y: Tensor, n_iters: int) -> Tuple[Tensor, Tensor, Tensor]:
    """``dpfx``'s ``emd_grads_jnp`` on pairs x [P,N,3], y [P,M,3]."""
    match = approx_match_plain(x, y, n_iters)
    diff = x[..., :, None, :] - y[..., None, :, :]                  # [P, N, M, 3]
    dist = torch.sqrt((diff * diff).sum(-1))
    cost = (match * dist).sum((-2, -1))
    unit = diff / torch.clamp_min(dist, EPS)[..., None]
    gx = (match[..., None] * unit).sum(-2)
    gy = -(match[..., None] * unit).sum(-3)
    n = x.shape[-2]
    return cost / n, gx / n, gy / n


def emd_grads_plain(x: Tensor, y: Tensor,
                    n_iters: int = DEFAULT_ITERS) -> Tuple[Tensor, Tensor, Tensor]:
    """(cost / n [B], dcost/dx / n [B,N,3], dcost/dy / n [B,M,3]) per diagonal
    pair, with the plan of ``approx_match_plain`` held constant: the
    arithmetic of ``dpfx``'s ``emd_grads_jnp``, in chunks of pairs. f32 (f64
    for f64 inputs, a reference)."""
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"diagonal pairs need equal batches, got {x.shape[0]} and {y.shape[0]}")
    step = max(1, PLAIN_CHUNK_ELEMS // (4 * x.shape[1] * y.shape[1]))
    out = [_emd_grads_pairs(x[s:s + step], y[s:s + step], n_iters)
           for s in range(0, x.shape[0], step)]
    return tuple(torch.cat(parts) for parts in zip(*out))


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


def _torch_sums():
    """(row sums over the columns, column sums over the rows, a level's cost
    over the columns) of [P, N, M(, 3)] and [P, M] tensors, as torch sums."""
    return lambda t: t.sum(2), lambda t: t.sum(1), lambda t: t.sum(-1)


def _sweeps_pairs(x: Tensor, y: Tensor, n_iters: int, fast: bool, grad: bool, sums=None):
    """The kernel's sweep order on pairs x [P,N,3], y [P,M,3]; ``sums`` as
    ``_torch_sums`` gives them (the default)."""
    rsum, csum, lsum = sums or _torch_sums()
    n, m = x.shape[-2], y.shape[-2]
    factorl, factorr = _factors(n, m)
    d = sqdist_matrix(x, y, fast=fast)
    dt, p = d.dtype, x.shape[0]
    dist = torch.sqrt(d)
    rnd = (lambda t: t.bfloat16().to(dt)) if fast else (lambda t: t)

    def w_of(e, r):
        """w = e remainr (e None: level 0, w = remainr), bf16 in fast mode."""
        return rnd(r[:, None, :].expand(p, n, m) if e is None else e * r[:, None, :])

    levels = match_levels(n_iters)
    remainl = torch.full((p, n), factorl, dtype=dt, device=x.device)
    remainr = torch.full((p, m), factorr, dtype=dt, device=x.device)
    cost = torch.zeros(p, dtype=dt, device=x.device)
    rowsum = rsum(w_of(None if levels[0] == 0 else torch.exp(levels[0] * d), remainr))
    if grad:
        diff = x[..., :, None, :] - y[..., None, :, :]
        unit = diff / torch.clamp_min(torch.sqrt((diff * diff).sum(-1)), EPS)[..., None]
        gx, gy = torch.zeros_like(x, dtype=dt), torch.zeros_like(y, dtype=dt)
    for k, level in enumerate(levels):
        # B_k: columns
        scale = rnd(remainl / (rowsum + EPS))
        e = None if level == 0 else torch.exp(level * d)
        ss = rnd(w_of(e, remainr) * scale[:, :, None])
        colsum = csum(ss)
        ratio = torch.clamp_max(remainr / (colsum + EPS), 1.0)
        cost = cost + lsum(ratio * csum(rnd(ss * dist)))
        rnext = torch.clamp_min(remainr - colsum * ratio, 0.0)
        if grad:
            gy = gy - csum((ss * ratio[:, None, :])[..., None] * unit)
        # F_k: rows, level k's remainl update and level k+1's row sums
        if k + 1 == n_iters and not grad:
            break
        e_new = None
        if k + 1 < n_iters and levels[k + 1] != 0:
            e_new = torch.exp(levels[k + 1] * d)
            e2 = e_new * e_new
            e = e2 * e2
        delta = w_of(e, remainr) * ratio[:, None, :]
        if grad:
            gx = gx + rsum((delta * scale[:, :, None])[..., None] * unit)
        if k + 1 == n_iters:
            break
        remainl = torch.clamp_min(remainl - rsum(delta) / (rowsum + EPS) * remainl, 0.0)
        rowsum = rsum(w_of(e_new, rnext))
        remainr = rnext
    return (cost / n, gx / n, gy / n) if grad else cost / n


def emd_sweeps_plain(x: Tensor, y: Tensor, n_iters: int = DEFAULT_ITERS, precision: str = "exact",
                     grad: bool = False):
    """The kernel's schedule per diagonal pair, x [B,N,3], y [B,M,3] -> cost / n
    [B] (with ``grad`` also dcost/dx / n and dcost/dy / n, the plan held
    constant): per level a column sweep and a row sweep, as ``emd.cu`` runs
    them, in ``precision`` "exact" (f32; f64 for f64 inputs) or "fast" (bf16
    where the fast mode rounds). A yardstick for the kernel's order, not a
    path of the port."""
    fast = _fast(precision)
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"diagonal pairs need equal batches, got {x.shape[0]} and {y.shape[0]}")
    step = max(1, PLAIN_CHUNK_ELEMS // ((4 if grad else 1) * x.shape[1] * y.shape[1]))
    out = [_sweeps_pairs(x[s:s + step], y[s:s + step], n_iters, fast, grad)
           for s in range(0, x.shape[0], step)]
    if grad:
        return tuple(torch.cat(parts) for parts in zip(*out))
    return torch.cat(out)


def _pow2ceil(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def _seq(t: Tensor, dim: int) -> Tensor:
    """t summed over dim one term at a time, in index order."""
    acc = torch.zeros_like(t.select(dim, 0))
    for k in range(t.shape[dim]):
        acc = acc + t.select(dim, k)
    return acc


def _owned_sum(t: Tensor, own: int, unit: int, threads: int = 256, r: int = 8) -> Tensor:
    """t [P, K, L(, 3)] summed over L as a sweep of the large layout sums it:
    the K owners in blocks of ``own`` (a CTA each); a block of k owners has
    G = threads / RT groups, RT = min(threads, max(32, pow2ceil(ceil(k /
    r)))) (emd.cu's group_threads), which split L in G parts of whole units
    of ``unit`` (the rows sweep takes columns in pairs), each part summed in
    order, the parts added in group order."""
    k_all, length = t.shape[1], t.shape[2]
    groups = []
    for b0 in range(0, k_all, own):
        rt = min(threads, max(32, _pow2ceil(-(-min(own, k_all - b0) // r))))
        groups += [threads // rt] * min(own, k_all - b0)
    groups = torch.tensor(groups, device=t.device)
    out = torch.empty_like(t.select(2, 0))
    for g in groups.unique().tolist():
        sel = (groups == g).nonzero().flatten()
        part = t.index_select(1, sel)
        per = -(-(-(-length // unit)) // g) * unit
        acc = None
        for a in range(0, length, per):
            v = _seq(part[:, :, a:a + per], 2)
            acc = v if acc is None else acc + v
        out[:, sel] = acc
    return out


def _large_sums(own: int):
    """``_sweeps_pairs``' sums in the large layout's order: the rows' over
    the columns and the columns' over the rows by ``_owned_sum``, a level's
    cost per block of ``own`` columns in order, then the blocks in order."""
    def lsum(v):
        acc = None
        for b0 in range(0, v.shape[-1], own):
            part = _seq(v[:, b0:b0 + own], 1)
            acc = part if acc is None else acc + part
        return acc

    return (lambda t: _owned_sum(t, own, 2),
            lambda t: _owned_sum(t.transpose(1, 2), own, 1), lsum)


def emd_large_plain(x: Tensor, y: Tensor, n_iters: int = DEFAULT_ITERS, precision: str = "exact",
                    grad: bool = False, own: int = 2048):
    """``emd_sweeps_plain`` with the large layout's order of sums (exact
    mode's: each sweep's owners in CTAs of ``own`` points, their groups'
    sequential parts added in group order, the level's cost in column
    blocks; fast mode sums on the tensor cores in an order of its own): a
    yardstick for the large layout at small N with small ``own``, held to
    ``emd_sweeps_plain`` by the kernel's limits."""
    fast = _fast(precision)
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"diagonal pairs need equal batches, got {x.shape[0]} and {y.shape[0]}")
    return _sweeps_pairs(x, y, n_iters, fast, grad, _large_sums(own))


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
    lib.dpfx_emd_launch.argtypes = [p, p, p, i, i, i, i, i, f, f, p, p, p, p]
    lib.dpfx_emd_launch.restype = ctypes.c_int
    lib.dpfx_emd_smem_bytes.argtypes = [i, i]
    lib.dpfx_emd_smem_bytes.restype = ctypes.c_int
    lib.dpfx_emd_cluster_size.argtypes = [i, i, i]
    lib.dpfx_emd_cluster_size.restype = ctypes.c_int
    lib.dpfx_emd_large.argtypes = [i, i]
    for fn in (lib.dpfx_emd_large_own, lib.dpfx_emd_large_chunk):
        fn.argtypes = [i, i, i, i]
    for fn in (lib.dpfx_emd_large, lib.dpfx_emd_large_own, lib.dpfx_emd_large_chunk):
        fn.restype = ctypes.c_int
    lib.dpfx_emd_large_scratch_bytes.argtypes = [i, i, i, i, i, i, i]
    lib.dpfx_emd_large_scratch_bytes.restype = ctypes.c_longlong
    lib.dpfx_emd_large_launch.argtypes = [p, p, i, i, p, i, i, i, i, i, f, f, p, p, p, p, p]
    lib.dpfx_emd_large_launch.restype = ctypes.c_int
    return lib


def smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of one block, as the kernel library reports it."""
    return _lib().dpfx_emd_smem_bytes(n, m)


def cluster_size(p: int, n: int, m: int) -> int:
    """CTAs (a thread-block cluster when above 1) the kernel gives each of p
    pairs of n x m points: 4 while 4p CTAs fit on the card's 132 SMs, 2 below
    2 x 132 pairs, else 1. It depends on p, n and m alone."""
    return _lib().dpfx_emd_cluster_size(p, n, m)


def large_own(p: int, n: int, m: int, fast: bool = False) -> int:
    """Points (rows or columns) a CTA of the large layout's sweeps owns for
    p pairs of n x m points, as the kernel library reports it: 2048, halved
    down to 256 while the pairs give fewer than 2 x 132 CTAs (of a chunk of
    pairs whose state fits 256 MB). It depends on p, n and m alone."""
    return _lib().dpfx_emd_large_own(p, n, m, int(fast))


def _launch(xs: Tensor, ys: Tensor, pairs: Tensor, n_iters: int, fast: bool, grad: bool = False):
    """Matching cost / n of every listed pair, [P]; with ``grad`` (exact
    mode, diagonal pairs) also (dcost/dx / n [P,N,3], dcost/dy / n [P,M,3])."""
    n, m = xs.shape[1], ys.shape[1]
    large = large_layout(n, m)
    xs, ys = check_clouds(xs, ys, 0 if large else smem_bytes(n, m))
    factorl, factorr = _factors(n, m)
    cost = torch.empty(pairs.shape[0], dtype=torch.float32, device=xs.device)
    gx = torch.zeros_like(xs) if grad else None
    gy = torch.zeros_like(ys) if grad else None
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):
        if large:
            s1, s2, p = xs.shape[0], ys.shape[0], pairs.shape[0]
            scratch = torch.empty(_lib().dpfx_emd_large_scratch_bytes(s1, s2, p, n, m, int(n_iters),
                                                                      int(fast)),
                                  dtype=torch.uint8, device=xs.device)
            err = _lib().dpfx_emd_large_launch(xs.data_ptr(), ys.data_ptr(), s1, s2, pairs.data_ptr(),
                                               p, n, m, int(n_iters), int(fast), factorl, factorr,
                                               cost.data_ptr(), ptr(gx), ptr(gy), scratch.data_ptr(),
                                               stream)
        else:
            err = _lib().dpfx_emd_launch(xs.data_ptr(), ys.data_ptr(), pairs.data_ptr(),
                                         pairs.shape[0], n, m, int(n_iters), int(fast), factorl,
                                         factorr, cost.data_ptr(), ptr(gx), ptr(gy), stream)
    if err != 0:
        raise RuntimeError(f"emd kernel launch failed: cudaError {err}")
    return (cost / n, gx / n, gy / n) if grad else cost / n


def emd_with_grads(x: Tensor, y: Tensor,
                   n_iters: int = DEFAULT_ITERS) -> Tuple[Tensor, Tensor, Tensor]:
    """(cost / n [B], dcost/dx / n [B,N,3], dcost/dy / n [B,M,3]) per
    diagonal pair, the plan held constant: the kernel's gradient mode for
    CUDA tensors, ``emd_grads_plain``'s gradients for CPU tensors. Either
    way the cost is ``emd_nograd``'s, bit for bit. No autograd."""
    if not x.is_cuda:
        _, gx, gy = emd_grads_plain(x, y, n_iters)
        return emd_plain(x, y, n_iters), gx, gy
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"diagonal pairs need equal batches, got {x.shape[0]} and {y.shape[0]}")
    out = _launch(x, y, pair_list(x.shape[0], x.shape[0], "diag", x.device), n_iters,
                  fast=False, grad=True)
    _count("emd_batched_grad", x.shape[0], x.shape[1], y.shape[1])
    return out


class _EMD(torch.autograd.Function):
    """``dpfx``'s ``emd`` custom VJP: the gradients come with the forward
    (``emd_with_grads``), and the backward scales them."""

    @staticmethod
    def forward(ctx, x, y, n_iters):
        cost, gx, gy = emd_with_grads(x, y, n_iters)
        ctx.save_for_backward(gx, gy)
        return cost

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        gx, gy = ctx.saved_tensors
        g = g[:, None, None].to(gx.dtype)
        return g * gx, g * gy, None


# ---------------------------------------------------------------- public wrappers

def emd(x: Tensor, y: Tensor, n_iters: int = DEFAULT_ITERS) -> Tensor:
    """Approx EMD per diagonal pair, differentiable: x [B,N,3], y [B,M,3] ->
    [B]. The gradient mode runs only when an input requires grad (as
    ``dpfx``'s primal skips it); otherwise this is ``emd_nograd``."""
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        return _EMD.apply(x, y, n_iters)
    return emd_nograd(x, y, n_iters)


def emd_nograd(x: Tensor, y: Tensor, n_iters: int = DEFAULT_ITERS) -> Tensor:
    """Exact (f32) EMD per diagonal pair: x [B,N,3], y [B,M,3] -> [B]."""
    refuse_grad("emd_nograd (use emd for gradients)", x, y)
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"diagonal pairs need equal batches, got {x.shape[0]} and {y.shape[0]}")
    if not x.is_cuda:
        return emd_plain(x, y, n_iters)
    out = _launch(x, y, pair_list(x.shape[0], x.shape[0], "diag", x.device), n_iters, fast=False)
    _count("emd_batched", x.shape[0], x.shape[1], y.shape[1])
    return out


def emd_pairwise(xs: Tensor, ys: Tensor, n_iters: int = DEFAULT_ITERS,
                 precision: str = "fast") -> Tensor:
    """Full pairwise EMD matrix: xs [S1,N,3], ys [S2,M,3] -> [S1,S2].
    approxmatch is not argument-symmetric, so there is no triangle mode."""
    refuse_grad("emd_pairwise (use emd for gradients of diagonal pairs)", xs, ys)
    fast = _fast(precision)
    if not xs.is_cuda:
        return emd_pairwise_plain(xs, ys, n_iters, precision)
    s1, s2 = xs.shape[0], ys.shape[0]
    out = _launch(xs, ys, pair_list(s1, s2, "full", xs.device), n_iters, fast)
    _count("emd_pairwise", s1 * s2, xs.shape[1], ys.shape[1])
    return out.view(s1, s2)
