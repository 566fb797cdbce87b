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

The forward kernel makes one pass per pair: each distance is computed once,
unclamped and unrounded, and folded into its row's and its column's
minimum; the clamp at 0 and fast mode's rounding, both monotone, are
applied to each minimum. ``onepass_plain`` is the plain version of that
algebra in the kernel's tiles, its cluster split and its order of sums, so
its CD equals the kernel's bit for bit.

The backward kernel sweeps each pair's distances once, counting the hits
of each row and column; a pair whose every count is 1 gets its gradient
from the nearest-neighbour lists (PATH_LISTS), a pair with a few points
whose count is not 1 (ties) from the lists and a scan of the other cloud
for each point the ties reach (PATH_FIX), a pair with many (duplicated
clouds) from three passes over the distances (PATH_THREE). Every path adds
the same terms in the same order: the gradients equal the three-pass
kernel's (``nnd_backward(..., three_pass=True)``) bit for bit, and
``onepass_bwd_plain``'s, the plain version of that algebra.

Both kernels have two layouts. Up to PAIR_POINTS (4096) points a cloud a
pair's two clouds sit in one CTA's shared memory (or in each CTA of its
cluster); above it, up to MAX_POINTS (16,384), the large-cloud layout
streams them from global memory, one CTA a column tile of 256, with the
same tiles, arithmetic and orders of sums: the same results bit for bit
(``large_plain`` and ``large_bwd_plain`` are the plain versions of its
schedule). ``large_layout`` is the route.

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises). ``launches`` counts the
kernel launches of each wrapper, ``layouts`` the launches of each layout
("pair" or "large"), ``clusters`` the CTAs per pair that the whole-pair
launches took (a thread-block cluster when above 1; ``cluster_size``),
``last_paths`` the path each pair of the last backward launch took.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Set, Tuple

import torch
from torch.autograd.function import once_differentiable

from dpfx_torch.ops._build import SMEM_LIMIT

Tensor = torch.Tensor

# kernel launches per wrapper; chip_smoke.py zeroes these around the main path
launches: Dict[str, int] = {"nnd_fwd": 0, "nnd_bwd": 0, "cd_pairwise": 0}
# the launches of each wrapper by layout: "pair" (a pair in one CTA's shared
# memory, or its cluster's) or "large" (the large-cloud layout)
layouts: Dict[str, Dict[str, int]] = {k: {"pair": 0, "large": 0} for k in launches}
# launches of the three-pass backward kernel, a reference no path takes
reference_launches: Dict[str, int] = {"nnd_bwd3": 0}
# the CTAs per pair (a cluster when above 1) of the launches since the last
# reset
clusters: Dict[str, Set[int]] = {"nnd_fwd": set(), "nnd_bwd": set(), "cd_pairwise": set()}
# uint8 [B] of the last nnd_backward launch on the card: each pair's path
# (PATH_LISTS, PATH_FIX, PATH_THREE below); written by the kernel, so
# reading it waits for the launch
last_paths: Optional[torch.Tensor] = None

PAIR_POINTS = 4096         # the whole-pair layout's largest cloud (both clouds in shared memory)
MAX_POINTS = 16384         # the large-cloud layout's: packed counts of 2^15 a hit (csrc/chamfer.cu)
PLAIN_CHUNK_ELEMS = 2**26  # distance elements per chunk of a plain version (256 MB f32)
# the forward kernel's tiles: 256 rows (8 per lane of a warp) x 256 columns
# in chunks of 32, and 256 threads per block (block_sum's order)
TILE_ROWS, TILE_COLS, CHUNK, THREADS = 256, 256, 32, 256


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0
    reference_launches["nnd_bwd3"] = 0
    for k in clusters:
        clusters[k] = set()
        layouts[k] = {"pair": 0, "large": 0}


def large_layout(n: int, m: int) -> bool:
    """The route: the large-cloud layout where a cloud has more than
    PAIR_POINTS points, the whole-pair layout elsewhere."""
    return n > PAIR_POINTS or m > PAIR_POINTS


def _count(name: str, large: bool) -> None:
    launches[name] += 1
    layouts[name]["large" if large else "pair"] += 1


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


def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def _min_bits(v: Tensor, fast: bool) -> Tensor:
    """A minimum as the plain version's distance: clamped at 0, in fast mode
    then rounded to bf16."""
    v = torch.clamp_min(v, 0.0)
    return v.bfloat16().float() if fast else v


def block_order_sum(v: Tensor) -> Tensor:
    """Sum over the last axis in the kernel's order: thread t of 256 adds
    elements t, t + 256, ... in turn, each warp's 32 threads meet by an xor
    butterfly (16, 8, 4, 2, 1), then the 8 warps' sums are added in order
    (dpfx_common.cuh's block_sum). Every add is one f32 rounding."""
    n = v.shape[-1]
    v = torch.nn.functional.pad(v.float(), (0, _ceil_to(n, THREADS) - n))
    v = v.view(*v.shape[:-1], -1, THREADS)
    s = v[..., 0, :]
    for k in range(1, v.shape[-2]):
        s = s + v[..., k, :]
    s = s.view(*s.shape[:-1], THREADS // 32, 32)
    lanes = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., lanes ^ o]
    out = s[..., 0, 0]
    for w in range(1, THREADS // 32):
        out = out + s[..., w, 0]
    return out


def _tile_ranks(gr: int, gc: int, ctas: int, device) -> Tensor:
    """[gr, gc]: the CTA of a cluster of ``ctas`` that takes tile (row group,
    column tile): tile t = g gc + c goes to rank r where r T / ctas <= t < (r
    + 1) T / ctas, T = gr gc (the kernels' split)."""
    t = torch.arange(gr * gc, device=device)
    bounds = torch.tensor([r * gr * gc // ctas for r in range(1, ctas)], device=device)
    return torch.searchsorted(bounds, t, right=True).view(gr, gc)


def onepass_plain(x: Tensor, y: Tensor, fast: bool = False,
                  ctas: int = 1) -> Tuple[Tensor, Tensor, Tensor]:
    """(dl [B,N], dr [B,M], cd [B]) of diagonal pairs through the forward
    kernel's algebra: the raw distances (|x|^2 + |y|^2) - 2 x.y, unclamped
    and unrounded; per tile of 256 rows x 256 columns the rows' minima over
    the tile's columns and the columns' minima over its rows, each clamped
    at 0 (and in fast mode rounded to bf16), then the minimum over the tiles
    that each of ``ctas`` CTAs takes (tile t = row group * column tiles +
    column tile to rank r where r T / ctas <= t < (r + 1) T / ctas) and over
    the CTAs; cd = block_order_sum(dl) / N + block_order_sum(dr) / M. The
    minima equal ``nn_distances_plain``'s (exact) or the minima of
    ``sqdist_matrix(fast=True)`` bit for bit, and cd the kernel's."""
    x, y = x.float(), y.float()
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    x2, y2 = _norm2(x), _norm2(y)
    if fast:
        x, y = x.bfloat16().float(), y.bfloat16().float()
    np_, mp = _ceil_to(n, TILE_ROWS), _ceil_to(m, CHUNK)
    gr, gc = np_ // TILE_ROWS, -(-mp // TILE_COLS)
    inf = float("inf")
    # padding points (0, 0, 0, inf): infinitely far from every point
    xq = torch.nn.functional.pad(x, (0, 0, 0, np_ - n))
    yq = torch.nn.functional.pad(y, (0, 0, 0, gc * TILE_COLS - m))
    x2q = torch.nn.functional.pad(x2, (0, np_ - n), value=inf)
    y2q = torch.nn.functional.pad(y2, (0, gc * TILE_COLS - m), value=inf)
    rank = _tile_ranks(gr, gc, ctas, x.device)
    dls, drs = [], []
    step = _pair_chunk(np_, gc * TILE_COLS)
    for s in range(0, b, step):
        xc, yc = xq[s:s + step], yq[s:s + step]
        xy = (xc[:, :, None, 0] * yc[:, None, :, 0] + xc[:, :, None, 1] * yc[:, None, :, 1]
              + xc[:, :, None, 2] * yc[:, None, :, 2])
        d = (x2q[s:s + step, :, None] + y2q[s:s + step, None, :]) - 2.0 * xy
        d4 = d.view(-1, gr, TILE_ROWS, gc, TILE_COLS)
        rows = _min_bits(d4.amin(dim=4), fast)      # [b, gr, 256, gc]: tile (g, c)'s rows
        cols = _min_bits(d4.amin(dim=2), fast)      # [b, gr, gc, 256]: tile (g, c)'s columns
        rmin = torch.full((rows.shape[0], np_), inf, device=x.device)
        cmin = torch.full((rows.shape[0], gc * TILE_COLS), inf, device=x.device)
        for r in range(ctas):
            own = (rank == r)
            rr = torch.where(own[None, :, None, :], rows, inf).amin(dim=3).reshape(-1, np_)
            cc = torch.where(own[None, :, :, None], cols, inf).amin(dim=1).reshape(-1, gc * TILE_COLS)
            rmin, cmin = torch.minimum(rmin, rr), torch.minimum(cmin, cc)
        dls.append(rmin[:, :n])
        drs.append(cmin[:, :m])
    dl, dr = torch.cat(dls), torch.cat(drs)
    # divided elementwise by a tensor: a division by a Python scalar may be
    # taken as a product with its reciprocal, which the kernel's IEEE
    # division is not
    sl, sr = block_order_sum(dl), block_order_sum(dr)
    return dl, dr, sl / torch.full_like(sl, n) + sr / torch.full_like(sr, m)


# the backward kernel's paths (chamfer.cu's PATH_*): the lists, the lists
# with the fix-up (1 to FIX_MAX points whose count is not 1), three passes
PATH_LISTS, PATH_FIX, PATH_THREE = 0, 1, 2
FIX_MAX = 64


def fma32(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """a * b + c on f32 tensors rounded once to f32, as an FFMA (``fmaf``)
    rounds it: the product is exact in f64 (24 + 24 bits), the f64 sum is
    rounded to odd (TwoSum's error says which way), and rounding that to
    f32 is then correctly rounded (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)             # s + e == p + c exactly
    even = (s.contiguous().view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, float("inf")), torch.full_like(s, float("-inf")))
    return torch.where((e != 0) & even, torch.nextafter(s, toward), s).float()


def _ordered_sums(mask: Tensor, v: Tensor, w: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Per (b, p), over the q with mask [B, P, Q] in ascending q, the f32
    sums the kernel takes from 0, one rounding per term: sw = sum w_q and
    sv = sum fma(w_q, v_q, .) with weights w [B, Q], else sv = sum v_q
    (fmaf(1, v, s)) and sw = 0. v [B, Q, 3]."""
    b, np_, _ = mask.shape
    sw = torch.zeros((b * np_,), dtype=torch.float32, device=mask.device)
    sv = torch.zeros((b * np_, 3), dtype=torch.float32, device=mask.device)
    bi, pi, qi = mask.nonzero(as_tuple=True)      # row-major: grouped by (b, p), q ascending
    g = bi * np_ + pi
    rank = torch.arange(g.numel(), device=mask.device) - torch.searchsorted(g, g)
    for r in range(int(rank.max()) + 1 if g.numel() else 0):
        sel = rank == r
        o, bq, q = g[sel], bi[sel], qi[sel]
        if w is None:
            sv[o] = sv[o] + v[bq, q]
        else:
            sw[o] = sw[o] + w[bq, q]
            sv[o] = fma32(w[bq, q, None], v[bq, q], sv[o])
    return sw.view(b, np_), sv.view(b, np_, 3)


def sweep_bound(dmin: Tensor) -> Tensor:
    """The bound the kernel's sweep tests the unclamped distance against:
    dmin where dmin >= 0, else -inf. For every dmin, raw <= sweep_bound(dmin)
    holds exactly when max(raw, 0) <= dmin (a clamped distance is >= 0)."""
    return torch.where(dmin >= 0, dmin, torch.full_like(dmin, float("-inf")))


def _raw_dist(x: Tensor, y: Tensor) -> Tensor:
    """(|x|^2 + |y|^2) - 2 x.y unclamped, each operation rounded on its own
    (the kernels' raw_dist): [B, N, 3], [B, M, 3] -> [B, N, M]."""
    xy = (x[:, :, None, 0] * y[:, None, :, 0] + x[:, :, None, 1] * y[:, None, :, 1]
          + x[:, :, None, 2] * y[:, None, :, 2])
    return (_norm2(x)[:, :, None] + _norm2(y)[:, None, :]) - 2.0 * xy


def hit_counts(x: Tensor, y: Tensor, dl: Tensor, dr: Tensor,
               ctas: int = 1) -> Tuple[Tensor, Tensor]:
    """(rowcnt [B,N], colcnt [B,M]): the backward kernel's sweep. Per row
    the hits raw <= sweep_bound(dl_i) among the unclamped distances, per
    column raw <= sweep_bound(dr_j), counted over the tiles (256 rows x 256
    columns) that each of ``ctas`` CTAs takes (as ``onepass_plain``), then
    summed over the CTAs."""
    x, y = x.float(), y.float()
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    np_, gc = _ceil_to(n, TILE_ROWS), -(-_ceil_to(m, CHUNK) // TILE_COLS)
    gr, mq = np_ // TILE_ROWS, gc * TILE_COLS
    rank = _tile_ranks(gr, gc, ctas, x.device)
    out = []
    step = max(1, _pair_chunk(np_, mq) // 4)
    for s in range(0, b, step):
        # padding points are infinitely far, and no padding row or column
        # is tested against a bound above -inf
        raw = torch.nn.functional.pad(_raw_dist(x[s:s + step], y[s:s + step]),
                                      (0, mq - m, 0, np_ - n), value=float("inf"))
        bl = torch.nn.functional.pad(sweep_bound(dl[s:s + step].float()), (0, np_ - n),
                                     value=float("-inf"))
        br = torch.nn.functional.pad(sweep_bound(dr[s:s + step].float()), (0, mq - m),
                                     value=float("-inf"))
        ml = (raw <= bl[:, :, None]).view(-1, gr, TILE_ROWS, gc, TILE_COLS)
        mr = (raw <= br[:, None, :]).view(-1, gr, TILE_ROWS, gc, TILE_COLS)
        c = ml.shape[0]
        rc = torch.zeros((c, np_), dtype=torch.int64, device=x.device)
        cc = torch.zeros((c, mq), dtype=torch.int64, device=x.device)
        for r in range(ctas):
            own = (rank == r)[None, :, None, :, None]
            rc += (ml & own).sum((3, 4)).view(c, np_)
            cc += (mr & own).sum((1, 2)).view(c, mq)
        out.append((rc[:, :n], cc[:, :m]))
    return tuple(torch.cat(parts) for parts in zip(*out))


def onepass_bwd_plain(x: Tensor, y: Tensor, dl: Tensor, dr: Tensor, gl: Tensor, gr: Tensor,
                      ctas: int = 1) -> Tuple[Tensor, Tensor, Tensor]:
    """(gx [B,N,3], gy [B,M,3], paths [B] uint8) through the backward
    kernel's algebra. ``hit_counts`` gives each row's and column's hits
    and each pair's path (PATH_LISTS where every count is 1, PATH_FIX for 1
    to FIX_MAX points whose count is not 1, else PATH_THREE). Every path's
    sums (the kernel's lists, its fix-up's scans, its three passes) are the
    three passes' nonzero terms in index order, from 0, one f32 rounding
    per operation (``fma32`` for an FFMA):
      gx_i = (c x_i - 2 wl_i sy_i) - 2 swy_i,  c = 2 (gl_i + swr_i)
      gy_j = (c y_j - 2 swx_j) - 2 wr_j sx_j,  c = 2 (gr_j + swl_j)
    with wl_i = gl_i / max(rowcnt_i, 1), wr_j = gr_j / max(colcnt_j, 1), sy_i
    the sum of y_j over row i's hits (y_j*(i) where there is one), swr_i
    and swy_i those of wr_j and fma(wr_j, y_j, .) over the columns that hit
    row i, and sx_j, swl_j, swx_j alike: the kernel's gradients bit for
    bit on every path."""
    x, y, gl, gr = x.float(), y.float(), gl.float(), gr.float()
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    rc, cc = hit_counts(x, y, dl, dr, ctas)
    odd = (rc != 1).sum(1) + (cc != 1).sum(1)
    paths = torch.where(odd == 0, PATH_LISTS, torch.where(odd <= FIX_MAX, PATH_FIX, PATH_THREE))
    wl = gl / torch.clamp_min(rc.float(), 1.0)
    wr = gr / torch.clamp_min(cc.float(), 1.0)
    gx, gy = torch.empty_like(x), torch.empty_like(y)
    step = max(1, _pair_chunk(n, m) // 4)
    for s in range(0, b, step):
        k = slice(s, s + step)
        raw = _raw_dist(x[k], y[k])
        ml = raw <= sweep_bound(dl[k].float())[:, :, None]
        mr = raw <= sweep_bound(dr[k].float())[:, None, :]
        _, sy = _ordered_sums(ml, y[k])
        swr, swy = _ordered_sums(mr, y[k], wr[k])
        _, sx = _ordered_sums(mr.transpose(1, 2), x[k])
        swl, swx = _ordered_sums(ml.transpose(1, 2), x[k], wl[k])
        c = 2.0 * (gl[k] + swr)
        gx[k] = (c[..., None] * x[k] - (2.0 * wl[k])[..., None] * sy) - 2.0 * swy
        c = 2.0 * (gr[k] + swl)
        gy[k] = (c[..., None] * y[k] - 2.0 * swx) - (2.0 * wr[k])[..., None] * sx
    return gx, gy, paths.to(torch.uint8)


HIT_LARGE = 1 << 15   # a hit in the large layout's packed counts (chamfer.cu's HIT_L)


def large_plain(x: Tensor, y: Tensor, fast: bool = False, rows: int = TILE_ROWS,
                cols: int = TILE_COLS) -> Tuple[Tensor, Tensor, Tensor]:
    """(dl [B,N], dr [B,M], cd [B]) of diagonal pairs through the large
    layout's schedule: one CTA a tile of ``cols`` columns against every
    group of ``rows`` rows; each tile's row and column minima of the raw
    distances, clamped (in fast mode rounded to bf16), met by minimum, a
    column's over its CTA's row groups, a row's over the column tiles (the
    kernel's atomicMin on the bits); cd = block_order_sum(dl) / N +
    block_order_sum(dr) / M, as the whole-pair layout sums. The minima equal
    ``nn_distances_plain``'s bit for bit (exact) and cd ``onepass_plain``'s."""
    x, y = x.float(), y.float()
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    x2, y2 = _norm2(x), _norm2(y)
    if fast:
        x, y = x.bfloat16().float(), y.bfloat16().float()
    gr, gc = -(-n // rows), -(-m // cols)
    inf = float("inf")
    xq = torch.nn.functional.pad(x, (0, 0, 0, gr * rows - n))
    yq = torch.nn.functional.pad(y, (0, 0, 0, gc * cols - m))
    x2q = torch.nn.functional.pad(x2, (0, gr * rows - n), value=inf)
    y2q = torch.nn.functional.pad(y2, (0, gc * cols - m), value=inf)
    dls, drs = [], []
    step = _pair_chunk(gr * rows, gc * cols)
    for s in range(0, b, step):
        xc, yc = xq[s:s + step], yq[s:s + step]
        xy = (xc[:, :, None, 0] * yc[:, None, :, 0] + xc[:, :, None, 1] * yc[:, None, :, 1]
              + xc[:, :, None, 2] * yc[:, None, :, 2])
        d = ((x2q[s:s + step, :, None] + y2q[s:s + step, None, :]) - 2.0 * xy).view(
            -1, gr, rows, gc, cols)
        dls.append(_min_bits(d.amin(dim=4), fast).amin(dim=3).reshape(-1, gr * rows)[:, :n])
        drs.append(_min_bits(d.amin(dim=2), fast).amin(dim=1).reshape(-1, gc * cols)[:, :m])
    dl, dr = torch.cat(dls), torch.cat(drs)
    sl, sr = block_order_sum(dl), block_order_sum(dr)
    return dl, dr, sl / torch.full_like(sl, n) + sr / torch.full_like(sr, m)


def large_bwd_plain(x: Tensor, y: Tensor, dl: Tensor, dr: Tensor, gl: Tensor, gr: Tensor,
                    hit: int = HIT_LARGE) -> Tuple[Tensor, Tensor, Tensor]:
    """(gx [B,N,3], gy [B,M,3], paths [B] uint8) through the large layout's
    backward: the sweep's packed words (hit + k a hit at k, rows then
    columns; integer sums, so no tile or order changes them; all below the
    mark bit 2^31), the path from the points whose word is not one hit,
    their counts again, and on PATH_FIX the marks of the points they hit.
    An owner whose word is one hit and that no tie marked sums its inverse
    list (the other cloud's points whose word is one hit at it, weighed by
    their cotangents) in ascending order, its own-direction sum being its
    hit's point; every other owner (all on PATH_THREE) sums its masks over
    the whole other cloud. Each sum from 0 in index order, one f32 rounding
    a term (``_ordered_sums``): ``onepass_bwd_plain``'s gradients and paths
    bit for bit."""
    x, y, gl, gr = x.float(), y.float(), gl.float(), gr.float()
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    gx, gy = torch.empty_like(x), torch.empty_like(y)
    paths = torch.empty(b, dtype=torch.uint8, device=x.device)
    step = max(1, _pair_chunk(n, m) // 4)
    for s in range(0, b, step):
        k = slice(s, s + step)
        raw = _raw_dist(x[k], y[k])
        ml = raw <= sweep_bound(dl[k].float())[:, :, None]
        mr = raw <= sweep_bound(dr[k].float())[:, None, :]
        ii = torch.arange(n, device=x.device, dtype=torch.int64)
        jj = torch.arange(m, device=x.device, dtype=torch.int64)
        words = torch.cat([(ml * (hit + jj)).sum(-1), (mr * (hit + ii)[:, None]).sum(-2)], 1)
        if bool((words >= 2**31).any()):
            raise OverflowError("a packed count reaches the mark bit")
        one = torch.where((words >= hit) & (words < 2 * hit), words - hit, -1)
        odd = one < 0
        n_odd = odd.sum(1)
        pth = torch.where(n_odd == 0, PATH_LISTS, torch.where(n_odd <= FIX_MAX, PATH_FIX, PATH_THREE))
        paths[k] = pth.to(torch.uint8)
        hits = torch.where(odd, torch.cat([ml.sum(-1), mr.sum(-2)], 1), 1)
        # PATH_FIX: each point whose count is not 1 marks the points it hits
        marked = torch.cat([(mr & odd[:, None, n:]).any(2), (ml & odd[:, :n, None]).any(1)], 1)
        fixed = odd | (marked & (pth == PATH_FIX)[:, None]) | (pth == PATH_THREE)[:, None]
        # the inverse lists: column j in row i's where j's one hit is i, and so on
        list_r = one[:, None, n:] == ii[None, :, None]
        list_c = one[:, :n, None] == jj[None, None, :]
        sel_r = torch.where(fixed[:, :n, None], mr, list_r)
        sel_c = torch.where(fixed[:, None, n:], ml, list_c)
        wl = gl[k] / torch.clamp_min(hits[:, :n].float(), 1.0)
        wr = gr[k] / torch.clamp_min(hits[:, n:].float(), 1.0)
        _, sy = _ordered_sums(ml, y[k])
        swr, swy = _ordered_sums(sel_r, y[k], wr)
        _, sx = _ordered_sums(mr.transpose(1, 2), x[k])
        swl, swx = _ordered_sums(sel_c.transpose(1, 2), x[k], wl)
        c = 2.0 * (gl[k] + swr)
        gx[k] = (c[..., None] * x[k] - (2.0 * wl)[..., None] * sy) - 2.0 * swy
        c = 2.0 * (gr[k] + swl)
        gy[k] = (c[..., None] * y[k] - 2.0 * swx) - (2.0 * wr)[..., None] * sx
    return gx, gy, paths


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
    lib.dpfx_chamfer_cluster_size.argtypes = [i, i, i]
    lib.dpfx_chamfer_cluster_size.restype = ctypes.c_int
    lib.dpfx_nnd_bwd_launch.argtypes = [p, p, i, i, i, p, p, p, p, p, p, p, p]
    lib.dpfx_nnd_bwd3_launch.argtypes = [p, p, i, i, i, p, p, p, p, p, p, p]
    for fn in (lib.dpfx_nnd_bwd_launch, lib.dpfx_nnd_bwd3_launch):
        fn.restype = ctypes.c_int
    for fn in (lib.dpfx_nnd_bwd_smem_bytes, lib.dpfx_nnd_bwd3_smem_bytes, lib.dpfx_chamfer_large):
        fn.argtypes = [i, i]
        fn.restype = ctypes.c_int
    lib.dpfx_chamfer_large_ctas.argtypes = [i]
    lib.dpfx_chamfer_large_ctas.restype = ctypes.c_int
    for fn in (lib.dpfx_chamfer_large_scratch_floats, lib.dpfx_nnd_bwd_large_scratch_words):
        fn.argtypes = [i, i, i]
        fn.restype = ctypes.c_longlong
    lib.dpfx_chamfer_large_launch.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p]
    lib.dpfx_nnd_bwd_large_launch.argtypes = [p, p, i, i, i, p, p, p, p, p, p, p, p, p]
    for fn in (lib.dpfx_chamfer_large_launch, lib.dpfx_nnd_bwd_large_launch):
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of one block, as the kernel library reports it."""
    return _lib().dpfx_chamfer_smem_bytes(n, m)


def cluster_size(p: int, n: int, m: int) -> int:
    """CTAs (a thread-block cluster when above 1) the forward and backward
    kernels give each of p pairs of n x m points: 4 while 4p CTAs fit on the 132 SMs, 2
    below 2 x 132 pairs, else 1, never more than the pair's tiles."""
    return _lib().dpfx_chamfer_cluster_size(p, n, m)


def bwd_smem_bytes(n: int, m: int, three_pass: bool = False) -> int:
    """Dynamic shared memory of one block of the backward kernel (or of
    the three-pass kernel)."""
    lib = _lib()
    return (lib.dpfx_nnd_bwd3_smem_bytes if three_pass else lib.dpfx_nnd_bwd_smem_bytes)(n, m)


def large_ctas(m: int) -> int:
    """CTAs the large layout's sweeps give a pair: its column tiles of 256,
    as the kernel library reports them."""
    return _lib().dpfx_chamfer_large_ctas(m)


def check_clouds(xs: Tensor, ys: Tensor, smem: int) -> Tuple[Tensor, Tensor]:
    """The kernels' conditions on a pair of cloud stacks (shared with the
    EMD wrappers): CUDA, one device, [S, N, 3], N and M in 1..MAX_POINTS,
    ``smem`` (the launch's dynamic shared memory) within the limit. Returns
    both as contiguous float32."""
    if xs.dim() != 3 or ys.dim() != 3 or xs.shape[-1] != 3 or ys.shape[-1] != 3:
        raise ValueError(f"clouds must be [S, N, 3], got {tuple(xs.shape)} and {tuple(ys.shape)}")
    n, m = xs.shape[1], ys.shape[1]
    if not (0 < n <= MAX_POINTS and 0 < m <= MAX_POINTS):
        raise ValueError(f"the kernels take 1..{MAX_POINTS} points per cloud, got N={n}, M={m} "
                         "(larger clouds: ROADMAP.md, Queue 2a)")
    if not (xs.is_cuda and ys.device == xs.device):
        raise ValueError(f"both clouds must be CUDA tensors on one device, got {xs.device}, {ys.device}")
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


def _fwd_clouds(xs: Tensor, ys: Tensor) -> Tuple[Tensor, Tensor]:
    """check_clouds for the forward on the layout the route takes."""
    n, m = xs.shape[1], ys.shape[1]
    return check_clouds(xs, ys, 0 if large_layout(n, m) else smem_bytes(n, m))


def _launch(xs: Tensor, ys: Tensor, pairs: Tensor, fast: bool, cd=None, dl=None, dr=None) -> None:
    """The forward over the listed pairs on the layout the route takes
    (the large one with scratch for the minima where dl and dr are None)."""
    n, m = xs.shape[1], ys.shape[1]
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):
        if large_layout(n, m):
            scratch = None
            if dl is None:
                scratch = torch.empty(_lib().dpfx_chamfer_large_scratch_floats(pairs.shape[0], n, m),
                                      dtype=torch.float32, device=xs.device)
            err = _lib().dpfx_chamfer_large_launch(xs.data_ptr(), ys.data_ptr(), pairs.data_ptr(),
                                                   pairs.shape[0], n, m, int(fast), ptr(cd), ptr(dl),
                                                   ptr(dr), ptr(scratch), stream)
        else:
            err = _lib().dpfx_chamfer_launch(xs.data_ptr(), ys.data_ptr(), pairs.data_ptr(),
                                             pairs.shape[0], n, m, int(fast), ptr(cd), ptr(dl),
                                             ptr(dr), stream)
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
    x, y = _fwd_clouds(x, y)
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    dl = torch.empty((b, n), dtype=torch.float32, device=x.device)
    dr = torch.empty((b, m), dtype=torch.float32, device=x.device)
    _launch(x, y, pair_list(b, b, "diag", x.device), False, dl=dl, dr=dr)
    _count("nnd_fwd", large_layout(n, m))
    if not large_layout(n, m):
        clusters["nnd_fwd"].add(cluster_size(b, n, m))
    return dl, dr


def nnd_backward(x: Tensor, y: Tensor, dl: Tensor, dr: Tensor, gl: Tensor, gr: Tensor,
                 three_pass: bool = False) -> Tuple[Tensor, Tensor]:
    """(gx [B,N,3], gy [B,M,3]) from the forward's own minima dl, dr and the
    cotangents gl, gr: the kernel for CUDA tensors (its per-pair path in
    ``last_paths``), the plain version for CPU tensors. ``three_pass``: the
    three-pass kernel on every pair, a reference for tests (counted in
    ``reference_launches``; one CTA holds the pair, so it raises past
    N + M = 9685, where its shared memory does not fit)."""
    global last_paths
    if not x.is_cuda:
        return nn_distances_backward_plain(x, y, dl, dr, gl, gr)
    n, m = x.shape[1], y.shape[1]
    large = large_layout(n, m) and not three_pass
    x, y = check_clouds(x, y, 0 if large else bwd_smem_bytes(n, m, three_pass))
    b = x.shape[0]
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
    paths = torch.empty(b, dtype=torch.uint8, device=x.device)
    args = (x.data_ptr(), y.data_ptr(), b, n, m, *(t.data_ptr() for t in vecs), gx.data_ptr(),
            gy.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if three_pass:
            err = _lib().dpfx_nnd_bwd3_launch(*args, stream)
        elif large:
            scratch = torch.empty(_lib().dpfx_nnd_bwd_large_scratch_words(b, n, m),
                                  dtype=torch.int32, device=x.device)
            err = _lib().dpfx_nnd_bwd_large_launch(*args, paths.data_ptr(), scratch.data_ptr(),
                                                   stream)
        else:
            err = _lib().dpfx_nnd_bwd_launch(*args, paths.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nnd_bwd kernel launch failed: cudaError {err}")
    if three_pass:
        reference_launches["nnd_bwd3"] += 1
    else:
        _count("nnd_bwd", large)
        if not large:
            clusters["nnd_bwd"].add(cluster_size(b, n, m))
        last_paths = paths
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
    xs, ys = _fwd_clouds(xs, ys)
    pairs = pair_list(s1, s2, "upper" if symmetric else "full", xs.device)
    cd = torch.empty(pairs.shape[0], dtype=torch.float32, device=xs.device)
    _launch(xs, ys, pairs, fast, cd=cd)
    _count("cd_pairwise", large_layout(n, m))
    if not large_layout(n, m):
        clusters["cd_pairwise"].add(cluster_size(pairs.shape[0], n, m))
    if not symmetric:
        return cd.view(s1, s2)
    out = torch.empty((s1, s2), dtype=torch.float32, device=xs.device)
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    out[i, j] = cd
    out[j, i] = cd
    return out
