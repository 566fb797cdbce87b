"""Fused latent-prior flow: log p(z) with its backward (training) and the
inverse eps -> z (sampling), each all K couplings in one CUDA kernel.

Replaces the three Pallas TPU kernels of ``dpfx/ops/fused_latent.py``:
``_lat_fwd_kernel`` (forward and per-sample log-det), ``_lat_bwd_kernel``
(one reverse walk from u: dz and every weight gradient) and
``_lat_inv_kernel``. The CUDA kernels are in ``csrc/fused_latent.cu``; see
its header for the design and what bounds them. In bf16 each layer is split
across a thread-block cluster (``cluster_plan`` chooses the cluster and the
group of samples it owns); f32, the check mode, runs block-wide kernels.
``_LatentForward`` wraps the forward and backward as one
``torch.autograd.Function``.

Layout: feature-last, z [B, dz], as the port's ``CouplingFlow`` (the JAX
package puts dz on the TPU's sublane axis, [dz, B], and pads B to 128
lanes; the port takes any B without padding). The stacked weights are
those of ``stack_latent_params_jnp``: the mask folded into ``win``, the
``out`` layer split into the ``ws/bs`` and ``wt/bt`` stacks, biases
[K, n, 1].

Rounding follows the Pallas kernels, not the modules: matmul operands in
the compute dtype with float32 accumulation, bias and relu in float32, one
cast; the coupling, the tanh cap and the log-det are float32. The backward
casts every cotangent to the compute dtype before a product and sums bias
gradients in float32.

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises). ``launches`` counts the
kernel launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from dpfx_torch.models.coupling import CouplingFlow, make_masks
from dpfx_torch.models.dpf import dtype_of
from dpfx_torch.ops._build import SMEM_LIMIT

Tensor = torch.Tensor
Weights = Dict[str, Tensor]

# kernel launches per wrapper; chip_smoke.py zeroes these around the main paths
launches: Dict[str, int] = {"fused_latent_fwd": 0, "fused_latent_bwd": 0, "fused_latent_inv": 0}

KEYS = ("win", "bin", "wh", "bh", "ws", "bs", "wt", "bt")
MATRICES = ("win", "wh", "ws", "wt")
MAX_BWD_BLOCKS = 32    # bounds the f32 backward's per-block gradient scratch
# bf16: CTAs per cluster and samples per cluster, the fastest of the plans
# timed at the flagship (PERF.md: every exchange moves a group's whole
# activations through distributed shared memory, so the smallest group
# wins, the backward's slice reduction included); the backward's clusters,
# each writing one gradient slice when there is more than one group
CLUSTER = 16
GROUP = 16
MAX_BWD_CLUSTERS = 8


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def fused_latent_supported(flow_cfg, dz: int) -> bool:
    """The conditions of ``dpfx``'s fused latent flow: relu (the backward
    needs its derivative), no actnorm, dz > 16 and dz % 8 == 0."""
    return (flow_cfg.activation == "relu" and not flow_cfg.use_actnorm
            and dz % 8 == 0 and dz > 16)


def stack_latent_params(flow: CouplingFlow) -> Weights:
    """Stack the latent flow's conditioner weights as
    ``stack_latent_params_jnp`` does: ``win`` [K, H, D] with the input mask
    folded in, ``wh`` [K, n_hidden-1, H, H], ``ws``/``wt`` [K, D, H] from the
    ``out`` layer, biases [K, n, 1]; float32. Every op is linear (mask fold,
    slice, stack), so gradients reach the ``nn.Linear`` parameters: the
    training path takes its weights from here. Samplers call it under
    ``torch.no_grad()``."""
    d = flow.dim
    parts = {k: [] for k in KEYS}
    for ki in range(flow.n_layers):
        c = flow.coupling(ki)
        cn = c.cond_net
        parts["win"].append(cn.in_x.weight * c.mask[None, :])
        parts["bin"].append(cn.in_x.bias)
        hidden = [getattr(cn, f"hidden_{i}") for i in range(cn.n_hidden - 1)]
        h = cn.in_x.weight.shape[0]
        like = cn.in_x.weight
        parts["wh"].append(torch.stack([m.weight for m in hidden]) if hidden
                           else like.new_zeros((0, h, h)))
        parts["bh"].append(torch.stack([m.bias for m in hidden]) if hidden
                           else like.new_zeros((0, h)))
        parts["ws"].append(cn.out.weight[:d])
        parts["bs"].append(cn.out.bias[:d])
        parts["wt"].append(cn.out.weight[d:])
        parts["bt"].append(cn.out.bias[d:])
    out = {k: torch.stack(v).float().contiguous() for k, v in parts.items()}
    for k in ("bin", "bh", "bs", "bt"):
        out[k] = out[k][..., None]
    return out


@functools.lru_cache(maxsize=16)
def latent_masks(n_layers: int, dz: int, device: torch.device) -> Tensor:
    """The latent flow's coupling masks [K, dz], float32 (1 = passthrough)."""
    return torch.from_numpy(make_masks(dz, n_layers)).to(device)


# ---------------------------------------------------------------- plain version

def _rnd(dtype: torch.dtype):
    return lambda a: a.to(dtype).float()


def _conditioner(w: Weights, k: int, x: Tensor, dtype: torch.dtype):
    """Layer k's hidden activations h_0..h_last on x [B, D] (float32 after
    relu) and its (st_s, st_t) [B, D]: the Pallas kernels' ``_cond``/``_st``."""
    rnd = _rnd(dtype)
    h = torch.relu(rnd(x) @ rnd(w["win"][k]).t() + w["bin"][k, :, 0])
    hs = [h]
    for j in range(w["wh"].shape[1]):
        h = torch.relu(rnd(h) @ rnd(w["wh"][k, j]).t() + w["bh"][k, j, :, 0])
        hs.append(h)
    st_s = rnd(h) @ rnd(w["ws"][k]).t() + w["bs"][k, :, 0]
    st_t = rnd(h) @ rnd(w["wt"][k]).t() + w["bt"][k, :, 0]
    return hs, st_s, st_t


def latent_forward_plain(w: Weights, masks: Tensor, cap: float, z: Tensor,
                         dtype: torch.dtype, ranks: int = 1) -> Tuple[Tensor, Tensor]:
    """z [B, D] -> (u [B, D], log-det [B]): the forward kernel's arithmetic.
    With ``ranks`` the log-det sums as the cluster kernel's does: each of
    ``ranks`` slices of the features per layer, each slice's running sum
    kept, the slices' sums added in order at the end."""
    x = z.float()
    parts = x.new_zeros(x.shape[0], ranks)
    for k in range(masks.shape[0]):
        _, st_s, st_t = _conditioner(w, k, x, dtype)
        s = cap * torch.tanh(st_s / cap)
        parts = parts + ((1.0 - masks[k]) * s).view(x.shape[0], ranks, -1).sum(-1)
        x = torch.where(masks[k] > 0, x, x * torch.exp(s) + st_t)
    ld = parts[:, 0]
    for r in range(1, ranks):
        ld = ld + parts[:, r]
    return x, ld


def latent_inverse_plain(w: Weights, masks: Tensor, cap: float, eps: Tensor,
                         dtype: torch.dtype) -> Tensor:
    """eps [B, D] -> z [B, D]: the closed-form layer inverses, last layer first."""
    y = eps.float()
    for k in reversed(range(masks.shape[0])):
        _, st_s, st_t = _conditioner(w, k, y, dtype)
        s = cap * torch.tanh(st_s / cap)
        y = torch.where(masks[k] > 0, y, (y - st_t) * torch.exp(-s))
    return y


def latent_backward_plain(w: Weights, masks: Tensor, cap: float, u: Tensor, du: Tensor,
                          dld: Tensor, dtype: torch.dtype,
                          group: Optional[int] = None) -> Tuple[Tensor, Weights]:
    """The backward kernel's arithmetic: one reverse walk from the forward
    output u, each layer's input rebuilt by the closed-form inverse and its
    conditioner recomputed from the layer output (its passthrough rows are
    the input's). Returns (dz [B, D], the gradient of each stacked weight),
    all float32. With ``group`` the weight gradients sum over each group of
    that many samples, then across the groups in order, as the cluster
    kernel's slices and their reduction do."""
    if group is not None and u.shape[0] > group:
        dzs, total = [], None
        for b0 in range(0, u.shape[0], group):
            sl = slice(b0, b0 + group)
            dz_g, g_g = latent_backward_plain(w, masks, cap, u[sl], du[sl], dld[sl], dtype)
            dzs.append(dz_g)
            total = g_g if total is None else {k: total[k] + g_g[k] for k in KEYS}
        return torch.cat(dzs), total
    rnd = _rnd(dtype)
    y, dy = u.float(), du.float()
    g_ld = dld.float()[:, None]
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    for k in reversed(range(masks.shape[0])):
        keep = masks[k] > 0
        inv = 1.0 - masks[k]
        hs, st_s, st_t = _conditioner(w, k, y, dtype)
        th = torch.tanh(st_s / cap)
        es = torch.exp(cap * th)
        xk = torch.where(keep, y, (y - st_t) / es)
        ds = dy * xk * es * inv + g_ld * inv
        ds_s = ds * (1.0 - th * th)
        d_t = dy * inv
        dh = rnd(ds_s) @ rnd(w["ws"][k]) + rnd(d_t) @ rnd(w["wt"][k])      # [B, H]
        grads["ws"][k] = rnd(ds_s).t() @ rnd(hs[-1])
        grads["bs"][k, :, 0] = ds_s.sum(0)
        grads["wt"][k] = rnd(d_t).t() @ rnd(hs[-1])
        grads["bt"][k, :, 0] = d_t.sum(0)
        for j in reversed(range(w["wh"].shape[1])):
            dh = dh * (hs[j + 1] > 0)
            grads["wh"][k, j] = rnd(dh).t() @ rnd(hs[j])
            grads["bh"][k, j, :, 0] = dh.sum(0)
            dh = rnd(dh) @ rnd(w["wh"][k, j])
        dh = dh * (hs[0] > 0)
        grads["win"][k] = rnd(dh).t() @ rnd(xk)
        grads["bin"][k, :, 0] = dh.sum(0)
        dy = torch.where(keep, dy, dy * es) + rnd(dh) @ rnd(w["win"][k])
        y = xk
    return dy, grads


# ---------------------------------------------------------------- kernel launch

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from dpfx_torch.ops import _build

    lib = _build.load("fused_latent")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    weights = [p] * 9                 # win, bin, wh, bh, ws, bs, wt, bt, masks
    lib.dpfx_fused_latent_flow.argtypes = [
        p, p, p,                      # in, out, log-det (forward only)
        *weights,
        i, i, i, i, i, f, i, i,       # B, D, H, K, n_hidden-1, cap, bf16, inverse
        i, i, p,                      # cluster, group (bf16), stream
    ]
    lib.dpfx_fused_latent_bwd.argtypes = [
        p, p, p, p, p, p,             # u, du, dld, dz, gradient slices, gradients
        *weights,
        i, i, i, i, i, f, i, i,       # B, D, H, K, n_hidden-1, cap, bf16, blocks (bf16: clusters)
        i, i, p,                      # cluster, group (bf16), stream
    ]
    lib.dpfx_fused_latent_smem_bytes.argtypes = [i, i, i, i]
    lib.dpfx_fused_latent_cluster_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.dpfx_fused_latent_tile_samples.argtypes = []
    for fn in (lib.dpfx_fused_latent_flow, lib.dpfx_fused_latent_bwd,
               lib.dpfx_fused_latent_smem_bytes, lib.dpfx_fused_latent_cluster_smem_bytes,
               lib.dpfx_fused_latent_tile_samples):
        fn.restype = ctypes.c_int
    return lib


def _ldp(n: int) -> int:
    return n + 16 if (n // 8) % 2 else n + 8


def _r128(n: int) -> int:
    return (n + 127) // 128 * 128


def cluster_smem_bytes(dz: int, hidden: int, n_hidden_m1: int, group: int, cluster: int,
                       backward: bool) -> int:
    """Dynamic shared memory of one CTA of the bf16 cluster kernels: the
    carve-up of ``csrc/fused_latent.cu``'s ``CLay``, byte for byte."""
    d, h, nh1, g = dz, hidden, n_hidden_m1, group
    hc, dc = h // cluster, d // cluster
    ldd, ldh, lhc, ldc = _ldp(d), _ldp(h), _ldp(hc), _ldp(dc)
    rows = (_r128(hc * ldd * 2) + _r128(nh1 * hc * ldh * 2) + 2 * _r128(dc * ldh * 2)
            + _r128(hc * 4) + _r128(nh1 * hc * 4) + 3 * _r128(dc * 4))
    hb, own = _r128(g * ldh * 2), _r128(g * dc * 4)
    total = _r128(g * ldd * 2) + (nh1 + 1) * hb + 3 * own + _r128(g * 4)
    if not backward:
        return total + _r128(cluster * g * 4) + 2 * rows
    cols = 2 * _r128(d * lhc * 2) + _r128(nh1 * h * lhc * 2) + _r128(h * ldc * 2)
    return (total + own + hb + _r128(max(2 * g * ldd, g * ldh) * 2) + 2 * _r128(g * hc * 4)
            + rows + cols)


@dataclass(frozen=True)
class Plan:
    """How a bf16 launch splits: ``cluster`` CTAs per cluster, ``group``
    samples per cluster, ``clusters`` launched, ``slices`` gradient slices
    of the backward (0: it writes the gradients itself, no reduction),
    ``smem`` bytes of shared memory per CTA."""
    cluster: int
    group: int
    clusters: int
    slices: int
    smem: int


def cluster_plan(b: int, dz: int, hidden: int, n_hidden_m1: int, backward: bool,
                 cluster: Optional[int] = None, group: Optional[int] = None) -> Plan:
    """The split of a bf16 launch of B samples, chosen up front from the
    shapes (the kernel launches exactly this; a launch the card refuses
    raises). Each rank owns hidden / cluster columns and dz / cluster
    features, multiples of 8: by default the largest cluster up to
    ``CLUSTER`` that splits both so; a given ``cluster`` that does not
    raises. The group is ``group``, or ``GROUP`` halved until the CTA's
    shared memory fits. Raises ValueError for shapes the split cannot take."""
    if dz % 16 or hidden % 16 or dz > 2048 or hidden > 2048:
        raise ValueError(f"the fused latent kernels take dz and hidden in multiples of 16 "
                         f"(mma.sync k-steps) up to 2048, got dz={dz}, hidden={hidden}")
    splits = lambda c: dz % (8 * c) == 0 and hidden % (8 * c) == 0
    if cluster is None:
        cluster = CLUSTER
        while cluster > 1 and not splits(cluster):
            cluster //= 2
    elif cluster not in (1, 2, 4, 8, 16) or not splits(cluster):
        raise ValueError(f"a cluster of {cluster} CTAs needs dz and hidden in multiples of "
                         f"{8 * cluster} (8 per rank), got dz={dz}, hidden={hidden}")
    fits = lambda g: cluster_smem_bytes(dz, hidden, n_hidden_m1, g, cluster,
                                        backward) <= SMEM_LIMIT
    if group is None:
        group = GROUP
        while group > 16 and not fits(group):
            group //= 2
    elif group % 16 or not 16 <= group <= 256:
        raise ValueError(f"the group of samples per cluster is a multiple of 16 up to 256, "
                         f"got {group}")
    smem = cluster_smem_bytes(dz, hidden, n_hidden_m1, group, cluster, backward)
    if smem > SMEM_LIMIT:
        raise ValueError(f"dz={dz}, hidden={hidden}, n_hidden={n_hidden_m1 + 1} on clusters of "
                         f"{cluster} with groups of {group} needs {smem} B of shared memory, "
                         f"more than the {SMEM_LIMIT} B a CTA may use")
    groups = -(-b // group)
    clusters = min(groups, MAX_BWD_CLUSTERS) if backward else groups
    return Plan(cluster, group, clusters, clusters if backward and clusters > 1 else 0, smem)


def smem_bytes(dz: int, hidden: int, n_hidden_m1: int, dtype: torch.dtype,
               backward: bool) -> int:
    """Dynamic shared memory of one block (f32, from the kernel library) or
    one CTA of the default cluster plan (bf16)."""
    if dtype == torch.bfloat16:
        return cluster_plan(1, dz, hidden, n_hidden_m1, backward).smem
    return _lib().dpfx_fused_latent_smem_bytes(dz, hidden, n_hidden_m1, int(backward))


def _check(w: Weights, masks: Tensor, dtype: torch.dtype, tensors: Dict[str, Tensor],
           backward: bool, b: int, plan: Optional[Plan]) -> Optional[Plan]:
    """Raise on what the kernels do not take; returns the bf16 plan."""
    k, h, d = w["win"].shape
    nh1 = w["wh"].shape[1]
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel compute dtype must be float32 or bfloat16, got {dtype}")
    if d % 16 or h % 16:
        raise ValueError(f"the fused latent kernels take dz and hidden in multiples of 16, "
                         f"got dz={d}, hidden={h}")
    if dtype == torch.bfloat16:
        want = cluster_plan(b, d, h, nh1, backward, *((plan.cluster, plan.group) if plan else ()))
        if plan is not None and plan != want:
            raise ValueError(f"{plan} is not the plan of B={b} at these widths: {want}")
        plan = want
    elif plan is not None:
        raise ValueError("a cluster plan is for the bf16 kernels; f32 runs block-wide")
    else:
        need = smem_bytes(d, h, nh1, dtype, backward)
        if need > SMEM_LIMIT:
            raise ValueError(f"dz={d}, hidden={h}, n_hidden={nh1 + 1} in {dtype} needs {need} B "
                             f"of shared memory, more than the {SMEM_LIMIT} B a block may use")
    dev = w["win"].device
    for name, t in {**w, "masks": masks, **tensors}.items():
        if not (t.is_cuda and t.device == dev):
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, is on {t.device}")
        ok = (torch.float32, dtype) if name in MATRICES else (torch.float32,)
        if not t.is_contiguous() or t.dtype not in ok:
            raise ValueError(f"{name} must be a contiguous tensor of "
                             f"{' or '.join(str(x) for x in dict.fromkeys(ok))}")
        if plan is not None and name in (*KEYS, "masks") and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the bf16 kernels copy "
                             "weights 16 B at a time)")
    return plan


def cast_latent_weights(w: Weights, dtype: torch.dtype) -> Weights:
    """The stacked weights with the matrices cast to the compute dtype once
    (the cast is the kernels' rounding): samplers keep this, so that no
    call casts them again. The plain versions and the kernels take either."""
    return {n: v.to(dtype).contiguous() if n in MATRICES else v for n, v in w.items()}


def _weight_args(w: Weights, masks: Tensor, dtype: torch.dtype):
    """The kernels' weight pointers: matrices in the compute dtype (cast
    here unless they already are), f32 biases. Returns (pointers, the cast
    tensors, which must outlive the launch)."""
    cast = {n: w[n].to(dtype).contiguous() for n in MATRICES}
    nh1 = w["wh"].shape[1]
    ptrs = [cast["win"].data_ptr(), w["bin"].data_ptr(),
            cast["wh"].data_ptr() if nh1 else None, w["bh"].data_ptr() if nh1 else None,
            cast["ws"].data_ptr(), w["bs"].data_ptr(), cast["wt"].data_ptr(),
            w["bt"].data_ptr(), masks.data_ptr()]
    return ptrs, cast


def _flow_kernel(w: Weights, masks: Tensor, cap: float, x: Tensor, dtype: torch.dtype,
                 inverse: bool, plan: Optional[Plan]):
    k, h, d = w["win"].shape
    b = x.shape[0]
    plan = _check(w, masks, dtype, {"z" if not inverse else "eps": x}, False, b, plan)
    out = torch.empty_like(x)
    ld = None if inverse else torch.empty(b, device=x.device, dtype=torch.float32)
    ptrs, _keep = _weight_args(w, masks, dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().dpfx_fused_latent_flow(
            x.data_ptr(), out.data_ptr(), None if ld is None else ld.data_ptr(), *ptrs,
            b, d, h, k, w["wh"].shape[1], float(cap), int(plan is not None), int(inverse),
            plan.cluster if plan else 0, plan.group if plan else 0, stream)
    if err != 0:
        raise RuntimeError(f"fused latent {'inverse' if inverse else 'forward'} kernel launch "
                           f"failed: cudaError {err} ({plan})")
    return out, ld


def latent_forward_kernel(w: Weights, masks: Tensor, cap: float, z: Tensor,
                          dtype: torch.dtype, plan: Optional[Plan] = None
                          ) -> Tuple[Tensor, Tensor]:
    """The forward kernel: same contract as ``latent_forward_plain``. bf16
    runs on clusters as ``plan`` (default: ``cluster_plan``'s) splits it."""
    u, ld = _flow_kernel(w, masks, cap, z, dtype, False, plan)
    launches["fused_latent_fwd"] += 1
    return u, ld


def latent_inverse_kernel(w: Weights, masks: Tensor, cap: float, eps: Tensor,
                          dtype: torch.dtype, plan: Optional[Plan] = None) -> Tensor:
    """The inverse kernel: same contract as ``latent_inverse_plain``."""
    z, _ = _flow_kernel(w, masks, cap, eps, dtype, True, plan)
    launches["fused_latent_inv"] += 1
    return z


def latent_backward_kernel(w: Weights, masks: Tensor, cap: float, u: Tensor, du: Tensor,
                           dld: Tensor, dtype: torch.dtype, plan: Optional[Plan] = None
                           ) -> Tuple[Tensor, Weights]:
    """The backward kernel, then (f32, or bf16 above one group of samples)
    the fixed-order reduction of its gradient slices: same contract as
    ``latent_backward_plain``, and bit-identical from run to run."""
    k, h, d = w["win"].shape
    nh1 = w["wh"].shape[1]
    b = u.shape[0]
    plan = _check(w, masks, dtype, dict(u=u, du=du, dld=dld), True, b, plan)
    if plan is None:
        blocks = min(-(-b // _lib().dpfx_fused_latent_tile_samples()), MAX_BWD_BLOCKS)
        n_slices = blocks
    else:
        blocks = plan.clusters
        n_slices = plan.slices
    sizes = {"win": h * d, "bin": h, "wh": nh1 * h * h, "bh": nh1 * h,
             "ws": d * h, "bs": d, "wt": d * h, "bt": d}
    per_layer = sum(sizes.values())
    part = (torch.empty((n_slices, k, per_layer), device=u.device, dtype=torch.float32)
            if n_slices else None)
    dw = torch.empty((k, per_layer), device=u.device, dtype=torch.float32)
    dz = torch.empty_like(u)
    ptrs, _keep = _weight_args(w, masks, dtype)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        err = _lib().dpfx_fused_latent_bwd(
            u.data_ptr(), du.data_ptr(), dld.data_ptr(), dz.data_ptr(),
            None if part is None else part.data_ptr(), dw.data_ptr(), *ptrs, b, d, h, k, nh1,
            float(cap), int(plan is not None), blocks, plan.cluster if plan else 0,
            plan.group if plan else 0, stream)
    if err != 0:
        raise RuntimeError(f"fused latent backward kernel launch failed: cudaError {err} ({plan})")
    launches["fused_latent_bwd"] += 1
    grads, o = {}, 0
    for name in KEYS:
        grads[name] = dw[:, o:o + sizes[name]].reshape(w[name].shape)
        o += sizes[name]
    return dz, grads


# ---------------------------------------------------------------- autograd

class _LatentForward(torch.autograd.Function):
    """(z, stacked weights) -> (u, log-det); the backward kernel gives every
    gradient. The residual is u, not z: the backward rebuilds each layer's
    input from its output."""

    @staticmethod
    def forward(ctx, z, masks, cap, dtype, *weights):
        w = dict(zip(KEYS, weights))
        if z.is_cuda:
            w = cast_latent_weights(w, dtype)   # once for the forward and the backward
            u, ld = latent_forward_kernel(w, masks, cap, z, dtype)
        else:
            u, ld = latent_forward_plain(w, masks, cap, z, dtype)
        ctx.save_for_backward(masks, u, *(w[k] for k in KEYS))
        ctx.cap, ctx.dtype = cap, dtype
        return u, ld

    @staticmethod
    def backward(ctx, du, dld):
        masks, u, *weights = ctx.saved_tensors
        du = torch.zeros_like(u) if du is None else du.float().contiguous()
        dld = (torch.zeros(u.shape[0], device=u.device) if dld is None
               else dld.float().contiguous())
        bwd = latent_backward_kernel if u.is_cuda else latent_backward_plain
        dz, dw = bwd(dict(zip(KEYS, weights)), masks, ctx.cap, u, du, dld, ctx.dtype)
        return (dz, None, None, None, *(dw[k] for k in KEYS))


def fused_latent_log_prob(model, z: Tensor, flow_cfg) -> Tensor:
    """log p(z) under a DPF ``model``'s latent prior flow: z [B, dz] -> [B],
    through the fused kernels. Drop-in for ``model.latent_flow.log_prob(z)``
    (the same math, with the kernels' rounding); the base term is added
    outside the kernel."""
    w = stack_latent_params(model.latent_flow)
    masks = latent_masks(flow_cfg.n_layers, z.shape[-1], z.device)
    u, ld = _LatentForward.apply(z.float().contiguous(), masks, float(flow_cfg.scale_cap),
                                 dtype_of(flow_cfg.compute_dtype), *(w[k] for k in KEYS))
    return -0.5 * (u * u + math.log(2.0 * math.pi)).sum(-1) + ld


def fused_latent_inverse(stacked: Weights, eps: Tensor, flow_cfg) -> Tensor:
    """eps [B, dz] -> z [B, dz] through the closed-form layer inverses, with
    weights from ``stack_latent_params`` (stacked once per sampler, and
    cast once by ``cast_latent_weights``: then no call casts them)."""
    masks = latent_masks(flow_cfg.n_layers, eps.shape[-1], eps.device)
    eps = eps.float().contiguous()
    inv = latent_inverse_kernel if eps.is_cuda else latent_inverse_plain
    return inv(stacked, masks, float(flow_cfg.scale_cap), eps, dtype_of(flow_cfg.compute_dtype))
