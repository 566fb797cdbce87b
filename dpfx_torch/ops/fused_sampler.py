"""Fused inverse point flow: all K inverted couplings in one CUDA kernel.

Replaces the two Pallas TPU kernels of ``dpfx/ops/fused_sampler.py``:
``_fused_inverse_kernel`` (the inverse on a supplied base noise ``u``) and
``_fused_sample_kernel`` (the same inverse with ``u`` drawn inside the
kernel). One CUDA kernel (``csrc/fused_sampler.cu``) serves both; see its
header for the design and what bounds it.

Layout at the public functions: the transposed tile ``ut [B, C, N]``
(coordinates in rows 0-2; rows 3.. of a C=8 input pass through untouched,
as in the JAX package) and the point-major ``[B, N, 3]``. The per-cloud,
per-layer z-projection ``hz = z @ Wz + bx`` is one einsum outside the
kernel, in float32, as in the JAX package.

Rounding follows the Pallas kernel, not the flax modules: matmul operands
in the compute dtype with float32 accumulation, the bias and ``hz`` added in
float32, the activation applied in float32 and the result cast back to the
compute dtype; the coupling arithmetic is float32.

``fused_sample_points(..., quantized=quantize_flow_params(sp))`` runs the
int8 mode of ``dpfx``: Wx, Wh and Wout as int8 with one f32 scale per
(layer, tensor), dequantized where the kernel stages each layer's weights,
as ``rnd(q * s)`` in the compute dtype. That equals, bit for bit, the
kernel on the host-dequantized stacks (``dequantize``) on the same layout,
which is also the plain version (the two modes take the same layout but
at H=128 with n_hidden 3-4, where ``CLUSTER_CASES`` routes each as timed).

The kernel draws its base noise with Philox4x32-10 keyed by the seed and
counted by (point, cloud), then Box-Muller; ``philox_noise_plain`` is the
same stream in plain torch ops (exact integer rounds, f32 Box-Muller), so
the stream can be pinned on the CPU.

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises). ``launches`` counts the
kernel launches of each wrapper, ``layout_launches`` the same by layout.

Layouts (``inverse_layout``): f32 runs ``f32_kernel``; bf16 runs the
cluster inverse (``inv_cluster`` in ``csrc/flow_cluster.cuh``: a layer
split across a thread-block cluster of H / 64 CTAs, on the training
forward's (s, t) code) at the shapes where the training kernels take their
cluster layout (``fused_train.uses_cluster``) and the inverse is built
(``CLUSTER_INVERSE``), in the cases that timed faster there than
``rows_kernel`` (``ROWS_KEPT``, ``CLUSTER_CASES``): at H=256 with n_hidden
2-4 every activation, with weights in bf16 or int8; at H=128 with n_hidden
3-4 the activations other than relu, and some int8 cases. Every other bf16
case (the shapes a block holds, relu with bf16 weights at H=128) runs
``rows_kernel``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dpfx_torch.models.coupling import ACTIVATIONS, CouplingFlow
from dpfx_torch.ops._build import SMEM_LIMIT

Tensor = torch.Tensor

# kernel launches per wrapper; chip_smoke.py zeroes these around the main path
launches: Dict[str, int] = {"fused_inverse": 0, "fused_sample": 0, "fused_sample_int8": 0}
# the same launches by the layout that ran them (inverse_layout's names)
layout_launches: Dict[str, int] = {"rows": 0, "cluster": 0, "f32": 0}

ACT_CODES = {"relu": 0, "gelu": 1, "tanh": 2, "leaky_relu": 3}
KERNEL_HIDDEN = (32, 64, 128, 256)     # conditioner widths the kernel is built for
WIDER = "ROADMAP.md, queue 'Point flows wider than 256'"


def kernel_hidden(hidden: int) -> int:
    """The kernels' width for a conditioner of ``hidden`` units: the next
    width of ``KERNEL_HIDDEN`` (the stacks are zero-padded up to it), or
    ``hidden`` itself above 256, which no kernel takes."""
    return next((w for w in KERNEL_HIDDEN if w >= hidden), hidden)


def reset_launch_counts() -> None:
    for counts in (launches, layout_launches):
        for k in counts:
            counts[k] = 0


class StackedFlowParams(NamedTuple):
    """Per-layer conditioner weights of the point flow, stacked on a leading
    K axis (float32). Weight matrices are [out, in]."""

    wx: Tensor     # [K, H, 3]  in_x weight with the layer's mask folded in
    wz: Tensor     # [K, dz, H] in_z (used outside the kernel for hz)
    bx: Tensor     # [K, H]
    wh: Tensor     # [K, n_hidden-1, H, H]
    bh: Tensor     # [K, n_hidden-1, H]
    wout: Tensor   # [K, 6, H]  rows 0-2 = s, 3-5 = t
    bout: Tensor   # [K, 6]
    masks: Tensor  # [K, 3]     1 = passthrough
    scale_cap: float


def stack_point_flow_params(flow: CouplingFlow) -> StackedFlowParams:
    """Stack the conditioner weights of a point flow (dim 3) module. Every
    op is linear (transpose, mask fold, stack, zero padding), so gradients
    reach the ``nn.Linear`` parameters: the training kernels take their
    weights from here. Samplers call it under ``torch.no_grad()``.

    H is zero-padded up to ``kernel_hidden(H)``, the width the kernels are
    built for. The padding is exact: a padded unit has zero in-weights (Wx,
    Wz, the Wh rows) and zero bias, so its activation is act(0) = 0 for
    every activation here, and zero out-weights (the Wh and Wout columns),
    so it adds 0 to every sum; an FMA with a zero operand leaves an f32 sum
    unchanged. The padded entries' gradients are dropped (``F.pad``'s
    backward is a slice)."""
    if flow.dim != 3:
        raise ValueError(f"the fused sampler takes the 3-D point flow, got dim {flow.dim}")
    wx, wz, bx, wh, bh, wout, bout, masks = [], [], [], [], [], [], [], []
    for k in range(flow.n_layers):
        c = flow.coupling(k)
        cn = c.cond_net
        # fold the input mask into Wx: Wx @ (x*m) == (Wx*m) @ x
        wx.append(cn.in_x.weight * c.mask[None, :])
        wz.append(cn.in_z.weight.t())
        bx.append(cn.in_x.bias)
        hidden = [getattr(cn, f"hidden_{i}") for i in range(cn.n_hidden - 1)]
        h = cn.in_x.weight.shape[0]
        like = cn.in_x.weight
        wh.append(torch.stack([m.weight for m in hidden]) if hidden else like.new_zeros((0, h, h)))
        bh.append(torch.stack([m.bias for m in hidden]) if hidden else like.new_zeros((0, h)))
        wout.append(cn.out.weight)
        bout.append(cn.out.bias)
        masks.append(c.mask)
    h = wx[0].shape[0]
    p = kernel_hidden(h) - h
    f = lambda xs, *pad: (F.pad(torch.stack(xs).float(), pad) if p else torch.stack(xs).float()
                          ).contiguous()
    return StackedFlowParams(f(wx, 0, 0, 0, p), f(wz, 0, p), f(bx, 0, p),
                             f(wh, 0, p, 0, p), f(bh, 0, p), f(wout, 0, p), f(bout), f(masks),
                             float(flow.scale_cap))


class QuantizedFlowParams(NamedTuple):
    """StackedFlowParams whose wx, wh and wout hold int8 stacks, with one f32
    scale per (layer, tensor) in ``scales`` [K, 8]: column 0 = wx, 1 = wh
    (shared by the layer's hidden products), 2 = wout, the rest unused."""

    sp: StackedFlowParams
    scales: Tensor


def quantize_flow_params(sp: StackedFlowParams) -> QuantizedFlowParams:
    """Symmetric int8 quantization of wx, wh and wout per (layer, tensor), as
    ``dpfx``'s ``quantize_flow_params``: scale = max(amax, 1e-8) / 127, q =
    clip(round(w / scale), -127, 127), rounding half to even. Biases, masks
    and wz (the z-projection) stay f32; an empty wh gets scale 1."""
    def q(w):
        amax = w.abs().flatten(1).amax(1)
        scale = torch.clamp_min(amax, 1e-8) / 127.0
        sc = scale.view(-1, *([1] * (w.dim() - 1)))
        return torch.clamp(torch.round(w / sc), -127, 127).to(torch.int8), scale

    k = sp.wx.shape[0]
    wxq, s_wx = q(sp.wx)
    whq, s_wh = q(sp.wh) if sp.wh.numel() else (sp.wh.to(torch.int8), sp.wx.new_ones(k))
    woq, s_wo = q(sp.wout)
    scales = sp.wx.new_zeros((k, 8))
    scales[:, 0], scales[:, 1], scales[:, 2] = s_wx, s_wh, s_wo
    return QuantizedFlowParams(sp._replace(wx=wxq, wh=whq, wout=woq), scales)


def dequantize(qp: QuantizedFlowParams) -> StackedFlowParams:
    """The f32 stacks the int8 mode computes with: q * scale per (layer,
    tensor), in f32."""
    s = qp.scales
    deq = lambda w, c: (w.float() * s[:, c].view(-1, *([1] * (w.dim() - 1)))).contiguous()
    return qp.sp._replace(wx=deq(qp.sp.wx, 0), wh=deq(qp.sp.wh, 1), wout=deq(qp.sp.wout, 2))


def z_projection(sp: StackedFlowParams, z: Tensor) -> Tensor:
    """hz[b, k] = z[b] @ Wz[k] + bx[k], float32: [B, K, H]."""
    return (torch.einsum("bd,kdh->bkh", z.float(), sp.wz) + sp.bx).contiguous()


# ---------------------------------------------------------------- plain version

def fused_inverse_transposed_plain(sp: StackedFlowParams, ut: Tensor, hz: Tensor,
                                   dtype: torch.dtype = torch.bfloat16,
                                   activation: str = "relu") -> Tensor:
    """The kernel's arithmetic in plain torch ops: ut [B, C, N] -> x [B, C, N].

    Operands are rounded to ``dtype`` and multiplied in float32 (exact for
    bf16 operands), so the sums are float32 as on the tensor cores. On a
    card the float32 einsums are IEEE only with
    ``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default),
    which the entry points set. ``dtype=torch.float64`` on f64 inputs is
    the f64 reference (every operand and sum in f64)."""
    act = ACTIVATIONS[activation]
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    rnd = lambda a: a.to(dtype).to(acc)
    out = ut.clone()
    x = ut[:, :3].to(acc)
    for k in reversed(range(sp.wx.shape[0])):
        h = torch.einsum("hc,bcn->bhn", rnd(sp.wx[k]), rnd(x)) + hz[:, k, :, None]
        h = rnd(act(h))
        for j in range(sp.wh.shape[1]):
            h = torch.einsum("oi,bin->bon", rnd(sp.wh[k, j]), h) + sp.bh[k, j][:, None]
            h = rnd(act(h))
        st = torch.einsum("oh,bhn->bon", rnd(sp.wout[k]), h) + sp.bout[k][:, None]
        s = sp.scale_cap * torch.tanh(st[:, :3] / sp.scale_cap)
        x = torch.where(sp.masks[k][:, None] > 0, x, (x - st[:, 3:6]) * torch.exp(-s))
    out[:, :3] = x
    return out


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mul_hi_lo(m: int, c: Tensor) -> Tuple[Tensor, Tensor]:
    """(high, low) 32-bit halves of the 64-bit product m * c, c holding
    uint32 values in int64: the product is taken in 16-bit parts so that no
    intermediate passes 2^49."""
    a = c * (m & 0xFFFF)                        # < 2^48
    b = c * (m >> 16)                           # < 2^48
    t = a + ((b & 0xFFFF) << 16)                # < 2^49
    return ((b >> 16) + (t >> 32)) & _U32, t & _U32


def _philox(c, k0: int, k1: int):
    """Philox4x32-10 on counters c (four int64 tensors of uint32 values)
    with the key (k0, k1), as the kernel's ``philox``."""
    c0, c1, c2, c3 = c
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mul_hi_lo(_PHILOX_M[0], c0)
        hi1, lo1 = _mul_hi_lo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _box_muller(a: Tensor, b: Tensor) -> Tensor:
    """The kernel's ``box_muller`` in f32: u1 = (a >> 8) 2^-24 + 1e-7, u2 =
    (b >> 8) 2^-24, sqrt(-2 log u1) cos(2 pi u2)."""
    inv24 = 1.0 / 16777216.0
    u1 = (a >> 8).float() * inv24 + torch.tensor(1e-7, dtype=torch.float32)
    u2 = (b >> 8).float() * inv24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        torch.tensor(6.283185307179586, dtype=torch.float32) * u2)


def philox_noise_plain(seed: int, b: int, n: int, scale: float = 1.0,
                       device="cpu") -> Tensor:
    """The kernel's base noise u [B, N, 3] for an integer seed: point p of
    cloud c from two Philox4x32-10 draws keyed by (seed low, seed high) with
    counters (p, c, 0, 0) and (p, c, 1, 0), each pair of words through
    Box-Muller, times ``scale`` in f32. Keyed by (seed, cloud, point): a
    prefix of the points draws the same noise. The integer rounds are exact
    (int64 ops on uint32 values); the transcendental functions are torch's
    f32 ones, a few ulps from the card's."""
    seed = int(seed) & (2**64 - 1)
    k0, k1 = seed & _U32, seed >> 32
    p = torch.arange(n, dtype=torch.int64, device=device)[None, :].expand(b, n)
    c = torch.arange(b, dtype=torch.int64, device=device)[:, None].expand(b, n)
    zero = torch.zeros_like(p)
    r0 = _philox((p, c, zero, zero), k0, k1)
    r1 = _philox((p, c, zero + 1, zero), k0, k1)
    u = torch.stack([_box_muller(r0[0], r0[1]), _box_muller(r0[2], r0[3]),
                     _box_muller(r1[0], r1[1])], dim=-1)
    return u * torch.tensor(scale, dtype=torch.float32)


def fused_sample_points_plain(sp: StackedFlowParams, hz: Tensor, seed: int, n_points: int,
                              dtype: torch.dtype = torch.bfloat16, activation: str = "relu",
                              noise_scale: float = 1.0) -> Tuple[Tensor, Tensor]:
    """u = noise_scale * N(0, I) from a torch generator seeded with ``seed``,
    then the plain inverse. Returns (x, u), both [B, 3, N]. Same
    distribution as the kernel's Philox stream, not the same numbers."""
    g = torch.Generator(device=hz.device).manual_seed(int(seed))
    u = torch.randn((hz.shape[0], 3, n_points), generator=g, device=hz.device) * noise_scale
    return fused_inverse_transposed_plain(sp, u, hz, dtype, activation), u


# ---------------------------------------------------------------- kernel launch

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from dpfx_torch.ops import _build

    lib = _build.load("fused_sampler")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dpfx_fused_sampler_launch.argtypes = [
        p, p, p, p,                   # hz, ut (null: draw u), out, u_out (nullable)
        p, p, p, p, p, p,             # wx, wh, bh, wout, bout, masks
        i, i, i, i, i, i,             # B, C, N, K, H, n_hidden-1
        ctypes.c_float, i, i,         # scale cap, activation code, bf16
        ctypes.c_uint64, ctypes.c_float,  # seed, noise scale
        p,                            # int8 scales [K, 8] (null: weights in the compute dtype)
        p,                            # stream
    ]
    lib.dpfx_fused_sampler_launch.restype = ctypes.c_int
    lib.dpfx_fused_sampler_smem_bytes.argtypes = [i, i, i, i]
    lib.dpfx_fused_sampler_smem_bytes.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _cluster_lib() -> ctypes.CDLL:
    """The cluster inverse's entry points (``inv_cluster``)."""
    lib = _lib()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dpfx_fused_sampler_cluster_launch.argtypes = [
        p, p, p, p, p,                # hz, ut (null: draw u), out, u_out (nullable), carry
        p, p, p, p, p, p,             # wx, wh, bh, wout, bout, masks
        i, i, i, i, i, i,             # B, C, N, K, H, n_hidden-1
        ctypes.c_float, ctypes.c_uint64, ctypes.c_float,  # scale cap, seed, noise scale
        i, p,                         # activation code, int8 scales [K, 8] (null: bf16 weights)
        i, p,                         # clusters, stream
    ]
    lib.dpfx_fused_sampler_cluster_smem_bytes.argtypes = [i, i]
    lib.dpfx_fused_sampler_cluster_grid.argtypes = [i, i]
    lib.dpfx_fused_sampler_cluster_built.argtypes = [i, i, i, i]   # H, n_hidden-1, act, int8
    for fn in (lib.dpfx_fused_sampler_cluster_launch, lib.dpfx_fused_sampler_cluster_smem_bytes,
               lib.dpfx_fused_sampler_cluster_grid, lib.dpfx_fused_sampler_cluster_built):
        fn.restype = ctypes.c_int
    return lib


def _error_text(err: int) -> str:
    """The CUDA runtime's text for a launch's error (a library built before
    the text was exported gives none)."""
    fn = getattr(_lib(), "dpfx_fused_sampler_error_string", None)
    if fn is None:
        return ""
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return f" ({fn(err).decode()})"


@functools.lru_cache(maxsize=None)
def _cluster_grid(hidden: int, n_hidden_m1: int, device_index: int) -> int:
    """Clusters of the cluster inverse's persistent grid: as many as the
    card holds at once (the same for every activation and the int8 mode:
    their instances share the shape's block and shared memory)."""
    with torch.cuda.device(device_index):
        n = _cluster_lib().dpfx_fused_sampler_cluster_grid(hidden, n_hidden_m1)
    if n <= 0:
        raise RuntimeError(f"the card holds no cluster of the cluster inverse at hidden={hidden}, "
                           f"n_hidden={n_hidden_m1 + 1}")
    return n


# the cluster layout's shapes (H, n_hidden - 1) where rows_kernel timed
# faster than the cluster inverse in turns for relu with weights in bf16
# (B=64 x 2048, K=32; PERF.md: H=128 with n_hidden 3 and 4, where
# rows_kernel keeps two weight stages, 1.487 / 2.097 ms against 2.445 /
# 3.680 on an H100): that case stays on rows_kernel there; chip_smoke.py
# phase 3l times both at each shape
ROWS_KEPT: Tuple[Tuple[int, int], ...] = ((128, 2), (128, 3))
# the shapes (H, n_hidden - 1) csrc/fused_sampler.cu builds inv_cluster for:
# every cluster shape (each training forward plan stages whole layers)
CLUSTER_INVERSE: Tuple[Tuple[int, int], ...] = ((128, 2), (128, 3), (256, 1), (256, 2), (256, 3))
_OTHER = ("gelu", "tanh", "leaky_relu")
# the cluster inverse's other cases at each shape of CLUSTER_INVERSE: (the
# activations besides relu with weights in bf16, the activations with int8
# weights) that run inv_cluster (csrc/fused_sampler.cu's int8_relu_case and
# int8_other_case build them). Every case at H=256; at H=128 those that
# timed faster than rows_kernel in turns (B=64 x 2048, K=32, PERF.md: the
# other activations 4.9 / 6.5 ms against 5.6-6.3 / 7.8-8.8; int8 relu at
# n_hidden 4 3.62 against 3.95, at 3 2.47 against 1.78; int8 with the others
# at n_hidden 3 4.7 against 6.1-7.2, at 4 6.5 against 4.9-5.4)
CLUSTER_CASES: Dict[Tuple[int, int], Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    (128, 2): (_OTHER, _OTHER),
    (128, 3): (_OTHER, ("relu",)),
    **{(256, nh1): (_OTHER, ("relu",) + _OTHER) for nh1 in (1, 2, 3)},
}


def inverse_layout(hidden: int, n_hidden_m1: int, dtype: torch.dtype,
                   activation: str = "relu", int8: bool = False) -> str:
    """The layout that runs the inverse: "f32" (``f32_kernel``), "cluster"
    (``inv_cluster``: bf16 at the shapes of ``CLUSTER_INVERSE`` where
    ``fused_train.uses_cluster`` holds, for relu with weights in bf16 but
    at ``ROWS_KEPT``, for the other cases those of ``CLUSTER_CASES``) or
    "rows" (``rows_kernel``: every other bf16 case)."""
    if dtype != torch.bfloat16:
        return "f32"
    shape = (hidden, n_hidden_m1)
    if shape not in CLUSTER_INVERSE:
        return "rows"
    if int8:
        taken = activation in CLUSTER_CASES[shape][1]
    else:
        taken = shape not in ROWS_KEPT if activation == "relu" else activation in CLUSTER_CASES[shape][0]
    if not taken:
        return "rows"
    from dpfx_torch.ops import fused_train   # imports this module

    return "cluster" if fused_train.uses_cluster(hidden, n_hidden_m1, dtype) else "rows"


def smem_bytes(hidden: int, dtype: torch.dtype, n_hidden_m1: int = 1, int8: bool = False) -> int:
    """Dynamic shared memory of one block of ``rows_kernel`` (bf16) or
    ``f32_kernel``; mirrors the kernels' layouts. bf16: the warps' [16][8]
    f32 exchange, then two stages of a whole layer's weights (Wh, Wout and
    Wx^T in rows of H + 8) where they fit and H < 256, with the int8 mode's
    raw Wh bytes, else one stage with one Wh. f32: the block's 128 points in
    rows of H + 1, their x and (s, t), then chunk buffers (Wh columns in
    rows of KC + 1, the whole row up to H=128 and 32 at H=256, and the
    product's bh) and sets of a layer's small weights (Wx, hz, Wout, bout):
    two of each from H=128 on, where the chunks stream behind the products,
    else one."""
    r = lambda n: (n + 127) // 128 * 128
    if dtype == torch.bfloat16:
        ld, o = hidden + 8, 8 * 16 * 8 * 4
        w8 = r(8 * ld * 2)
        raw = r(n_hidden_m1 * hidden * hidden) if int8 else 0
        if hidden < 256 and o + raw + 2 * (r(n_hidden_m1 * hidden * ld * 2) + 2 * w8) <= SMEM_LIMIT:
            return o + raw + 2 * (r(n_hidden_m1 * hidden * ld * 2) + 2 * w8)
        return o + r(min(n_hidden_m1, 1) * hidden * ld * 2) + 2 * w8
    t = 128
    kc = hidden if hidden <= 128 else 32
    nbuf = 2 if hidden >= 128 else 1
    chunk = r(hidden * (kc + 1) * 4) + r(hidden * 4)
    small = r(3 * hidden * 4) + r(hidden * 4) + r(6 * hidden * 4) + r(8 * 4)
    return r(t * (hidden + 1) * 4) + r(3 * t * 4) + r(6 * t * 4) + nbuf * (chunk + small)


def _check_kernel_args(sp: StackedFlowParams, hz: Tensor, dtype: torch.dtype,
                       activation: str, int8: bool = False) -> None:
    k, h, _ = sp.wx.shape
    nh1 = sp.wh.shape[1]
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel compute dtype must be float32 or bfloat16, got {dtype}")
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if h not in KERNEL_HIDDEN:
        raise ValueError(f"the fused sampler kernel is built for hidden in {KERNEL_HIDDEN} "
                         f"(stack_point_flow_params pads up to them), got {h}; wider point "
                         f"flows: {WIDER}")
    need = smem_bytes(h, dtype, nh1, int8)
    if need > SMEM_LIMIT:
        raise ValueError(f"hidden={h}, n_hidden={nh1 + 1} in {dtype} needs {need} B of shared "
                         f"memory, more than the {SMEM_LIMIT} B a block may use ({WIDER})")
    for name, t in list(sp._asdict().items())[:-1] + [("hz", hz)]:
        if not (t.is_cuda and t.device == hz.device):
            raise ValueError(f"{name} must be a CUDA tensor on {hz.device}, is on {t.device}")
        if not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    if hz.shape[1:] != (k, h):
        raise ValueError(f"hz shape {tuple(hz.shape)} does not match K={k}, H={h}")


def _check_quantized(sp: StackedFlowParams, qp: QuantizedFlowParams) -> None:
    for name in ("wx", "wh", "wout"):
        w, wq = getattr(sp, name), getattr(qp.sp, name)
        if wq.dtype != torch.int8 or wq.shape != w.shape or wq.device != w.device \
                or not wq.is_contiguous():
            raise ValueError(f"quantized {name} must be a contiguous int8 tensor of shape "
                             f"{tuple(w.shape)} on {w.device}, got {wq.dtype} "
                             f"{tuple(wq.shape)} on {wq.device}")
    s = qp.scales
    if s.shape != (sp.wx.shape[0], 8) or s.dtype != torch.float32 or s.device != sp.wx.device \
            or not s.is_contiguous():
        raise ValueError(f"quantized scales must be a contiguous float32 [K, 8] tensor on "
                         f"{sp.wx.device}, got {s.dtype} {tuple(s.shape)} on {s.device}")


def _launch(sp: StackedFlowParams, hz: Tensor, ut: Optional[Tensor], out: Tensor,
            u_out: Optional[Tensor], dtype: torch.dtype, activation: str,
            seed: int = 0, noise_scale: float = 1.0,
            quantized: Optional[QuantizedFlowParams] = None) -> None:
    _check_kernel_args(sp, hz, dtype, activation, quantized is not None)
    b, c, n = out.shape
    k, h, _ = sp.wx.shape
    nh1 = sp.wh.shape[1]
    if quantized is not None:
        _check_quantized(sp, quantized)
        wx, wh, wout = quantized.sp.wx, quantized.sp.wh, quantized.sp.wout
    else:
        # weight operands in the compute dtype (the cast is the kernel's rounding)
        wx, wh, wout = (w.to(dtype).contiguous() for w in (sp.wx, sp.wh, sp.wout))
    layout = inverse_layout(h, nh1, dtype, activation, quantized is not None)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(hz.device).cuda_stream
    seed = int(seed) & (2**64 - 1)
    with torch.cuda.device(hz.device):
        if layout == "cluster":
            carry = torch.empty((h // 64, b, 3, n), device=hz.device, dtype=torch.float32)
            err = _cluster_lib().dpfx_fused_sampler_cluster_launch(
                ptr(hz), ptr(ut), ptr(out), ptr(u_out), carry.data_ptr(),
                ptr(wx), ptr(wh), ptr(sp.bh), ptr(wout), ptr(sp.bout), ptr(sp.masks),
                b, c, n, k, h, nh1, sp.scale_cap, seed, float(noise_scale),
                ACT_CODES[activation], ptr(quantized.scales) if quantized is not None else None,
                _cluster_grid(h, nh1, hz.device.index or 0), stream)
        else:
            err = _lib().dpfx_fused_sampler_launch(
                ptr(hz), ptr(ut), ptr(out), ptr(u_out),
                ptr(wx), ptr(wh) if nh1 else None, ptr(sp.bh) if nh1 else None,
                ptr(wout), ptr(sp.bout), ptr(sp.masks),
                b, c, n, k, h, nh1, sp.scale_cap, ACT_CODES[activation],
                int(dtype == torch.bfloat16), seed, float(noise_scale),
                ptr(quantized.scales) if quantized is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"fused sampler kernel launch failed ({layout} layout): "
                           f"cudaError {err}{_error_text(err)}")
    layout_launches[layout] += 1


# ---------------------------------------------------------------- public wrappers

def fused_inverse_transposed(sp: StackedFlowParams, ut: Tensor, z: Tensor,
                             dtype: torch.dtype = torch.bfloat16,
                             activation: str = "relu") -> Tensor:
    """ut [B, C, N] (C = 3 or 8, coordinates in rows 0-2), z [B, dz] ->
    x [B, C, N]: all K inverted couplings."""
    if ut.dim() != 3 or ut.shape[1] not in (3, 8):
        raise ValueError(f"ut must be [B, 3 or 8, N], got {tuple(ut.shape)}")
    hz = z_projection(sp, z)
    if not ut.is_cuda:
        return fused_inverse_transposed_plain(sp, ut.float(), hz, dtype, activation)
    ut = ut.float().contiguous()
    out = ut.clone() if ut.shape[1] > 3 else torch.empty_like(ut)
    _launch(sp, hz, ut, out, None, dtype, activation)
    launches["fused_inverse"] += 1
    return out


def fused_point_flow_inverse(sp: StackedFlowParams, u: Tensor, z: Tensor,
                             dtype: torch.dtype = torch.bfloat16,
                             activation: str = "relu") -> Tensor:
    """u [B, N, 3], z [B, dz] -> x [B, N, 3]; CouplingFlow.inverse(u, z)[0]
    with the kernel's rounding."""
    out = fused_inverse_transposed(sp, u.transpose(1, 2).contiguous(), z, dtype, activation)
    return out.transpose(1, 2)


def fused_sample_points(sp: StackedFlowParams, z: Tensor, seed: int, n_points: int,
                        dtype: torch.dtype = torch.bfloat16, activation: str = "relu",
                        noise_scale: float = 1.0, return_noise: bool = False,
                        quantized: Optional[QuantizedFlowParams] = None):
    """z [B, dz], integer seed -> x [B, n_points, 3], with the base noise
    u = noise_scale * N(0, I3) drawn inside the kernel (Philox keyed by
    (seed, cloud, point): the stream does not depend on the tiling).
    ``return_noise`` also returns that u, [B, n_points, 3]. ``quantized``
    (``quantize_flow_params`` of the same sp) runs the int8 mode: Wx, Wh
    and Wout from its int8 stacks, the rest (hz, biases, masks) from sp."""
    hz = z_projection(sp, z)
    if not z.is_cuda:
        if quantized is not None:
            dq = dequantize(quantized)
            sp = sp._replace(wx=dq.wx, wh=dq.wh, wout=dq.wout)
        x, u = fused_sample_points_plain(sp, hz, seed, n_points, dtype, activation, noise_scale)
    else:
        x = torch.empty((z.shape[0], 3, n_points), device=z.device, dtype=torch.float32)
        u = torch.empty_like(x) if return_noise else None
        _launch(sp, hz, None, x, u, dtype, activation, seed, noise_scale, quantized)
        launches["fused_sample" if quantized is None else "fused_sample_int8"] += 1
    x = x.transpose(1, 2)
    return (x, u.transpose(1, 2)) if return_noise else x
