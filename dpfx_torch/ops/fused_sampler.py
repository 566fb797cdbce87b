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

Every wrapper takes its plain PyTorch version for a tensor on the CPU and
launches the kernel for a CUDA tensor (or raises). ``launches`` counts the
kernel launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dpfx_torch.models.coupling import ACTIVATIONS, CouplingFlow
from dpfx_torch.ops._build import SMEM_LIMIT

Tensor = torch.Tensor

# kernel launches per wrapper; chip_smoke.py zeroes these around the main path
launches: Dict[str, int] = {"fused_inverse": 0, "fused_sample": 0}

ACT_CODES = {"relu": 0, "gelu": 1, "tanh": 2, "leaky_relu": 3}
KERNEL_HIDDEN = (32, 64, 128, 256)     # conditioner widths the kernel is built for


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


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
    op is linear (transpose, mask fold, stack), so gradients reach the
    ``nn.Linear`` parameters: the training kernels take their weights from
    here. Samplers call it under ``torch.no_grad()``."""
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
    f = lambda xs: torch.stack(xs).float().contiguous()
    return StackedFlowParams(f(wx), f(wz), f(bx), f(wh), f(bh), f(wout), f(bout), f(masks),
                             float(flow.scale_cap))


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
    which the entry points set."""
    act = ACTIVATIONS[activation]
    rnd = lambda a: a.to(dtype).float()
    out = ut.clone()
    x = ut[:, :3].float()
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
        p,                            # stream
    ]
    lib.dpfx_fused_sampler_launch.restype = ctypes.c_int
    lib.dpfx_fused_sampler_smem_bytes.argtypes = [i, i]
    lib.dpfx_fused_sampler_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(hidden: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block; mirrors the kernel's layout."""
    s = 2 if dtype == torch.bfloat16 else 4
    ld = hidden + (8 if dtype == torch.bfloat16 else 1)
    r = lambda n: (n + 127) // 128 * 128
    t = 128
    return (r(t * ld * s) + r(hidden * ld * s) + r(8 * 256 * 4) + r(3 * t * 4) + r(6 * t * 4)
            + r(3 * hidden * 4) + 2 * r(hidden * 4) + r(6 * hidden * 4) + r(8 * 4))


def _check_kernel_args(sp: StackedFlowParams, hz: Tensor, dtype: torch.dtype,
                       activation: str) -> None:
    k, h, _ = sp.wx.shape
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel compute dtype must be float32 or bfloat16, got {dtype}")
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if h not in KERNEL_HIDDEN:
        raise ValueError(f"the fused sampler kernel is built for hidden in {KERNEL_HIDDEN}, got {h}")
    if smem_bytes(h, dtype) > SMEM_LIMIT:
        raise ValueError(f"hidden={h} in {dtype} needs {smem_bytes(h, dtype)} B of shared "
                         f"memory, more than the {SMEM_LIMIT} B a block may use")
    for name, t in list(sp._asdict().items())[:-1] + [("hz", hz)]:
        if not (t.is_cuda and t.device == hz.device):
            raise ValueError(f"{name} must be a CUDA tensor on {hz.device}, is on {t.device}")
        if not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    if hz.shape[1:] != (k, h):
        raise ValueError(f"hz shape {tuple(hz.shape)} does not match K={k}, H={h}")


def _launch(sp: StackedFlowParams, hz: Tensor, ut: Optional[Tensor], out: Tensor,
            u_out: Optional[Tensor], dtype: torch.dtype, activation: str,
            seed: int = 0, noise_scale: float = 1.0) -> None:
    _check_kernel_args(sp, hz, dtype, activation)
    b, c, n = out.shape
    k, h, _ = sp.wx.shape
    nh1 = sp.wh.shape[1]
    # weight operands in the compute dtype (the cast is the kernel's rounding)
    wx, wh, wout = (w.to(dtype).contiguous() for w in (sp.wx, sp.wh, sp.wout))
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(hz.device).cuda_stream
    with torch.cuda.device(hz.device):
        err = _lib().dpfx_fused_sampler_launch(
            ptr(hz), ptr(ut), ptr(out), ptr(u_out),
            ptr(wx), ptr(wh) if nh1 else None, ptr(sp.bh) if nh1 else None,
            ptr(wout), ptr(sp.bout), ptr(sp.masks),
            b, c, n, k, h, nh1, sp.scale_cap, ACT_CODES[activation],
            int(dtype == torch.bfloat16), int(seed) & (2**64 - 1), float(noise_scale), stream)
    if err != 0:
        raise RuntimeError(f"fused sampler kernel launch failed: cudaError {err}")


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
                        noise_scale: float = 1.0, return_noise: bool = False):
    """z [B, dz], integer seed -> x [B, n_points, 3], with the base noise
    u = noise_scale * N(0, I3) drawn inside the kernel (Philox keyed by
    (seed, cloud, point): the stream does not depend on the tiling).
    ``return_noise`` also returns that u, [B, n_points, 3]."""
    hz = z_projection(sp, z)
    if not z.is_cuda:
        x, u = fused_sample_points_plain(sp, hz, seed, n_points, dtype, activation, noise_scale)
    else:
        x = torch.empty((z.shape[0], 3, n_points), device=z.device, dtype=torch.float32)
        u = torch.empty_like(x) if return_noise else None
        _launch(sp, hz, None, x, u, dtype, activation, seed, noise_scale)
        launches["fused_sample"] += 1
    x = x.transpose(1, 2)
    return (x, u.transpose(1, 2)) if return_noise else x
