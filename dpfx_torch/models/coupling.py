"""Discrete affine-coupling flows, in PyTorch (counterpart of
``dpfx/models/coupling.py``).

A ``CouplingFlow`` is a stack of K mask-based conditional affine couplings
over the last axis of ``x``:

    y = mask * x + (1-mask) * (x * exp(s(m*x, z)) + t(m*x, z))
    x = mask * y + (1-mask) * (y - t) * exp(-s)            (closed-form inverse)

with the conditioner ``(s, t)`` a small MLP whose ``out`` layer is
zero-initialised (every layer starts as the identity) and ``s`` soft-capped
by ``cap * tanh(s / cap)``.

Numerics follow the flax modules: each Dense casts its input and weight to
the compute dtype, multiplies, then adds the bias in the compute dtype; the
conditioner output and all coupling arithmetic (exp, mul, add, log-det) are
float32. The JAX package computes the point flow (dim <= 16) channel-first,
a TPU lane-layout choice; the port computes every flow feature-last, which
is the same arithmetic.

Module and parameter names equal the flax tree (``coupling_{k}.cond_net.
in_x|in_z|hidden_{i}|out``, ``actnorm_{k}``), so the weight bridge in
``dpfx_torch.compat.params`` is a plain key map.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor

# flax's nn.gelu is the tanh approximation; jax.nn.leaky_relu's slope is 0.01
ACTIVATIONS: Dict[str, Callable[[Tensor], Tensor]] = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
}


def make_masks(dim: int, n_layers: int) -> np.ndarray:
    """Static binary masks, one per layer; 1 = pass-through coords.

    ``dim == 3`` (point flow) cycles through all six 1|2 partitions of the
    coordinates; larger dims (latent flow) cycle even / odd / first half /
    second half."""
    if dim < 2:
        raise ValueError("coupling needs dim >= 2")
    masks = np.zeros((n_layers, dim), dtype=np.float32)
    if dim == 3:
        cycle = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (0, 1, 1), (1, 0, 1)]
        for k in range(n_layers):
            masks[k] = cycle[k % len(cycle)]
    else:
        even = np.arange(dim) % 2 == 0
        half = np.arange(dim) < dim // 2
        cycle2 = [even, ~even, half, ~half]
        for k in range(n_layers):
            masks[k] = cycle2[k % len(cycle2)].astype(np.float32)
    return masks


def dense(layer: nn.Linear, x: Tensor, dtype: torch.dtype) -> Tensor:
    """flax ``nn.Dense(dtype=dtype)``: operands cast to ``dtype``, the
    product rounded to ``dtype``, then the bias added in ``dtype``."""
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    if layer.bias is not None:
        y = y + layer.bias.to(dtype)
    return y


class Conditioner(nn.Module):
    """MLP producing (s, t) for one coupling layer; the conditioning vector
    (the latent z) is projected by ``in_z`` and added after ``in_x``."""

    def __init__(self, dim: int, hidden: int, n_hidden: int, cond_dim: Optional[int],
                 dtype: torch.dtype = torch.float32, activation: str = "relu"):
        super().__init__()
        self.dtype = dtype
        self.act = ACTIVATIONS[activation]
        self.n_hidden = n_hidden
        self.in_x = nn.Linear(dim, hidden)
        self.in_z = nn.Linear(cond_dim, hidden, bias=False) if cond_dim else None
        for i in range(n_hidden - 1):
            setattr(self, f"hidden_{i}", nn.Linear(hidden, hidden))
        self.out = nn.Linear(hidden, 2 * dim)
        nn.init.zeros_(self.out.weight)
        nn.init.zeros_(self.out.bias)

    def forward(self, x_masked: Tensor, cond: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        h = dense(self.in_x, x_masked, self.dtype)
        if cond is not None:
            hz = dense(self.in_z, cond, self.dtype)
            if hz.dim() == h.dim() - 1:
                hz = hz.unsqueeze(-2)       # broadcast z over the points axis
            h = h + hz
        h = self.act(h)
        for i in range(self.n_hidden - 1):
            h = self.act(dense(getattr(self, f"hidden_{i}"), h, self.dtype))
        out = dense(self.out, h, self.dtype).float()  # coupling math stays f32
        s, t = out.chunk(2, dim=-1)
        return s, t


class ActNorm(nn.Module):
    """Per-coordinate affine normalisation with exact log-det."""

    def __init__(self, dim: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.zeros(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: Tensor, inverse: bool = False) -> Tuple[Tensor, Tensor]:
        ld = self.log_scale.sum() * torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
        if inverse:
            return (x - self.bias) * torch.exp(-self.log_scale), -ld
        return x * torch.exp(self.log_scale) + self.bias, ld


class AffineCoupling(nn.Module):
    """One mask-based conditional affine coupling layer."""

    def __init__(self, dim: int, mask, hidden: int, n_hidden: int,
                 cond_dim: Optional[int], scale_cap: float = 8.0,
                 dtype: torch.dtype = torch.float32, activation: str = "relu"):
        super().__init__()
        self.scale_cap = scale_cap
        # a static buffer, not a parameter: kept out of the state dict
        self.register_buffer("mask", torch.tensor(mask, dtype=torch.float32),
                             persistent=False)
        self.cond_net = Conditioner(dim, hidden, n_hidden, cond_dim, dtype, activation)

    def _st(self, x: Tensor, cond: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        s, t = self.cond_net(x * self.mask, cond)
        s = self.scale_cap * torch.tanh(s / self.scale_cap)
        inv = 1.0 - self.mask
        return s * inv, t * inv

    def forward(self, x: Tensor, cond: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        """x -> y; returns (y, logdet)."""
        s, t = self._st(x, cond)
        return torch.where(self.mask > 0, x, x * torch.exp(s) + t), s.sum(-1)

    def inverse(self, y: Tensor, cond: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        """y -> x (closed form); returns (x, logdet of the inverse map)."""
        s, t = self._st(y, cond)   # masked coords are identical in x and y
        return torch.where(self.mask > 0, y, (y - t) * torch.exp(-s)), -s.sum(-1)


class CouplingFlow(nn.Module):
    """Stack of K affine couplings (+ optional actnorm before each one in the
    forward direction). ``forward`` maps data -> base noise with the log-det;
    ``inverse`` maps base noise -> data (sampling)."""

    def __init__(self, dim: int, n_layers: int, hidden: int, n_hidden: int,
                 cond_dim: Optional[int] = None, use_actnorm: bool = False,
                 scale_cap: float = 8.0, dtype: torch.dtype = torch.float32,
                 activation: str = "relu"):
        super().__init__()
        self.dim, self.n_layers, self.hidden, self.n_hidden = dim, n_layers, hidden, n_hidden
        self.use_actnorm = use_actnorm
        self.scale_cap = scale_cap
        self.dtype = dtype
        self.activation = activation
        masks = make_masks(dim, n_layers)
        for k in range(n_layers):
            setattr(self, f"coupling_{k}", AffineCoupling(
                dim, masks[k].tolist(), hidden, n_hidden, cond_dim, scale_cap,
                dtype, activation))
            if use_actnorm:
                setattr(self, f"actnorm_{k}", ActNorm(dim))

    def coupling(self, k: int) -> AffineCoupling:
        return getattr(self, f"coupling_{k}")

    def forward(self, x: Tensor, cond: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        logdet = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
        for k in range(self.n_layers):
            if self.use_actnorm:
                x, ld = getattr(self, f"actnorm_{k}")(x)
                logdet = logdet + ld
            x, ld = self.coupling(k)(x, cond)
            logdet = logdet + ld
        return x, logdet

    def inverse(self, u: Tensor, cond: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        logdet = torch.zeros(u.shape[:-1], dtype=torch.float32, device=u.device)
        for k in reversed(range(self.n_layers)):
            u, ld = self.coupling(k).inverse(u, cond)
            logdet = logdet + ld
            if self.use_actnorm:
                u, ld = getattr(self, f"actnorm_{k}")(u, inverse=True)
                logdet = logdet + ld
        return u, logdet

    def log_prob(self, x: Tensor, cond: Optional[Tensor] = None) -> Tensor:
        """log p(x) = log N(f(x); 0, I) + log|det J_f|."""
        u, logdet = self.forward(x, cond)
        return -0.5 * (u * u + math.log(2.0 * math.pi)).sum(-1) + logdet
