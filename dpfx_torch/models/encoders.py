"""Posterior encoders, in PyTorch (counterparts of ``dpfx/models/encoders.py``).

``PointNetEncoder``: q(z|X), a shared per-point MLP, a max-pool over the
points axis, FC heads -> (mu, logvar) with logvar clipped to [-10, 10].

``ConvImageEncoder`` and ``MixerImageEncoder``: q(z|view) for single-view
reconstruction (SVR), a small conv ResNet and an MLP-Mixer over
non-overlapping patches, with the same (mu, logvar) contract. Images
arrive [B, H, W, 3] (NHWC, the datasets' layout); the conv encoder
permutes once to NCHW. They compute in float32, as the JAX package's do,
with flax's conventions: the tanh GELU, norm epsilons of 1e-6, ``SAME``
3x3 convolutions.

Parameter names follow the flax tree (``point_{i}``, ``head_{i}``,
``gauss``; flax's automatic names ``Conv_0``, ``s{stage}_b{b}`` with
``GroupNorm_0/1`` and ``Conv_0/1/2``, ``Dense_0``; ``embed``, ``ln_t_{i}``,
``tok_in_{i}``, ``tok_out_{i}``, ``ln_c_{i}``, ``ch_in_{i}``,
``ch_out_{i}``, ``head``), so the weight bridge is a key map.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dpfx_torch.models.coupling import ACTIVATIONS, dense

Tensor = torch.Tensor

_EPS = 1e-6     # flax's LayerNorm and GroupNorm epsilon


def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")


def _split_head(out: Tensor) -> Tuple[Tensor, Tensor]:
    mu, logvar = out.float().chunk(2, dim=-1)
    return mu, torch.clamp(logvar, -10.0, 10.0)


class PointNetEncoder(nn.Module):
    def __init__(self, dz: int, point_widths: Sequence[int] = (128, 128, 256, 512),
                 head_widths: Sequence[int] = (256,), dtype: torch.dtype = torch.float32,
                 activation: str = "relu"):
        super().__init__()
        self.dtype = dtype
        self.act = ACTIVATIONS[activation]
        self.n_point, self.n_head = len(point_widths), len(head_widths)
        last = 3
        for i, w in enumerate(point_widths):
            setattr(self, f"point_{i}", nn.Linear(last, w))
            last = w
        for i, w in enumerate(head_widths):
            setattr(self, f"head_{i}", nn.Linear(last, w))
            last = w
        self.gauss = nn.Linear(last, 2 * dz)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """x: [B, N, 3] -> (mu, logvar), each [B, dz] float32."""
        h = x.to(self.dtype)
        for i in range(self.n_point):
            h = self.act(dense(getattr(self, f"point_{i}"), h, self.dtype))
        g = h.amax(dim=-2)  # permutation-invariant pool over points
        for i in range(self.n_head):
            g = self.act(dense(getattr(self, f"head_{i}"), g, self.dtype))
        return _split_head(dense(self.gauss, g, self.dtype))


class ResBlock(nn.Module):
    """GroupNorm(8) -> GELU -> 3x3 conv, twice, plus the input (through a
    1x1 conv, ``Conv_2``, where the width changes). NCHW."""

    def __init__(self, c_in: int, width: int):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(8, c_in, eps=_EPS)
        self.Conv_0 = nn.Conv2d(c_in, width, 3, padding=1)
        self.GroupNorm_1 = nn.GroupNorm(8, width, eps=_EPS)
        self.Conv_1 = nn.Conv2d(width, width, 3, padding=1)
        if c_in != width:
            self.Conv_2 = nn.Conv2d(c_in, width, 1)

    def forward(self, x: Tensor) -> Tensor:
        h = self.Conv_0(_gelu(self.GroupNorm_0(x)))
        h = self.Conv_1(_gelu(self.GroupNorm_1(h)))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return x + h


class ConvImageEncoder(nn.Module):
    """A 3x3 stem, ``blocks_per_stage`` ResBlocks per width each followed
    by a 2x2 average pool, a global average pool, Dense(2 * last width),
    GELU, then the Gaussian head."""

    def __init__(self, dz: int, widths: Sequence[int] = (32, 64, 128, 256),
                 blocks_per_stage: int = 2):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, widths[0], 3, padding=1)
        self.blocks = []
        last = widths[0]
        for stage, w in enumerate(widths):
            for b in range(blocks_per_stage):
                setattr(self, f"s{stage}_b{b}", ResBlock(last, w))
                last = w
            self.blocks.append([f"s{stage}_b{b}" for b in range(blocks_per_stage)])
        self.Dense_0 = nn.Linear(widths[-1], 2 * widths[-1])
        self.gauss = nn.Linear(2 * widths[-1], 2 * dz)

    def forward(self, img: Tensor) -> Tuple[Tensor, Tensor]:
        """img: [B, H, W, C] -> (mu, logvar), each [B, dz] float32."""
        h = self.Conv_0(img.float().permute(0, 3, 1, 2))
        for stage in self.blocks:
            for name in stage:
                h = getattr(self, name)(h)
            h = F.avg_pool2d(h, 2)
        h = h.mean(dim=(-2, -1))  # global average pool
        return _split_head(self.gauss(_gelu(self.Dense_0(h))))


class MixerImageEncoder(nn.Module):
    """Patch embedding, then ``depth`` MLP-Mixer blocks (token mixing over
    the t = (image_size / patch)^2 patches, channel mixing over ``width``),
    a mean over the tokens, Dense(width), GELU, the Gaussian head. The
    token layers' widths depend on t, so the module is built for one
    ``image_size``."""

    def __init__(self, dz: int, patch: int = 8, width: int = 256, depth: int = 4,
                 image_size: int = 128):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image size {image_size}x{image_size} not divisible by patch "
                             f"{patch}")
        self.patch, self.depth = patch, depth
        t = (image_size // patch) ** 2
        self.embed = nn.Linear(patch * patch * 3, width)
        for i in range(depth):
            setattr(self, f"ln_t_{i}", nn.LayerNorm(width, eps=_EPS))
            setattr(self, f"tok_in_{i}", nn.Linear(t, 2 * t))
            setattr(self, f"tok_out_{i}", nn.Linear(2 * t, t))
            setattr(self, f"ln_c_{i}", nn.LayerNorm(width, eps=_EPS))
            setattr(self, f"ch_in_{i}", nn.Linear(width, 2 * width))
            setattr(self, f"ch_out_{i}", nn.Linear(2 * width, width))
        self.head = nn.Linear(width, width)
        self.gauss = nn.Linear(width, 2 * dz)

    def forward(self, img: Tensor) -> Tuple[Tensor, Tensor]:
        """img: [B, H, W, C] -> (mu, logvar), each [B, dz] float32."""
        b, h, w, c = img.shape
        p = self.patch
        if h % p or w % p:
            raise ValueError(f"image size {h}x{w} not divisible by patch {p}")
        x = img.float().reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), p * p * c)
        x = self.embed(x)                                          # [B, T, W]
        for i in range(self.depth):
            y = getattr(self, f"ln_t_{i}")(x).transpose(1, 2)      # [B, W, T]
            y = getattr(self, f"tok_out_{i}")(_gelu(getattr(self, f"tok_in_{i}")(y)))
            x = x + y.transpose(1, 2)
            y = getattr(self, f"ln_c_{i}")(x)
            x = x + getattr(self, f"ch_out_{i}")(_gelu(getattr(self, f"ch_in_{i}")(y)))
        g = _gelu(self.head(x.mean(dim=1)))
        return _split_head(self.gauss(g))
