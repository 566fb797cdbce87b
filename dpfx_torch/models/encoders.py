"""PointNet posterior q(z|X), in PyTorch (counterpart of
``dpfx.models.encoders.PointNetEncoder``): a shared per-point MLP, a
max-pool over the points axis, FC heads -> (mu, logvar) with logvar
clipped to [-10, 10]. Parameter names follow the flax tree
(``point_{i}``, ``head_{i}``, ``gauss``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from dpfx_torch.models.coupling import ACTIVATIONS, dense


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

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, N, 3] -> (mu, logvar), each [B, dz] float32."""
        h = x.to(self.dtype)
        for i in range(self.n_point):
            h = self.act(dense(getattr(self, f"point_{i}"), h, self.dtype))
        g = h.amax(dim=-2)  # permutation-invariant pool over points
        for i in range(self.n_head):
            g = self.act(dense(getattr(self, f"head_{i}"), g, self.dtype))
        mu, logvar = dense(self.gauss, g, self.dtype).float().chunk(2, dim=-1)
        return mu, torch.clamp(logvar, -10.0, 10.0)
