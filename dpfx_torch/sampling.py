"""Samplers (counterpart of ``dpfx/sampling.py``).

``make_sampler`` draws clouds from the prior: eps ~ tau_z N(0, I_dz), the
latent-flow inverse in plain torch, then the fused CUDA kernel, which draws
the point noise u ~ tau N(0, I3) itself and applies all K inverted
couplings. ``make_decoder`` decodes a given z the same way (the AE
reconstruction path). The stacked point-flow weights are built once per
sampler. With ``use_actnorm`` (which the kernel does not fuse) or
``fused=False`` both go through ``DPF.sample`` / ``DPF.decode``.

Each returned function takes an integer seed; the same seed gives the same
clouds on the same device.
"""

from __future__ import annotations

from typing import Callable

import torch

from dpfx_torch.models.dpf import DPF
from dpfx_torch.ops.fused_sampler import fused_sample_points, stack_point_flow_params


def _generators(seed: int, device: torch.device):
    """A device generator for eps and a host generator for the kernel seed."""
    g_dev = torch.Generator(device=device).manual_seed(seed)
    g_host = torch.Generator().manual_seed(seed)
    kseed = int(torch.randint(0, 2**62, (1,), generator=g_host))
    return g_dev, kseed


def make_sampler(model: DPF, n_clouds: int, n_points: int, fused: bool = True,
                 temperature: float = 1.0, latent_temperature: float = 1.0
                 ) -> Callable[[int], torch.Tensor]:
    """Returns seed -> [n_clouds, n_points, 3] on the model's device."""
    pf = model.point_flow
    dz = model.config.model.dz
    if not fused or pf.use_actnorm:
        def sample_plain(seed: int) -> torch.Tensor:
            g, _ = _generators(seed, model.device)
            return model.sample(n_clouds, n_points, generator=g, temperature=temperature,
                                latent_temperature=latent_temperature)
        return sample_plain

    sp = stack_point_flow_params(pf)

    @torch.no_grad()
    def sample(seed: int) -> torch.Tensor:
        g, kseed = _generators(seed, model.device)
        eps = torch.randn((n_clouds, dz), generator=g, device=model.device)
        z, _ = model.latent_flow.inverse(eps * latent_temperature)
        return fused_sample_points(sp, z, kseed, n_points, dtype=pf.dtype,
                                   activation=pf.activation, noise_scale=temperature)

    return sample


def make_decoder(model: DPF, n_points: int, fused: bool = True
                 ) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """Returns (z [B, dz], seed) -> [B, n_points, 3]."""
    pf = model.point_flow
    if not fused or pf.use_actnorm:
        def decode_plain(z: torch.Tensor, seed: int) -> torch.Tensor:
            g, _ = _generators(seed, model.device)
            return model.decode(z, n_points, generator=g)
        return decode_plain

    sp = stack_point_flow_params(pf)

    @torch.no_grad()
    def decode(z: torch.Tensor, seed: int) -> torch.Tensor:
        _, kseed = _generators(seed, model.device)
        return fused_sample_points(sp, z, kseed, n_points, dtype=pf.dtype,
                                   activation=pf.activation)

    return decode
