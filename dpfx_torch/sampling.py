"""Samplers (counterpart of ``dpfx/sampling.py``).

``make_sampler`` draws clouds from the prior: eps ~ tau_z N(0, I_dz), the
latent-flow inverse (the module, or with ``DPFX_SAMPLE_FUSED_LATENT=1`` and
a supported config the fused latent kernel, as in ``dpfx``), then the fused
CUDA kernel, which draws the point noise u ~ tau N(0, I3) itself and
applies all K inverted couplings. ``make_decoder`` decodes a given z the
same way (the AE reconstruction path). The stacked point-flow weights are
built once per sampler. With ``use_actnorm`` (which the kernel does not fuse) or
``fused=False`` both go through ``DPF.sample`` / ``DPF.decode``.

Each returned function takes an integer seed; the same seed gives the same
clouds on the same device.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from dpfx_torch.models.dpf import DPF, dtype_of
from dpfx_torch.ops.fused_latent import (
    cast_latent_weights,
    fused_latent_inverse,
    fused_latent_supported,
    stack_latent_params,
)
from dpfx_torch.ops.fused_sampler import fused_sample_points, stack_point_flow_params


def _generators(seed: int, device: torch.device):
    """A device generator for eps and a host generator for the kernel seed."""
    g_dev = torch.Generator(device=device).manual_seed(seed)
    g_host = torch.Generator().manual_seed(seed)
    kseed = int(torch.randint(0, 2**62, (1,), generator=g_host))
    return g_dev, kseed


def _make_latent_inverse(model: DPF) -> Callable[[torch.Tensor], torch.Tensor]:
    """eps -> z through the latent prior flow. The module is the default, as
    in ``dpfx``; ``DPFX_SAMPLE_FUSED_LATENT=1`` (with a supported config)
    selects the fused latent kernel, its weights stacked and cast to the
    compute dtype once here."""
    lf_cfg = model.config.model.latent_flow
    if (os.environ.get("DPFX_SAMPLE_FUSED_LATENT") == "1"
            and fused_latent_supported(lf_cfg, model.config.model.dz)):
        with torch.no_grad():
            stacked = cast_latent_weights(stack_latent_params(model.latent_flow),
                                          dtype_of(lf_cfg.compute_dtype))
        return lambda eps: fused_latent_inverse(stacked, eps, lf_cfg)
    return lambda eps: model.latent_flow.inverse(eps)[0]


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

    with torch.no_grad():
        sp = stack_point_flow_params(pf)
    latent_inverse = _make_latent_inverse(model)

    @torch.no_grad()
    def sample(seed: int) -> torch.Tensor:
        g, kseed = _generators(seed, model.device)
        eps = torch.randn((n_clouds, dz), generator=g, device=model.device)
        z = latent_inverse(eps * latent_temperature)
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

    with torch.no_grad():
        sp = stack_point_flow_params(pf)

    @torch.no_grad()
    def decode(z: torch.Tensor, seed: int) -> torch.Tensor:
        _, kseed = _generators(seed, model.device)
        return fused_sample_points(sp, z, kseed, n_points, dtype=pf.dtype,
                                   activation=pf.activation)

    return decode
