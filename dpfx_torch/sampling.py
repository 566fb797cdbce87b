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

With a ``group`` of D ranks (``dpfx_torch.parallel``), ``make_sampler``
shards the clouds over the ranks, as ``dpfx``'s sharded sampler shards them
over the mesh: rank r samples n_clouds / D of them from generators keyed by
(seed, r) (``rank_seed``), and ``gather_rows`` puts every rank's clouds on
every rank.
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
    pad_latent_params,
    stack_latent_params,
)
from dpfx_torch.ops.fused_sampler import fused_sample_points, stack_point_flow_params
from dpfx_torch.parallel import Group, gather_rows, rank_seed, world_rank


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
            stacked = cast_latent_weights(pad_latent_params(stack_latent_params(
                model.latent_flow)), dtype_of(lf_cfg.compute_dtype))
        return lambda eps: fused_latent_inverse(stacked, eps, lf_cfg)
    return lambda eps: model.latent_flow.inverse(eps)[0]


def make_sampler(model: DPF, n_clouds: int, n_points: int, fused: bool = True,
                 temperature: float = 1.0, latent_temperature: float = 1.0,
                 group: Group = None) -> Callable[[int], torch.Tensor]:
    """Returns seed -> [n_clouds, n_points, 3] on the model's device. Under
    a ``group`` of D ranks (n_clouds a multiple of D, else it raises) rank r
    samples rows [r n/D, (r+1) n/D) as ``make_sampler(model, n_clouds / D,
    ...)`` does for the seed ``rank_seed(seed, r)``, and every rank returns
    all n_clouds."""
    if group is not None:
        world, rank = world_rank(group)
        if n_clouds % world:
            raise ValueError(f"n_clouds={n_clouds} must be a multiple of the {world} ranks")
        local = make_sampler(model, n_clouds // world, n_points, fused, temperature,
                             latent_temperature)
        ids = torch.arange(n_clouds, device=model.device)
        return lambda seed: gather_rows(local(rank_seed(seed, rank)), ids, group)
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


def make_plain_sampler(model: DPF, n_clouds: int, n_points: int, temperature: float = 1.0,
                       latent_temperature: float = 1.0) -> Callable[[int], torch.Tensor]:
    """seed -> [n_clouds, n_points, 3] through the modules alone: the latent
    flow's and the point flow's ``inverse`` in plain PyTorch, the noise from
    the seed's generator; no kernel runs. ``make_sampler(fused=False)``
    still runs the point-flow inverse kernel (``DPF.sample``); this is the
    plain twin that the measurement tools time the sampling kernels
    against (``dpfx``'s sampler with ``fused=False`` runs its flax modules)."""
    dz = model.config.model.dz

    @torch.no_grad()
    def sample(seed: int) -> torch.Tensor:
        g, _ = _generators(seed, model.device)
        eps = torch.randn((n_clouds, dz), generator=g, device=model.device)
        z = model.latent_flow.inverse(eps * latent_temperature)[0]
        u = torch.randn((n_clouds, n_points, 3), generator=g, device=model.device)
        return model.point_flow.inverse(u * temperature, z)[0]

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
