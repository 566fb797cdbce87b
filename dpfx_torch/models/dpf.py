"""The full DPF model in PyTorch (counterpart of ``dpfx/models/dpf.py``).

p(X) = ∫ p(z) prod_i p(x_i | z) dz with a conditional point flow p(x|z), a
latent flow prior p(z) and a PointNet posterior q(z|X), or, for single-view
reconstruction (``experiment: svr``), an image posterior q(z|view) from a
conv or mixer image encoder (``model.image_encoder.arch``). Sampling is
z = g^-1(eps), x_i = f^-1(u_i; z): the latent inverse in plain torch, the
point-flow inverse through the fused CUDA kernel (its plain version on the
CPU). With ``use_actnorm`` the point flow runs ``CouplingFlow.inverse``, as
the JAX sampler does.

Noise: every sampling method takes an optional ``generator`` and optional
explicit unit-variance draws (``eps`` [B, dz], ``u`` [B, N, 3]); the
temperatures scale them (eps * latent_temperature, u * temperature). The
explicit draws are how tests hold the port against the JAX package, whose
random streams differ.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from dpfx_torch.config import Config
from dpfx_torch.models.coupling import CouplingFlow
from dpfx_torch.models.encoders import ConvImageEncoder, MixerImageEncoder, PointNetEncoder
from dpfx_torch.ops.fused_sampler import fused_point_flow_inverse, stack_point_flow_params

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    """Config ``compute_dtype`` string -> torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported compute_dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def gaussian_logprob(x: Tensor, mu: Tensor, logvar: Tensor) -> Tensor:
    """Diagonal-Gaussian log density, summed over the last axis."""
    return -0.5 * (logvar + math.log(2.0 * math.pi) + (x - mu) ** 2 * torch.exp(-logvar)).sum(-1)


class DPF(nn.Module):
    """The point flow and the latent flow, with the PointNet encoder, or
    with ``experiment: svr`` the image encoder in its place (an SVR model
    has no PointNet parameters, as the JAX package's params tree has
    none)."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        m = config.model
        pf, lf = m.point_flow, m.latent_flow
        self.point_flow = CouplingFlow(
            3, pf.n_layers, pf.hidden, pf.n_hidden, cond_dim=m.dz,
            use_actnorm=pf.use_actnorm, scale_cap=pf.scale_cap,
            dtype=dtype_of(pf.compute_dtype), activation=pf.activation)
        self.latent_flow = CouplingFlow(
            m.dz, lf.n_layers, lf.hidden, lf.n_hidden, cond_dim=None,
            use_actnorm=lf.use_actnorm, scale_cap=lf.scale_cap,
            dtype=dtype_of(lf.compute_dtype), activation=lf.activation)
        if config.experiment == "svr":
            ie = m.image_encoder
            if ie.arch == "conv":
                self.image_encoder = ConvImageEncoder(m.dz, tuple(ie.widths),
                                                      ie.blocks_per_stage)
            else:
                self.image_encoder = MixerImageEncoder(m.dz, ie.patch, ie.width, ie.depth,
                                                       ie.image_size)
        else:
            self.encoder = PointNetEncoder(
                m.dz, tuple(m.encoder.point_widths), tuple(m.encoder.head_widths),
                dtype=dtype_of(m.encoder.compute_dtype), activation=m.encoder.activation)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # ---- posterior / ELBO -------------------------------------------------

    def posterior(self, x: Tensor, image: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        """(mu, logvar) [B, dz]: q(z|view) from ``image`` [B, H, W, 3] when
        given, else q(z|X) from x [B, N, 3]."""
        if image is not None:
            return self.image_encoder(image)
        return self.encoder(x)

    encode = posterior

    def elbo_terms(self, x: Tensor, eps: Tensor,
                   posterior: Optional[Tuple[Tensor, Tensor]] = None,
                   image: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """Per-cloud ELBO pieces for x [B, N, 3] with reparameterisation
        noise ``eps`` [B, dz]: recon_ll, logp_z, logq, z. ``posterior``
        optionally supplies a precomputed (mu, logvar), as the fused-encoder
        path does; ``image`` [B, H, W, 3] selects the image posterior."""
        t = self.elbo_latent_terms(x, eps, posterior, image=image)
        t["recon_ll"] = self.point_flow.log_prob(x, t["z"]).sum(-1)
        return t

    def elbo_latent_terms(self, x: Tensor, eps: Tensor,
                          posterior: Optional[Tuple[Tensor, Tensor]] = None,
                          with_logp_z: bool = True,
                          image: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """The posterior and latent-prior pieces without the point-flow
        term (logq, z and, with ``with_logp_z``, logp_z): the fused-train
        path computes recon_ll through its kernels."""
        mu, logvar = posterior if posterior is not None else self.posterior(x, image)
        z = mu + torch.exp(0.5 * logvar) * eps
        out = dict(logq=gaussian_logprob(z, mu, logvar), z=z)
        if with_logp_z:
            out["logp_z"] = self.latent_flow.log_prob(z)
        return out

    def log_prob(self, x: Tensor, eps: Tensor, image: Optional[Tensor] = None) -> Tensor:
        """One-sample ELBO per cloud, a lower bound on log p(X)."""
        t = self.elbo_terms(x, eps, image=image)
        return t["recon_ll"] + t["logp_z"] - t["logq"]

    # ---- sampling -----------------------------------------------------------

    def _randn(self, shape, generator: Optional[torch.Generator]) -> Tensor:
        return torch.randn(shape, generator=generator, device=self.device)

    def point_inverse(self, u: Tensor, z: Tensor) -> Tensor:
        """u [B, N, 3] -> x [B, N, 3] through the point flow's inverse."""
        pf = self.point_flow
        if pf.use_actnorm:
            return pf.inverse(u, z)[0]
        with torch.no_grad():
            sp = stack_point_flow_params(pf)
        return fused_point_flow_inverse(sp, u, z, dtype=pf.dtype, activation=pf.activation)

    @torch.no_grad()
    def sample(self, n_clouds: int, n_points: int, generator: Optional[torch.Generator] = None,
               eps: Optional[Tensor] = None, u: Optional[Tensor] = None,
               temperature: float = 1.0, latent_temperature: float = 1.0) -> Tensor:
        """Prior sample [n_clouds, n_points, 3]."""
        if eps is None:
            eps = self._randn((n_clouds, self.config.model.dz), generator)
        z, _ = self.latent_flow.inverse(eps * latent_temperature)
        if u is None:
            u = self._randn((n_clouds, n_points, 3), generator)
        return self.point_inverse(u * temperature, z)

    @torch.no_grad()
    def decode(self, z: Tensor, n_points: int, generator: Optional[torch.Generator] = None,
               u: Optional[Tensor] = None) -> Tensor:
        """A cloud of n_points from p(x|z): z [B, dz] -> [B, n_points, 3]."""
        if u is None:
            u = self._randn((z.shape[0], n_points, 3), generator)
        return self.point_inverse(u, z)

    @torch.no_grad()
    def reconstruct(self, x: Tensor, n_points: Optional[int] = None,
                    generator: Optional[torch.Generator] = None, u: Optional[Tensor] = None,
                    use_mean: bool = True, image: Optional[Tensor] = None) -> Tensor:
        """AE and SVR path: encode (the image when given), then decode
        (z = mu, or a posterior draw)."""
        mu, logvar = self.posterior(x, image)
        z = mu if use_mean else mu + torch.exp(0.5 * logvar) * self._randn(mu.shape, generator)
        return self.decode(z, n_points or x.shape[-2], generator, u)
