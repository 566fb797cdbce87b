"""ELBO loss (counterpart of ``dpfx/train/loss.py``).

loss = -( recon_ll + kl_weight * (logp_z - logq) ) / normalizer

``recon_reduction`` decides whether the per-cloud reconstruction term is
summed ("sum_points", per-cloud nats) or averaged ("mean_points", the KL
scaled by 1/N too) over the points before the batch mean.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import torch

from dpfx_torch.ops.fused_encoder import fused_encoder_supported, fused_pointnet_posterior
from dpfx_torch.ops.fused_latent import fused_latent_log_prob, fused_latent_supported
from dpfx_torch.ops.fused_train import fused_point_flow_recon_ll, fused_train_supported

Tensor = torch.Tensor

_warned: set = set()


def _warn_once(key, message: str) -> None:
    if key not in _warned:
        _warned.add(key)
        warnings.warn(message, stacklevel=3)


def elbo_loss(model, x: Tensor, eps: Tensor, kl_weight: float = 1.0,
              recon_reduction: str = "sum_points", fused_point_flow: bool = False,
              fused_encoder: bool = False, fused_latent_flow: bool = False,
              image: Optional[Tensor] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Returns (scalar loss, metrics dict). x: [B, N, 3], eps: [B, dz];
    ``image`` [B, H, W, 3] (SVR) takes q(z|view) from the image encoder,
    and then ``fused_encoder`` does not apply, as in the JAX package.

    ``fused_point_flow`` routes the reconstruction term through the fused
    point-flow kernels (``dpfx_torch.ops.fused_train``), ``fused_encoder``
    q(z|X) through the fused PointNet kernels
    (``dpfx_torch.ops.fused_encoder``), ``fused_latent_flow`` log p(z)
    through the fused latent-flow kernels (``dpfx_torch.ops.fused_latent``).
    Each falls back to the module path, with a one-time warning, when its
    configuration is outside the kernels' support."""
    n = x.shape[-2]
    mcfg = model.config.model
    posterior = None
    if fused_encoder and image is None:
        if fused_encoder_supported(mcfg.encoder):
            posterior = fused_pointnet_posterior(model.encoder, x)
        else:
            _warn_once(("enc", mcfg.encoder.activation, tuple(mcfg.encoder.point_widths)),
                       "dpfx_torch.train: fused_encoder requested but the encoder config "
                       f"(activation={mcfg.encoder.activation!r}, point_widths="
                       f"{tuple(mcfg.encoder.point_widths)}) is outside the fused "
                       "kernels' support; using the module path")
    flow_cfg = mcfg.point_flow
    use_fused_pf = fused_point_flow and fused_train_supported(flow_cfg)
    if fused_point_flow and not use_fused_pf:
        _warn_once((flow_cfg.activation, flow_cfg.use_actnorm, flow_cfg.hidden,
                    flow_cfg.n_hidden),
                   "dpfx_torch.train: fused_point_flow requested but the flow config "
                   f"(activation={flow_cfg.activation!r}, actnorm={flow_cfg.use_actnorm}, "
                   f"hidden={flow_cfg.hidden}, n_hidden={flow_cfg.n_hidden}) "
                   "is outside the fused kernels' support; using the module path")
    lf_cfg = mcfg.latent_flow
    use_fused_lat = fused_latent_flow and fused_latent_supported(lf_cfg, mcfg.dz)
    if fused_latent_flow and not use_fused_lat:
        _warn_once(("lat", lf_cfg.activation, lf_cfg.use_actnorm, mcfg.dz),
                   "dpfx_torch.train: fused_latent_flow requested but the latent-flow config "
                   "is outside the fused kernels' support (needs relu, no actnorm, dz > 16, "
                   "dz % 8 == 0 and widths that one cluster holds); using the module path")
    t = model.elbo_latent_terms(x, eps, posterior, with_logp_z=not use_fused_lat, image=image)
    t["recon_ll"] = (fused_point_flow_recon_ll(model, x, t["z"], flow_cfg) if use_fused_pf
                     else model.point_flow.log_prob(x, t["z"]).sum(-1))
    if use_fused_lat:
        t["logp_z"] = fused_latent_log_prob(model, t["z"], lf_cfg)
    recon = t["recon_ll"]
    kl = t["logq"] - t["logp_z"]          # MC estimate of KL(q || p) per cloud
    if recon_reduction == "mean_points":
        recon, kl_scaled = recon / n, kl / n
    elif recon_reduction == "sum_points":
        kl_scaled = kl
    else:
        raise ValueError(f"unknown recon_reduction {recon_reduction!r}")
    loss = (-(recon - kl_weight * kl_scaled)).mean()
    metrics = {
        "loss": loss,
        "neg_elbo_per_point": (-(t["recon_ll"] - kl)).mean() / n,
        "recon_ll_per_point": t["recon_ll"].mean() / n,
        "kl": kl.mean(),
        "logp_z": t["logp_z"].mean(),
    }
    return loss, metrics
