"""Task-level evaluation protocols (counterpart of ``dpfx/metrics/protocol.py``):

  * autoencoding: encode each test cloud, decode N points from the posterior
    mean through the fused sampler kernel, per-pair CD (and EMD) against the
    input, dataset means;
  * single-view reconstruction (SVR): the same, with the posterior mean
    taken from each cloud's paired image;
  * generation: sample as many clouds as the test set holds, then the full
    metric suite; under a ``group`` of ranks the sampling and the pairwise
    matrices are sharded over them (reconstruction stays on one device, as
    in ``dpfx``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dpfx_torch.config import Config
from dpfx_torch.metrics.generation import compute_all_metrics
from dpfx_torch.models.dpf import DPF
from dpfx_torch.ops import chamfer as cd_ops
from dpfx_torch.ops import emd as emd_ops
from dpfx_torch.parallel import Group, world_rank
from dpfx_torch.sampling import make_decoder, make_sampler


def _recon_metrics(impl: str, n_iters: int):
    if impl == "plain":
        return cd_ops.chamfer_plain, lambda a, b: emd_ops.emd_plain(a, b, n_iters)
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    return cd_ops.chamfer, lambda a, b: emd_ops.emd_nograd(a, b, n_iters)


@torch.no_grad()
def evaluate_reconstruction(model: DPF, clouds: np.ndarray, cfg: Config, seed: int = 0,
                            impl: str = "auto", labels: Optional[np.ndarray] = None,
                            label_names: Optional[Dict[int, str]] = None,
                            images: Optional[np.ndarray] = None) -> Dict[str, object]:
    """AE or SVR reconstruction eval. clouds: [S, N, 3] test split, on the
    host; ``images`` [S, H, W, 3], the clouds' paired renders (SVR), gives
    the posterior in place of the clouds. Batches of ``eval.batch_size``;
    batch i decodes with seed ``seed + i``. With ``labels``, per-category
    means too."""
    bsz = cfg.eval.batch_size
    use_emd = "emd" in cfg.eval.metrics
    chamfer, emd = _recon_metrics(impl, cfg.eval.emd_iters)
    decode = make_decoder(model, clouds.shape[1])
    cds, emds = [], []
    for i in range(0, clouds.shape[0], bsz):
        xb = torch.from_numpy(np.ascontiguousarray(clouds[i:i + bsz], np.float32)).to(model.device)
        imb = None if images is None else torch.from_numpy(
            np.ascontiguousarray(images[i:i + bsz], np.float32)).to(model.device)
        mu, _ = model.posterior(xb, imb)
        rec = decode(mu, seed + i)
        cds.append(chamfer(rec, xb).cpu().numpy())
        if use_emd:
            emds.append(emd(rec, xb).cpu().numpy())
    cds = np.concatenate(cds)
    out: Dict[str, object] = {"recon-cd": float(cds.mean())}
    if use_emd:
        emds = np.concatenate(emds)
        out["recon-emd"] = float(emds.mean())
    if labels is not None and len(np.unique(labels)) > 1:
        per = {}
        for c in np.unique(labels):
            sel = np.asarray(labels) == c
            name = (label_names or {}).get(int(c), f"cat{int(c)}")
            per[name] = {"recon-cd": float(cds[sel].mean())}
            if use_emd:
                per[name]["recon-emd"] = float(emds[sel].mean())
        out["per_category"] = per
    return out


@torch.no_grad()
def evaluate_generation(model: DPF, ref_clouds: np.ndarray, cfg: Config, seed: int = 0,
                        impl: str = "auto", sample_batch: int = 64,
                        labels: Optional[np.ndarray] = None,
                        label_names: Optional[Dict[int, str]] = None,
                        timings: Optional[Dict[str, float]] = None,
                        group: Group = None) -> Dict[str, object]:
    """Generation suite: |gen| = |ref| clouds of the ref's point count,
    drawn ``sample_batch`` at a time at the eval temperatures (the chunk at
    cloud offset i with seed ``seed + i``), then ``compute_all_metrics`` on
    the model's device. ``timings``, when given, receives the wall seconds
    of the sampling and of each step of the suite. Under a ``group`` of D
    ranks ``sample_batch`` is rounded up to a multiple of D, each chunk is
    sampled across the ranks and the matrices are row-sharded: every rank
    returns the same results."""
    import time

    s, n = ref_clouds.shape[0], ref_clouds.shape[1]
    world = world_rank(group)[0]
    sample_batch += -sample_batch % world
    t0 = time.perf_counter()
    sampler = make_sampler(model, sample_batch, n, temperature=cfg.eval.temperature,
                           latent_temperature=cfg.eval.latent_temperature, group=group)
    gen = torch.cat([sampler(seed + i) for i in range(0, s, sample_batch)])[:s]
    if timings is not None:
        if gen.is_cuda:
            torch.cuda.synchronize()
        timings["sample"] = time.perf_counter() - t0
    ref = torch.from_numpy(np.ascontiguousarray(ref_clouds, np.float32)).to(model.device)
    return compute_all_metrics(
        gen, ref, metrics=cfg.eval.metrics, impl=impl, jsd_resolution=cfg.eval.jsd_resolution,
        ref_labels=labels, label_names=label_names,
        precision=cfg.eval.pairwise_precision or None, jsd_frame=cfg.eval.jsd_frame,
        timings=timings, group=group)
