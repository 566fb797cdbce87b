"""Load trained weights into a port model (counterpart of the params-only
``restore_for_eval`` in ``dpfx/train/trainer.py``).

Two formats:
  * ``.pt``: a state dict written by the port (``torch.save(model.state_dict())``);
  * ``.npz``: a flax params tree flattened with ``/``-joined keys (an
    optional leading ``params/`` is accepted), converted by
    ``dpfx_torch.compat.params.params_from_flax``.
Anything else raises. Orbax checkpoints are not read yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from dpfx_torch.compat.params import params_from_flax, unflatten_tree
from dpfx_torch.config import Config
from dpfx_torch.device import DeviceLike, resolve_device
from dpfx_torch.models.dpf import DPF


def load_state_dict(path: str) -> dict:
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"no weights file at {path}")
    if p.suffix == ".pt":
        return torch.load(p, map_location="cpu", weights_only=True)
    if p.suffix == ".npz":
        with np.load(p) as z:
            return params_from_flax(unflatten_tree({k: z[k] for k in z.files}))
    raise ValueError(f"weights must be a .pt state dict or a flattened flax .npz, got {path}")


def restore_for_eval(cfg: Config, weights: str, device: DeviceLike = None) -> DPF:
    """Build the model from ``cfg`` on ``device`` (default cuda) and load
    ``weights`` strictly: a missing or unexpected key raises."""
    dev = resolve_device(device)
    model = DPF(cfg)
    model.load_state_dict(load_state_dict(weights), strict=True)
    return model.to(dev).eval()
