"""The flagship model that the measurement tools build (the counterpart of
``_flagship_config`` in the JAX package's ``__graft_entry__.py``, which its
``bench.py`` and ``tools/`` scripts take their model from).

The paper-scale model: a 32-layer point flow at H=128 and a 14-layer latent
flow at H=256, both with bf16 conditioners, dz=128, the PointNet encoder in
bf16, and the fused point-flow and encoder kernels on in training.
"""

from __future__ import annotations

from dpfx_torch.config.schema import Config, config_from_dict

FLAGSHIP = {
    "experiment": "ae",
    "name": "flagship",
    "model": {
        "dz": 128,
        "point_flow": {"n_layers": 32, "hidden": 128, "n_hidden": 2,
                       "compute_dtype": "bfloat16"},
        "latent_flow": {"n_layers": 14, "hidden": 256, "n_hidden": 2,
                        "compute_dtype": "bfloat16"},
        "encoder": {"compute_dtype": "bfloat16"},
    },
    "train": {"fused_point_flow": True, "fused_encoder": True},
}


def flagship_config() -> Config:
    """A fresh ``Config`` of the flagship model (callers may edit it)."""
    return config_from_dict(FLAGSHIP)


def flagship_model(device=None, cfg: Config = None, seed: int = 0, scale: float = 0.0):
    """``DPF(cfg)`` (default: the flagship) on ``device`` (default cuda; raises
    without it) with flax's seeded initialisation (``init_params_``: each
    coupling's output layer zero, as a training run starts and as the JAX
    tools' ``model.init`` gives it), plus ``randomize_`` at ``scale`` when
    it is above 0 (0.02 keeps a 32-layer flow with scale cap 3 stable; the
    flagship's cap of 8 is not)."""
    from dpfx_torch.compat import randomize_
    from dpfx_torch.device import resolve_device
    from dpfx_torch.models import DPF
    from dpfx_torch.train.trainer import init_params_

    dev = resolve_device(device)
    model = init_params_(DPF(cfg or flagship_config()), seed)
    if scale > 0:
        randomize_(model, seed=seed, scale=scale)
    return model.to(dev).eval()
