"""dpfx_torch: Discrete Point Flow Networks in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``dpfx``, slice by slice: the same YAML configs,
the same parameter names, and a CUDA kernel wherever ``dpfx`` has a Pallas
TPU kernel. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``. It imports nothing of ``dpfx``.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "Config": "dpfx_torch.config",
    "load_config": "dpfx_torch.config",
    "config_from_dict": "dpfx_torch.config",
    "DPF": "dpfx_torch.models",
    "CouplingFlow": "dpfx_torch.models",
    "PointNetEncoder": "dpfx_torch.models",
    "make_sampler": "dpfx_torch.sampling",
    "make_decoder": "dpfx_torch.sampling",
    "restore_for_eval": "dpfx_torch.checkpoint",
}


def __getattr__(name):
    """Lazy exports: ``import dpfx_torch`` stays cheap."""
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'dpfx_torch' has no attribute {name!r}")
