"""What the measurement tools share: the kernels' launch counters and the
card's name."""

from __future__ import annotations

import json
import subprocess
from typing import Dict, List

import torch


def _kernel_modules():
    from dpfx_torch.ops import chamfer, emd, fused_encoder, fused_latent, fused_sampler, fused_train

    return (fused_sampler, fused_train, fused_encoder, fused_latent, chamfer, emd)


def launch_counters() -> List[Dict[str, int]]:
    """The ``launches`` dict of every kernel module of the port."""
    return [m.launches for m in _kernel_modules()]


def reset_launch_counts() -> None:
    """Each kernel module's own ``reset_launch_counts``."""
    for m in _kernel_modules():
        m.reset_launch_counts()


def launches_line() -> str:
    """``launches {...}``: every kernel launched since the counts were
    reset, with its count (the tools print it last)."""
    return "launches " + json.dumps({k: v for c in launch_counters() for k, v in c.items() if v})


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (its
    name alone where nvidia-smi does not answer); ``cpu`` on the CPU."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)
