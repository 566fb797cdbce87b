"""Device resolution for the port's entry points.

Entry points run on the card: with no device given they pick ``cuda`` and
raise when CUDA is absent. The CPU is used only when the caller asks for
it (``device="cpu"``), as the tests do. Nothing falls back quietly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dpfx_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' (or --device cpu) to run the plain CPU path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

