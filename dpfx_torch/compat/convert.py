"""Reference-layout ``.pt`` -> the port's state dict, a copy of
``dpfx/compat/convert.py``.

A checkpoint whose module tree names its tensors the reference's way
(``point_flow.couplings.<k>.cond_net.hiddens.<i>.weight``, ...) is mapped
by a declarative list of (regex, template, transform) rules into a flax
params tree ('/'-joined paths; the transform puts a Linear weight
[out, in] as a kernel [in, out] and a Conv2d weight OIHW as HWIO), exactly
as the JAX package does. ``params_from_flax`` then gives the port's state
dict, which is checked against ``DPF(cfg)``: missing keys, extra keys and
shapes. A reference SVR checkpoint also carries the PointNet encoder,
which the port's SVR model has none of: its shapes are checked against the
encoder the config describes, and its tensors left out of the result.
``configs/convert_rules_example.yaml`` shows the rules file format that
``load_rules_file`` reads, the hook for another module tree's names.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dpfx_torch.compat.params import params_from_flax

Rule = Tuple[str, Optional[str], Optional[str]]  # (pattern, replacement path, transform)

# transforms by name, so that rules can live in YAML files
TRANSFORMS: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "linear_w": lambda a: a.T,                          # [out, in] -> [in, out]
    "conv_w": lambda a: np.transpose(a, (2, 3, 1, 0)),  # OIHW -> HWIO
    "none": lambda a: a,
}

# the reference's torch names -> flax tree paths ('/'-joined)
DEFAULT_RULES: List[Rule] = [
    # flow conditioners
    (r"^(point_flow|latent_flow)\.couplings\.(\d+)\.cond_net\.(in_x|in_z|out)\.weight$",
     r"\1/coupling_\2/cond_net/\3/kernel", "linear_w"),
    (r"^(point_flow|latent_flow)\.couplings\.(\d+)\.cond_net\.(in_x|out)\.bias$",
     r"\1/coupling_\2/cond_net/\3/bias", "none"),
    (r"^(point_flow|latent_flow)\.couplings\.(\d+)\.cond_net\.hiddens\.(\d+)\.weight$",
     r"\1/coupling_\2/cond_net/hidden_\3/kernel", "linear_w"),
    (r"^(point_flow|latent_flow)\.couplings\.(\d+)\.cond_net\.hiddens\.(\d+)\.bias$",
     r"\1/coupling_\2/cond_net/hidden_\3/bias", "none"),
    # coupling masks are static buffers, not params
    (r"^(point_flow|latent_flow)\.couplings\.\d+\.mask$", None, None),
    # PointNet encoder
    (r"^encoder\.(point_\d+|head_\d+|gauss)\.weight$", r"encoder/\1/kernel", "linear_w"),
    (r"^encoder\.(point_\d+|head_\d+|gauss)\.bias$", r"encoder/\1/bias", "none"),
    # SVR conv image encoder (flax's auto-names: Conv_0 stem, s{stage}_b{block}
    # residual blocks, Dense_0, gauss)
    (r"^image_encoder\.Conv_0\.weight$", r"image_encoder/Conv_0/kernel", "conv_w"),
    (r"^image_encoder\.Conv_0\.bias$", r"image_encoder/Conv_0/bias", "none"),
    (r"^image_encoder\.(s\d+_b\d+)\.(Conv_\d+)\.weight$",
     r"image_encoder/\1/\2/kernel", "conv_w"),
    (r"^image_encoder\.(s\d+_b\d+)\.(Conv_\d+)\.bias$",
     r"image_encoder/\1/\2/bias", "none"),
    # a torch norm's 'weight' is flax's 'scale'
    (r"^image_encoder\.(s\d+_b\d+)\.(GroupNorm_\d+)\.weight$",
     r"image_encoder/\1/\2/scale", "none"),
    (r"^image_encoder\.(s\d+_b\d+)\.(GroupNorm_\d+)\.bias$",
     r"image_encoder/\1/\2/bias", "none"),
    (r"^image_encoder\.(Dense_0|gauss)\.weight$", r"image_encoder/\1/kernel", "linear_w"),
    (r"^image_encoder\.(Dense_0|gauss)\.bias$", r"image_encoder/\1/bias", "none"),
    # SVR mixer image encoder
    (r"^image_encoder\.(embed|tok_in_\d+|tok_out_\d+|ch_in_\d+|ch_out_\d+|head)\.weight$",
     r"image_encoder/\1/kernel", "linear_w"),
    (r"^image_encoder\.(embed|tok_in_\d+|tok_out_\d+|ch_in_\d+|ch_out_\d+|head)\.bias$",
     r"image_encoder/\1/bias", "none"),
    (r"^image_encoder\.(ln_t_\d+|ln_c_\d+)\.weight$", r"image_encoder/\1/scale", "none"),
    (r"^image_encoder\.(ln_t_\d+|ln_c_\d+)\.bias$", r"image_encoder/\1/bias", "none"),
]


def convert_state_dict(state_dict: Mapping[str, Any], rules: Sequence[Rule] = DEFAULT_RULES,
                       strict: bool = True) -> Dict[str, Any]:
    """A reference-layout state dict -> the nested flax params tree
    ``{"params": {...}}`` of float32 numpy arrays. A key no rule matches
    raises KeyError unless ``strict`` is off, when it is skipped."""
    tree: Dict[str, Any] = {}
    unmatched = []
    for key, value in state_dict.items():
        arr = np.asarray(value.detach().cpu().numpy() if hasattr(value, "detach") else value)
        for pattern, template, transform in rules:
            m = re.match(pattern, key)
            if m:
                if template is None:
                    break       # dropped on purpose (buffers)
                *parents, leaf = m.expand(template).split("/")
                node = tree
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = TRANSFORMS[transform or "none"](arr).astype(np.float32)
                break
        else:
            unmatched.append(key)
    if unmatched and strict:
        raise KeyError(f"{len(unmatched)} torch keys had no conversion rule (pass strict=False "
                       f"to skip): {unmatched[:8]}...")
    return {"params": tree}


def load_rules_file(path: str) -> List[Rule]:
    """A YAML rules file: a list of {pattern, path, transform}; an entry
    without ``path`` drops its keys."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    return [(r["pattern"], r.get("path"), r.get("transform")) for r in raw]


def template_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """The tensor shapes a checkpoint for ``cfg`` must carry: those of
    ``DPF(cfg)``, and for SVR also the PointNet encoder's, which a
    reference SVR checkpoint carries beside the image encoder."""
    from dpfx_torch.models import DPF
    from dpfx_torch.models.encoders import PointNetEncoder

    shapes = {k: tuple(v.shape) for k, v in DPF(cfg).state_dict().items()}
    if cfg.experiment == "svr":
        m = cfg.model
        enc = PointNetEncoder(m.dz, tuple(m.encoder.point_widths), tuple(m.encoder.head_widths),
                              activation=m.encoder.activation)
        shapes.update({f"encoder.{k}": tuple(v.shape) for k, v in enc.state_dict().items()})
    return shapes


def verify_against_template(state_dict: Mapping[str, torch.Tensor],
                            template: Mapping[str, Tuple[int, ...]]) -> List[str]:
    """Missing keys, extra keys and shape mismatches of ``state_dict``
    against ``template`` (key -> shape)."""
    problems = [f"missing: {k}" for k in template if k not in state_dict]
    problems += [f"shape mismatch at {k}: {tuple(state_dict[k].shape)} vs {s}"
                 for k, s in template.items()
                 if k in state_dict and tuple(state_dict[k].shape) != s]
    problems += [f"extra: {k}" for k in state_dict if k not in template]
    return problems


def unwrap_checkpoint(obj: Any) -> Any:
    """The state dict of a ``torch.save`` layout that nests it under
    ``state_dict``, ``model``, ``model_state`` or ``net``."""
    if isinstance(obj, dict):
        for k in ("state_dict", "model", "model_state", "net"):
            if k in obj and isinstance(obj[k], dict):
                return obj[k]
    return obj


def to_port_state_dict(params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """A converted flax tree -> the state dict ``DPF(cfg)`` loads strictly.
    Raises ValueError when it does not fit the config."""
    sd = params_from_flax(params)
    problems = verify_against_template(sd, template_shapes(cfg))
    if problems:
        raise ValueError("converted checkpoint does not match the model built from config:\n  "
                         + "\n  ".join(problems[:20]))
    if cfg.experiment == "svr":
        sd = {k: v for k, v in sd.items() if not k.startswith("encoder.")}
    return sd


def load_torch_checkpoint(path: str, cfg=None, rules: Sequence[Rule] = DEFAULT_RULES,
                          strict: bool = True) -> Dict[str, torch.Tensor]:
    """Read a reference-layout ``.pt`` (unwrapping a nested state dict) and
    convert it: with ``cfg``, to the verified state dict of ``DPF(cfg)``
    (``to_port_state_dict``); without, to ``params_from_flax`` of the
    converted tree, unverified."""
    obj = unwrap_checkpoint(torch.load(path, map_location="cpu", weights_only=False))
    params = convert_state_dict(obj, rules, strict)
    return params_from_flax(params) if cfg is None else to_port_state_dict(params, cfg)
