from dpfx_torch.models.coupling import ACTIVATIONS, CouplingFlow, make_masks
from dpfx_torch.models.dpf import DPF
from dpfx_torch.models.encoders import PointNetEncoder

__all__ = ["ACTIVATIONS", "CouplingFlow", "DPF", "PointNetEncoder", "make_masks"]
