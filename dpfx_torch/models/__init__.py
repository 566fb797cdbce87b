from dpfx_torch.models.coupling import ACTIVATIONS, CouplingFlow, make_masks
from dpfx_torch.models.dpf import DPF
from dpfx_torch.models.encoders import ConvImageEncoder, MixerImageEncoder, PointNetEncoder

__all__ = ["ACTIVATIONS", "CouplingFlow", "ConvImageEncoder", "DPF", "MixerImageEncoder",
           "PointNetEncoder", "make_masks"]
