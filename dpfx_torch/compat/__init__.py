from dpfx_torch.compat.params import (
    flatten_tree,
    params_from_flax,
    params_to_flax,
    randomize_,
    unflatten_tree,
)

__all__ = ["flatten_tree", "params_from_flax", "params_to_flax", "randomize_", "unflatten_tree"]
