from dpfx_torch.compat.convert import (
    DEFAULT_RULES,
    convert_state_dict,
    load_rules_file,
    load_torch_checkpoint,
    to_port_state_dict,
    verify_against_template,
)
from dpfx_torch.compat.params import (
    flatten_tree,
    params_from_flax,
    params_to_flax,
    randomize_,
    unflatten_tree,
)

__all__ = ["DEFAULT_RULES", "convert_state_dict", "flatten_tree", "load_rules_file",
           "load_torch_checkpoint", "params_from_flax", "params_to_flax", "randomize_",
           "to_port_state_dict", "unflatten_tree", "verify_against_template"]
