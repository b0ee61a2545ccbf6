from repro_torch.models.model import FAMILIES, Model
from repro_torch.models.params import ParamSpec, init_params, params_from_numpy

__all__ = ["FAMILIES", "Model", "ParamSpec", "init_params",
           "params_from_numpy"]
