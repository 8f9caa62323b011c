"""PyTorch model zoo: the dense, VLM and SSM stacks of the assigned
architectures (the rest arrive with later slices)."""
from .model import Model, build_model
from .params import P, abstract_params, count_params, init_params, param_axes

__all__ = [
    "Model",
    "P",
    "abstract_params",
    "build_model",
    "count_params",
    "init_params",
    "param_axes",
]
