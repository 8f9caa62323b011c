"""PyTorch model zoo: every family of the assigned architectures (dense,
MoE, SSM, hybrid, encoder-decoder, VLM)."""
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
