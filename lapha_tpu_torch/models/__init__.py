from . import loader, quant, qwen2, value_model
from .qwen2 import Qwen2Config

__all__ = ["Qwen2Config", "loader", "model_module", "quant", "qwen2", "value_model"]


def model_module(cfg):
    """Config -> its model module (qwen2 | deepseek): the one dispatch point
    of the Engine and the value model, as in the JAX package. deepseek is
    imported lazily (it imports qwen2 for the shared pieces)."""
    if type(cfg).__name__ == "DeepseekConfig":
        from . import deepseek

        return deepseek
    return qwen2
