from . import loader, quant, qwen2, value_model
from .qwen2 import Qwen2Config

__all__ = ["Qwen2Config", "loader", "quant", "qwen2", "value_model"]
