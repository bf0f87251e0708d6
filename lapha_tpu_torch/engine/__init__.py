from . import sampling
from .adapter import CompletionOutput, RequestOutput, SamplingParams
from .engine import Engine
from .prefix_cache import PrefixCacheStore

__all__ = ["CompletionOutput", "Engine", "PrefixCacheStore", "RequestOutput",
           "SamplingParams", "sampling"]
