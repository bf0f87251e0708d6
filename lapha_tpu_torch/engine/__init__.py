from . import sampling
from .adapter import CompletionOutput, FakeEngine, RequestOutput, SamplingParams
from .engine import Engine
from .prefix_cache import PrefixCacheStore

__all__ = ["CompletionOutput", "Engine", "FakeEngine", "PrefixCacheStore", "RequestOutput",
           "SamplingParams", "sampling"]
