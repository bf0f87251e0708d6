from . import sampling, spec
from .adapter import CompletionOutput, FakeEngine, RequestOutput, SamplingParams
from .client import EngineClient, RemoteEngineAdapter
from .engine import Engine
from .prefix_cache import PrefixCacheStore
from .scheduler import ContinuousEngine

__all__ = ["CompletionOutput", "ContinuousEngine", "Engine", "EngineClient", "FakeEngine",
           "PrefixCacheStore", "RemoteEngineAdapter", "RequestOutput", "SamplingParams",
           "sampling", "spec"]
