from . import sampling, spec
from .adapter import CompletionOutput, FakeEngine, RequestOutput, SamplingParams
from .client import EngineClient, RemoteEngineAdapter
from .diffusion import DiffusionEngine
from .engine import Engine
from .prefix_cache import PrefixCacheStore
from .scheduler import ContinuousEngine

__all__ = ["CompletionOutput", "ContinuousEngine", "DiffusionEngine", "Engine", "EngineClient",
           "FakeEngine", "PrefixCacheStore", "RemoteEngineAdapter", "RequestOutput",
           "SamplingParams", "sampling", "spec"]
