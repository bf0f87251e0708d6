"""The evaluation entry: the rollout CLI (``rollout_jsonl``), its scorer
(``eval_math``), the graders (``rewards``) and the engine factory
(``adapters``). Port of ``lapha_tpu/evalsuite/``.
"""

from . import adapters, eval_math, rewards
from .adapters import GenParams, build_engine_adapter
from .rewards import REWARD_FUNCS, RULE_REWARD_FUNCS, LLMJudge, with_llm_judge

__all__ = [
    "adapters",
    "eval_math",
    "rewards",
    "GenParams",
    "build_engine_adapter",
    "REWARD_FUNCS",
    "RULE_REWARD_FUNCS",
    "LLMJudge",
    "with_llm_judge",
]
