from .config import MTPOConfig
from .shaping import ShapingConfig, compute_action_rewards, fmt_bonus, has_answer
from .trainer import MTPOTrainer

__all__ = [
    "MTPOConfig",
    "ShapingConfig",
    "compute_action_rewards",
    "fmt_bonus",
    "has_answer",
    "MTPOTrainer",
]
