from .config import MTPOConfig
from .dataset import compute_score_format, dataloader, math_reward
from .shaping import ShapingConfig, compute_action_rewards, fmt_bonus, has_answer
from .trainer import MTPOTrainer

__all__ = [
    "MTPOConfig",
    "compute_score_format",
    "dataloader",
    "math_reward",
    "ShapingConfig",
    "compute_action_rewards",
    "fmt_bonus",
    "has_answer",
    "MTPOTrainer",
]
