"""Training configuration (MTPOConfig), yaml-loadable.

A copy of ``lapha_tpu/train/config.py`` (importing it would pull in the
JAX package): the same fields, defaults and validation. PyYAML is imported
inside ``from_yaml`` only, so the port runs where it is not installed.
In the port, ``attn_implementation`` "auto"/"pallas"/"flash"/None select
the flash kernels on CUDA and their plain versions on the CPU; "dense"
runs the plain version on the CPU and raises on CUDA (there is no dense
CUDA attention). ``profile_dir`` takes a ``torch.profiler`` trace; the
mesh knobs above 1 raise (multi-device is not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class MTPOConfig:
    # ---- io / run ----
    output_dir: str = "out"
    seed: int = 42
    logging_steps: int = 1
    save_steps: int = 5
    save_strategy: str = "steps"
    max_steps: int = -1
    num_train_epochs: float = 1.0
    resume_from_checkpoint: Optional[str] = None
    report_to: str = "tensorboard"
    debug_print: bool = True
    # profiler trace of one training step (host+device timeline); the
    # reference's telemetry is print-based (_p(), SURVEY §5.1)
    profile_dir: Optional[str] = None
    profile_step: int = 1

    # ---- model ----
    model_name_or_path: Optional[str] = None
    # training-forward attention (module docstring): "auto"/"pallas"/
    # "flash"/"flash_attention_2" = the flash kernels on CUDA (forward and
    # backward); "dense"/"eager"/"sdpa" = the plain version, CPU only.
    attn_implementation: str = "auto"
    bf16: bool = True
    gradient_checkpointing: bool = True
    # per-layer remat policy when gradient_checkpointing is on: "full"
    # (save nothing — min memory); "save_qkv", "save_attn", "save_qkv_attn"
    # are not ported yet and raise (models/qwen2.remat_policy)
    remat_policy: str = "full"

    # ---- optimization ----
    learning_rate: float = 1e-6
    lr_scheduler_type: str = "cosine"
    warmup_ratio: float = 0.05
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    per_device_train_batch_size: int = 8
    # optax.MultiSteps: grads from N successive train steps (each one full
    # rollout batch, HF-Trainer semantics) accumulate before one optimizer
    # application
    gradient_accumulation_steps: int = 1

    # ---- tree search (mtpo_config.py:228-254) ----
    depth: int = 6
    breadth: int = 6
    num_sim: int = 24
    num_pos_sim: int = 1
    prune_per: int = 8
    c_puct: float = 1.0
    v_prior: float = 0.5
    value_trust: float = 1.0
    max_expands: Any = 2                      # int | "decay"
    max_model_len: int = 4096
    # frontier leaves expanded per MCTS round; leaves_per_sim * breadth rows
    # decode together — the decode batch size lever (the reference derives
    # this from the DDP world size, agent.py:664-671; here it is explicit)
    leaves_per_sim: int = 4

    # ---- value head + distance shaping (255-272) ----
    value_head_type: str = "linear"           # only "linear" runs (see §7.4)
    value_w: float = 1.0
    no_head_scale: float = 0.0
    curvature: float = 1.0
    value_activation: str = "sigmoid"
    num_trees: int = -1                       # -1: MSE on step_samples only
    mse_micro_bs: int = 1

    # ---- pass@k (273-286) ----
    passk_threshold: float = 1.0

    # ---- GRPO loss (514-630) ----
    epsilon: float = 0.2
    epsilon_high: Optional[float] = None
    loss_type: str = "grpo"                   # grpo | bnpo | dr_grpo
    importance_sampling_level: str = "token"  # token | sequence
    beta: float = 0.0                         # ref-KL weight
    scale_rewards: Any = "group"              # none | batch | group (or bool)
    num_groups: int = 8
    # PPO epochs per rollout batch (μ). The reference defines this knob
    # (mtpo_config.py:522) but its trainer hard-codes the on-policy detach;
    # here >1 caches old logps before the first update so the clip is live.
    num_iterations: int = 1

    # ---- adaptive fmt bonus (reward shaping) ----
    adaptive_fmt_bonus: bool = True
    adapt_alpha_fmt: float = 1.0
    adapt_alpha_dv: float = 1.0
    adapt_eps: float = 1e-8
    adapt_min_weight: float = 0.0
    adapt_dv_var_eps: float = 1e-12
    adapt_dv_sum_eps: float = 1e-9

    # ---- generation (441-512) ----
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    max_prompt_length: int = 4096
    max_completion_length: int = 1024
    num_generations: int = 8
    generation_batch_size: Optional[int] = None
    steps_per_generation: Optional[int] = None

    # ---- accepted-but-inert compatibility knobs (server-mode generation
    #      does not exist here: the engine shares the training arrays) ----
    use_vllm: bool = False
    vllm_mode: str = "colocate"
    vllm_server_base_url: Optional[str] = None
    vllm_gpu_memory_utilization: float = 0.3
    vllm_tensor_parallel_size: int = 1

    # ---- mesh (one device in the port: mesh_model / mesh_sequence > 1 raise) ----
    mesh_data: int = -1
    mesh_model: int = 1
    mesh_sequence: int = 1
    # rollout engine knobs: kv_quant="int8", spec_decode="pld" with
    # engine_spec_k drafts an iteration
    engine_kv_quant: Optional[str] = None     # None | "int8"
    engine_spec_decode: Optional[str] = None  # None | "pld"
    engine_spec_k: int = 3

    def __post_init__(self):
        if self.epsilon_high is None:
            self.epsilon_high = self.epsilon
        if self.value_head_type != "linear":
            raise ValueError(
                f"value_head_type={self.value_head_type!r}: only 'linear' is "
                "implemented (the reference's 'qwen2' default names an "
                "undefined class, mtpo_trainer.py:654)."
            )
        # generation batch validation (mtpo_config.py:652-693)
        if self.generation_batch_size is not None and self.steps_per_generation is not None:
            raise ValueError("generation_batch_size and steps_per_generation are mutually exclusive")
        if self.num_generations < 2:
            raise ValueError("num_generations must be >= 2 for group-relative advantages")
        if self.generation_batch_size is not None and \
                self.generation_batch_size % self.num_generations != 0:
            raise ValueError("generation_batch_size must be divisible by num_generations")
        if self.loss_type not in ("grpo", "bnpo", "dr_grpo"):
            raise ValueError(f"unknown loss_type {self.loss_type!r}")
        if self.importance_sampling_level not in ("token", "sequence"):
            raise ValueError(f"unknown importance_sampling_level {self.importance_sampling_level!r}")
        if self.num_iterations < 1:
            raise ValueError("num_iterations must be >= 1")

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "MTPOConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in known}
        ignored = sorted(set(raw) - known)
        kwargs.update(overrides)
        cfg = cls(**kwargs)
        cfg._ignored_yaml_keys = ignored  # surfaced by the CLI for visibility
        return cfg
