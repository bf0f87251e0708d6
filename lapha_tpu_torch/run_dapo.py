"""Training entry: ``python -m lapha_tpu_torch.run_dapo --config configs/lapha.yaml``.

Port of the repo's ``run_dapo.py``: the Poor/Coder agent prompt classes,
the DAPO dataset and reward wiring, checkpoint resume, training, and the
HF export with the value head at the end. Its differences:

- ``--device {cuda,cpu}`` (default cuda: without a card it raises, as the
  loaders do) in place of the JAX platform setup;
- every other ``--flag value`` overrides the ``MTPOConfig`` field of that
  name, cast to the field's type: int, float (``1e-6`` too), bool
  (``true``/``false``/``1``/``0``), ``none``/``null`` for an ``Optional``
  field. An unknown flag or a value that does not parse raises, naming the
  flag (the JAX entry passes the strings on uncast);
- ``main(argv=None, *, tokenizer_override=None, dataset_override=None)``
  takes a tokenizer and a list of records in place of ``--tokenizer-path``
  and the parquet, and returns the trainer.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import typing
from datetime import datetime

from .search import MCTSAgent
from .tools import description, execute_python_code
from .train import MTPOConfig, MTPOTrainer, dataloader, math_reward
from .train.dataset import Records

logger = logging.getLogger(__name__)


class PoorAgent(MCTSAgent):
    TOOLS = {}
    TOOLS_DESCRIPTION = ""
    SYSTEM_TEMPLATE = """\
SOLVE THE PROBLEM STEP-BY-STEP. PRESENT THE ANSWER TO EXIT THE LOOP.


# Guidelines
→ Each assistant response must contain exactly one "<think>...</think>" block.
  · If the final answer is ready, use "<answer>...</answer>" block to terminate the loop.
  · No content other than whitespace may appear outside these tags.
→ Begin every response with "STEP-(\\d+):\\n<think>...", 1 step per response."""

    USER_TEMPLATE = """
{support_material_str}
# Please answer:
{question}
"""


class CoderAgent(MCTSAgent):
    TOOLS = {"execute_python_code": execute_python_code}
    TOOLS_DESCRIPTION = description
    SYSTEM_TEMPLATE = PoorAgent.SYSTEM_TEMPLATE
    USER_TEMPLATE = PoorAgent.USER_TEMPLATE


def get_checkpoint(training_args: MTPOConfig):
    latest = os.path.join(training_args.output_dir, "checkpoints", "latest")
    return True if os.path.exists(latest) else None


_TRUE, _FALSE, _NONE = ("true", "1"), ("false", "0"), ("none", "null")


def _cast(flag: str, value: str, kind):
    """``value`` as the type ``kind`` of an MTPOConfig field."""
    args = typing.get_args(kind)
    if typing.get_origin(kind) is typing.Union and type(None) in args:  # Optional[X]
        if value.lower() in _NONE:
            return None
        kind = next(a for a in args if a is not type(None))
    try:
        if kind is bool:
            if value.lower() in _TRUE + _FALSE:
                return value.lower() in _TRUE
            raise ValueError("not one of true/false/1/0")
        if kind is int:
            return int(value)
        if kind is float:
            return float(value)
        if kind is typing.Any:  # max_expands (int | "decay"), scale_rewards (mode | bool)
            if value.lower() in ("true", "false"):
                return value.lower() == "true"
            return int(value) if value.lstrip("-").isdigit() else value
        return value
    except ValueError as e:
        raise ValueError(f"{flag} {value!r}: not a {getattr(kind, '__name__', kind)} ({e})") \
            from None


def parse_overrides(extra: list[str]) -> dict:
    """``--name value`` / ``--name=value`` pairs -> {MTPOConfig field: typed value}."""
    fields = {f.name for f in dataclasses.fields(MTPOConfig)}
    hints = typing.get_type_hints(MTPOConfig)
    out = {}
    it = iter(extra)
    for tok in it:
        if not tok.startswith("--"):
            raise ValueError(f"unexpected argument {tok!r}: overrides are --name value")
        flag, eq, value = tok.partition("=")
        if not eq:
            value = next(it, None)
        key = flag[2:].replace("-", "_")
        if key not in fields:
            raise ValueError(f"{flag}: no MTPOConfig field {key!r}")
        if value is None:
            raise ValueError(f"{flag}: no value")
        out[key] = _cast(flag, value, hints[key])
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="MTPO training on DAPO-math (MCTS + GRPO).")
    ap.add_argument("--config", required=True, help="yaml config (lapha.yaml keys)")
    ap.add_argument("--dataset", default=None, help="DAPO-math parquet path")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def load_records(args: argparse.Namespace, dataset_override=None) -> Records:
    """The training records, unshuffled: ``dataset_override`` where given,
    else the parquet at ``--dataset`` (or ``$DAPO_PARQUET``)."""
    if dataset_override is not None:
        return Records(dataset_override)
    return dataloader(args.dataset or os.getenv(
        "DAPO_PARQUET", "../dapo-math-17k_unique/data/train-00000-of-00001.parquet"))


def main(argv=None, *, tokenizer_override=None, dataset_override=None) -> MTPOTrainer:
    from .models.loader import _device

    args, extra = build_parser().parse_known_args(argv)
    device = _device(args.device, "run_dapo (--device)")
    training_args = MTPOConfig.from_yaml(args.config, **parse_overrides(extra))
    if args.max_steps is not None:
        training_args.max_steps = args.max_steps
    if getattr(training_args, "_ignored_yaml_keys", None):
        logger.info("ignored yaml keys: %s", training_args._ignored_yaml_keys)

    logger.info("Training parameters %s", training_args)

    train_dataset = load_records(args, dataset_override).shuffle(seed=training_args.seed)

    tokenizer = tokenizer_override
    if tokenizer is None and args.tokenizer_path:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer_path, trust_remote_code=True)
        if tokenizer.pad_token is None:
            tokenizer.pad_token = tokenizer.eos_token

    trainer = MTPOTrainer(
        model=training_args.model_name_or_path,
        agent_cls_list=[CoderAgent],
        args=training_args,
        reward_fns=[math_reward],
        train_dataset=train_dataset,
        tokenizer=tokenizer,
        device=device,
    )

    last_ckpt = get_checkpoint(training_args)
    if last_ckpt is not None and training_args.resume_from_checkpoint is None:
        logger.info("Checkpoint detected, resuming training.")

    logger.info("* Starting training %s *", datetime.now().strftime("%Y-%m-%d %H:%M:%S"))
    trainer.train(resume_from_checkpoint=last_ckpt)

    logger.info("* Save model *")
    trainer.save_model(training_args.output_dir,
                       src_config_dir=training_args.model_name_or_path)
    logger.info("Model saved to %s", training_args.output_dir)
    logger.info("* Training complete! *")
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
