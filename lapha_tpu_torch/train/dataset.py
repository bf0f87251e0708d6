"""DAPO-math dataset loader + training reward.

Port of ``lapha_tpu/train/dataset.py``: the parquet -> records conversion
with the answer-format prompt shim, the Minerva-normalized <answer>-tag
training reward on the last 128 chars, and the structural
<think>/<tool_call>/<answer> format score. Normalization reuses the port's
``evalsuite.rewards`` (the same Minerva tables).

Two differences from the JAX module. ``dataloader`` is split in two:
reading the parquet (pandas, imported inside the function) and the row
converter ``dapo_records``, which needs neither pandas nor pyarrow. And
the result is a :class:`Records` list, not a ``datasets.Dataset``: its
``shuffle(seed=)`` gives ``Dataset.shuffle``'s order,
``np.random.default_rng(seed).permutation(n)``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Mapping, Optional

import numpy as np

from ..evalsuite.rewards import last_boxed_only_string, normalize_final_answer, remove_boxed

_PROMPT_SHIM_OLD_TAIL = '\n\nRemember to put your answer on its own line after "Answer:".'
_PROMPT_SHIM_NEW_TAIL = "\n👆\nformat the FINAL answer as `<answer>...</answer>`."
_PROMPT_SHIM_OLD_HEAD = (
    "Solve the following math problem step by step. The last line of your "
    "response should be of the form Answer: $Answer (without quotes) where "
    "$Answer is the answer to the problem.\n\n"
)


def is_correct_minerva(solution_str: str, gt: str, gt_need_extract: bool = False,
                       answer_pattern: str = r"(?i)Answer\s*:\s*([^\n]+)") -> tuple[bool, str]:
    match = re.findall(answer_pattern, solution_str or "", re.DOTALL)
    extracted = match[-1] if match else "[INVALID]"
    pred = normalize_final_answer(extracted)
    if gt_need_extract:
        gt = normalize_final_answer(remove_boxed(last_boxed_only_string(gt)))
    else:
        gt = normalize_final_answer(gt)
    return (pred == gt), pred


def verify(solution_str: str, answer: str, strict_box_verify: bool = False,
           pause_tokens_index=None,
           answer_pattern: str = r"(?i)Answer\s*:\s*([^\n]+)") -> tuple[bool, Optional[str]]:
    if strict_box_verify:
        pred = (solution_str or "")[-100:]
        boxed = last_boxed_only_string(pred)
        extracted = remove_boxed(boxed) if boxed is not None else None
        return extracted == answer, extracted
    return is_correct_minerva(solution_str, answer, answer_pattern=answer_pattern)


def compute_score(solution_str: str, ground_truth: str,
                  answer_pattern: str = r"(?i)<answer>(.*?)</answer>") -> dict:
    # last 128 chars: the longest MATH-500 answer is 159 chars
    solution_str = (solution_str or "")[-128:]
    correct, _pred = verify(solution_str, ground_truth, answer_pattern=answer_pattern)
    return {"score": 1.0 if correct else 0.0}


def math_reward(completion: str, ground_truth) -> float:
    """The training reward fed into MCTS."""
    return compute_score(completion, ground_truth,
                         answer_pattern=r"<answer>(.*?)</answer>")["score"]


def compute_score_format(solution_str: str) -> float:
    """Structural format score over <|im_start|> assistant/tool blocks."""
    if solution_str is None:
        return 0.0
    try:
        blocks = re.findall(r"<\|im_start\|>(?:assistant|tool)\n(.*?)<\|im_end\|>",
                            solution_str, re.DOTALL)
        if not blocks:
            return 0.0
        score = 0.0
        for block in blocks[:-1]:
            if (block.count("<think>") == 1 and block.count("</think>") == 1
                    and block.count("<tool_call>") == 1 and block.count("</tool_call>") == 1):
                if re.search(r"^<think>(.*?)</think>\n<tool_call>(.*?)</tool_call>$",
                             block, re.DOTALL):
                    score += 1.0 / len(blocks)
        last = blocks[-1]
        if re.search(r"^<think>(.*?)</think>\n<answer>(.*?)</answer>$", last, re.DOTALL):
            score += 1.0 / len(blocks)
        return score
    except Exception:
        return 0.0


class Records(list):
    """The dataset: a list of {question, ground_truth, support_material_path}
    dicts whose ``shuffle`` orders rows as ``datasets.Dataset.shuffle``."""

    def shuffle(self, seed: Optional[int] = None) -> "Records":
        order = np.random.default_rng(seed).permutation(len(self))
        return Records(self[int(i)] for i in order)


def dapo_record(prompt, reward_model) -> dict:
    """One DAPO row -> a training record. ``prompt`` is the chat as an
    ndarray, its ``str`` repr or a list of messages; ``reward_model`` a dict
    or its ``str`` repr holding ``ground_truth``."""
    if isinstance(prompt, np.ndarray):
        msgs = prompt.tolist()
    elif isinstance(prompt, str):
        msgs = ast.literal_eval(prompt)
    elif isinstance(prompt, list):
        msgs = prompt
    else:
        raise ValueError(f"Unexpected prompt type: {type(prompt)}")
    question = msgs[0]["content"]
    question = question.replace(_PROMPT_SHIM_OLD_TAIL, _PROMPT_SHIM_NEW_TAIL)
    question = question.replace(_PROMPT_SHIM_OLD_HEAD, "")

    meta = reward_model
    if isinstance(meta, str):
        meta = ast.literal_eval(meta)
    if not isinstance(meta, dict):
        raise ValueError(f"Unexpected reward_model type: {type(meta)}")
    gt = meta.get("ground_truth")
    if gt is None:
        raise KeyError(f"No 'ground_truth' in reward_model: {meta}")
    return {"question": question, "ground_truth": str(gt), "support_material_path": []}


def dapo_records(rows: Iterable[Mapping]) -> Records:
    """Rows with DAPO's ``prompt`` and ``reward_model`` columns -> Records."""
    return Records(dapo_record(row["prompt"], row["reward_model"]) for row in rows)


def dataloader(parquet_path: str) -> Records:
    """DAPO-math parquet -> Records with question/ground_truth/support."""
    import pandas as pd

    df = pd.read_parquet(parquet_path)
    return dapo_records(row for _, row in df.iterrows())
