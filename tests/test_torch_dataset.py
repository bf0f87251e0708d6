"""The port's DAPO dataset and training reward (``train/dataset.py``)
against the JAX package's, on the CPU. Tolerance: none; records, orders
and scores are equal.

- the row converter and ``dataloader`` against JAX's ``dataloader`` on the
  three prompt encodings (ndarray, ``str`` repr, list), both
  ``reward_model`` forms (dict, ``str`` repr), the prompt shim's head and
  tail, a missing ``ground_truth`` (KeyError) and bad prompt and
  reward_model types (ValueError); once through a parquet file written here;
- ``Records.shuffle(seed)`` gives ``datasets.Dataset.shuffle``'s order;
- ``math_reward``, ``compute_score``, ``verify(strict_box_verify=True)``,
  ``is_correct_minerva(gt_need_extract=True)`` and ``compute_score_format``
  on completions built from every answer of each ``data/*.jsonl`` file.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from lapha_tpu.train import dataset as jds
from lapha_tpu_torch.train import compute_score_format, dataloader, math_reward
from lapha_tpu_torch.train import dataset as tds

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
HEAD = tds._PROMPT_SHIM_OLD_HEAD
TAIL = tds._PROMPT_SHIM_OLD_TAIL


def _msgs(i: int) -> list:
    body = f"What is {i} + {i + 1}?"
    content = (HEAD + body + TAIL) if i % 2 == 0 else body
    return [{"content": content, "role": "user"}]


def _frame() -> pd.DataFrame:
    """Every accepted encoding of both columns, in one object frame."""
    prompts, metas = [], []
    for i in range(12):
        m = _msgs(i)
        prompts.append([np.array(m, dtype=object), repr(m), m][i % 3])
        meta = {"ground_truth": str(2 * i + 1), "style": "rule"}
        metas.append(meta if i % 2 == 0 else repr(meta))
    return pd.DataFrame({"prompt": pd.Series(prompts, dtype=object),
                         "reward_model": pd.Series(metas, dtype=object),
                         "data_source": ["math"] * 12})


def test_dataloader_matches_jax_on_every_encoding(monkeypatch):
    frame = _frame()
    monkeypatch.setattr(pd, "read_parquet", lambda path: frame)
    want = list(jds.dataloader("unused.parquet"))
    got = dataloader("unused.parquet")
    assert isinstance(got, tds.Records) and got == want
    assert not any(HEAD in r["question"] or TAIL in r["question"] for r in got)
    assert got[0]["question"].endswith(tds._PROMPT_SHIM_NEW_TAIL)
    assert got[0]["support_material_path"] == [] and got[1]["ground_truth"] == "3"
    # the converter alone, without pandas
    assert tds.dapo_records(row for _, row in frame.iterrows()) == want


def test_dataloader_reads_a_parquet_like_jax(tmp_path):
    """pyarrow gives the chat column as an ndarray of dicts and the struct
    column as a dict."""
    path = str(tmp_path / "dapo.parquet")
    pd.DataFrame({"prompt": [_msgs(i) for i in range(5)],
                  "reward_model": [{"ground_truth": f"{i}/2", "style": "rule"}
                                   for i in range(5)]}).to_parquet(path)
    raw = pd.read_parquet(path)
    assert isinstance(raw["prompt"][0], np.ndarray) and isinstance(raw["reward_model"][0], dict)
    assert dataloader(path) == list(jds.dataloader(path))


@pytest.mark.parametrize("prompt,meta,err", [
    (_msgs(1), {"style": "rule"}, KeyError),
    (_msgs(1), repr({"ground_truth": None}), KeyError),
    (7, {"ground_truth": "1"}, ValueError),
    ({"content": "q"}, {"ground_truth": "1"}, ValueError),
    (_msgs(1), ["1"], ValueError),
], ids=["no_gt", "gt_none", "int_prompt", "dict_prompt", "list_meta"])
def test_bad_rows_raise_as_jax(monkeypatch, prompt, meta, err):
    frame = pd.DataFrame({"prompt": pd.Series([prompt], dtype=object),
                          "reward_model": pd.Series([meta], dtype=object)})
    monkeypatch.setattr(pd, "read_parquet", lambda path: frame)
    with pytest.raises(err):
        jds.dataloader("unused.parquet")
    with pytest.raises(err):
        dataloader("unused.parquet")
    with pytest.raises(err):
        tds.dapo_record(prompt, meta)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_shuffle_order_matches_datasets(seed):
    from datasets import Dataset

    rows = [{"question": f"q{i}", "ground_truth": str(i), "support_material_path": []}
            for i in range(37)]
    want = list(Dataset.from_list(rows).shuffle(seed=seed))
    got = tds.Records(rows).shuffle(seed=seed)
    assert isinstance(got, tds.Records) and got == want and got != rows


def _completions(q: str, ans: str) -> list[str]:
    wrong = ans + "1"
    return [
        f"<think>work</think>\n<answer>{ans}</answer>",
        f"<think>work</think>\n<answer>{wrong}</answer>",
        f"some text\nAnswer: {ans}\n",
        f"Answer: {wrong}",
        "x" * 200 + f"<answer>{ans}</answer>",
        f"<answer>{ans}</answer>" + "y" * 200,
        f"so the result is \\boxed{{{ans}}}",
        f"\\boxed{{{wrong}}}",
        f"<|im_start|>assistant\n<think>{q[:40]}</think>\n<tool_call>x</tool_call><|im_end|>\n"
        f"<|im_start|>tool\n<think>t</think>\n<answer>{ans}</answer><|im_end|>",
        f"<|im_start|>assistant\n<think>a</think>\n<answer>{ans}</answer><|im_end|>",
        f"<|im_start|>assistant\nno tags {ans}<|im_end|>",
        "",
    ]


@pytest.mark.parametrize("name", ["aime-24", "aime-25", "gaokao-23", "math-500", "olympiad"])
def test_rewards_match_jax_on_every_answer(name):
    with open(os.path.join(DATA, f"{name}.jsonl"), encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    n = 0
    for row in rows:
        ans, q = str(row["answer"]), row["question"]
        for c in _completions(q, ans):
            assert math_reward(c, ans) == jds.math_reward(c, ans)
            assert tds.compute_score(c, ans) == jds.compute_score(c, ans)
            assert tds.verify(c, ans, strict_box_verify=True) == jds.verify(
                c, ans, strict_box_verify=True)
            boxed = f"\\boxed{{{ans}}}"
            assert tds.is_correct_minerva(c, boxed, gt_need_extract=True) == \
                jds.is_correct_minerva(c, boxed, gt_need_extract=True)
            assert compute_score_format(c) == jds.compute_score_format(c)
            n += 1
        assert math_reward(f"<answer>{ans}</answer>", ans) == 1.0
    assert compute_score_format(None) == jds.compute_score_format(None) == 0.0
    assert n == 12 * len(rows)
