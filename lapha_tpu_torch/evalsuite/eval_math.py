"""Score *.pred.jsonl rollouts against gold JSONL (reference-compatible CLI).

Output contract parity with the reference implementation's eval_math.py:280-336:
``eval/results/{ds}.summary.json`` with keys dataset/timestamp/tool/num/
correct@1/pass@1/k/correct@k/pass@k/avg@k_answered/answered/answered_rate,
plus an append-only ``eval/results/summary.csv``.  Supports sharded
``*.pred.rank*.jsonl`` inputs and the env-driven LLM judge
(USE_LLM_JUDGE/JUDGE_ENGINE/JUDGE_TOKENIZER_PATH/JUDGE_BASE_URL...).

A copy of ``lapha_tpu/evalsuite/eval_math.py`` whose judge engine is the
port's (``adapters.build_engine_adapter``). As there, ``EVAL_DIR`` is read
from ``$LAPHA_EVAL_DIR`` when the module is imported.
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import json
import os
import re
import unicodedata
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Dict, List

from .rewards import REWARD_FUNCS, LLMJudge, with_llm_judge

EVAL_DIR = Path(os.getenv("LAPHA_EVAL_DIR", "eval"))


def _dirs():
    dirs = dict(
        logs=EVAL_DIR / "logs",
        rollouts=EVAL_DIR / "rollouts",
        results=EVAL_DIR / "results",
    )
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    return dirs


def data_registry() -> Dict[str, str]:
    return {
        "aime24": os.getenv("DATA_DIR_AIME24", "data/aime-24.jsonl"),
        "aime25": os.getenv("DATA_DIR_AIME25", "data/aime-25.jsonl"),
        "math": os.getenv("DATA_DIR_MATH", "data/math-500.jsonl"),
        "gaokao2023": os.getenv("DATA_DIR_GAOKAO2023", "data/gaokao-23.jsonl"),
        "olympiadbench": os.getenv("DATA_DIR_OLYMPIAD", "data/olympiad.jsonl"),
    }


def qid_of(question: str) -> str:
    qn = unicodedata.normalize("NFKC", question).encode("utf-8")
    return hashlib.sha1(qn).hexdigest()[:10]


def _norm(s: str) -> str:
    s = unicodedata.normalize("NFKC", s or "")
    return re.sub(r"\s+", " ", s.strip().strip("$"))


@dataclass
class RunSummary:
    dataset: str
    time: str
    num: int
    correct_at_1: int
    pass_at_1: float
    tool: str
    k: int
    correct_at_k: int
    pass_at_k: float
    avg_at_k: float
    answered: int
    answered_rate: float


def load_gold(path: Path) -> Dict[str, Dict]:
    out: Dict[str, Dict] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            ex = json.loads(line)
            q = str(ex["question"])
            out[str(ex.get("id") or qid_of(q))] = {"question": q, "answer": str(ex["answer"])}
    return out


def load_preds(paths: List[Path]) -> Dict[str, Dict]:
    out: Dict[str, Dict] = {}
    for p in paths:
        with open(p, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                ex = json.loads(line)
                qid = str(ex.get("qid") or qid_of(ex.get("question", "")))
                out.setdefault(qid, ex)
    return out


def collect_pred_paths(dataset: str) -> List[Path]:
    base = _dirs()["rollouts"] / f"{dataset}.pred.jsonl"
    if base.exists():
        return [base]
    shards = sorted(base.parent.glob(f"{dataset}.pred.rank*.jsonl"))
    if not shards:
        raise FileNotFoundError(f"Predictions not found: {base} or {dataset}.pred.rank*.jsonl")
    return shards


def build_judge_adapter(judge_tokenizer):
    """Env-driven judge engine (JUDGE_ENGINE=tpu|vllm|jet|fake)."""
    from .adapters import build_engine_adapter

    engine = (os.getenv("JUDGE_ENGINE") or "tpu").strip().lower()
    model_path = (os.getenv("JUDGE_MODEL_PATH") or os.getenv("JUDGE_TOKENIZER_PATH"))
    return build_engine_adapter(engine, tokenizer=judge_tokenizer, model_path=model_path)


def score_dataset(dataset: str, gold_map: Dict[str, Dict], pred_map: Dict[str, Dict], k: int,
                  results_dir: Path | None = None) -> RunSummary:
    reward_primary = REWARD_FUNCS.get(dataset)
    use_judge = os.getenv("USE_LLM_JUDGE", "0") in ("1", "true", "True")

    if reward_primary is None:
        reward_fn, tool_tag = None, "reward:strict-em"
    elif use_judge:
        from transformers import AutoTokenizer

        jt = AutoTokenizer.from_pretrained(os.environ["JUDGE_TOKENIZER_PATH"],
                                           trust_remote_code=True, use_fast=True)
        judge = LLMJudge(jt, build_judge_adapter(jt))
        reward_fn, tool_tag = with_llm_judge(reward_primary, judge.score), "reward:rule-max+judge"
    else:
        reward_fn, tool_tag = (lambda c, a: float(reward_primary(c, a))), "reward:rule-max"

    tot = hit1 = hitk = 0
    avg_sum = 0.0
    answered_total = denom_total = 0
    k = int(k) if int(k) > 0 else 1

    for qid, g in gold_map.items():
        tot += 1
        p = pred_map.get(qid, {})
        comp_list = p.get("completions")
        fa_list = p.get("final_answers")
        if isinstance(comp_list, list) and comp_list:
            completions = [str(x) for x in comp_list]
            if isinstance(fa_list, list) and len(fa_list) == len(completions):
                finals = [str(x) for x in fa_list]
            else:
                finals = [str(p.get("final_answer", ""))] * len(completions)
        else:
            completions = [str(p.get("completion", ""))]
            finals = [str(p.get("final_answer", ""))]

        k_eff = min(k, len(completions))
        completions, finals = completions[:k_eff], finals[:k_eff]
        denom_total += k_eff

        correct, answered = [], []
        for comp, fin in zip(completions, finals):
            answered.append(bool(_norm(fin)))
            if reward_fn is None:
                correct.append(int(_norm(fin) == _norm(g["answer"])))
            else:
                try:
                    correct.append(int(float(reward_fn(comp, g["answer"])) >= 1.0))
                except Exception:
                    correct.append(0)

        hit1 += int(correct[0] == 1)
        hitk += int(any(c == 1 for c in correct))
        n_ans = sum(answered)
        answered_total += n_ans
        avg_sum += (sum(c for c, a in zip(correct, answered) if a) / n_ans) if n_ans else 0.0

    ts = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    summary = {
        "dataset": dataset,
        "timestamp": ts,
        "tool": tool_tag,
        "num": tot,
        "correct@1": hit1,
        "pass@1": (hit1 / tot) if tot else 0.0,
        "k": int(k),
        "correct@k": hitk,
        "pass@k": (hitk / tot) if tot else 0.0,
        "avg@k_answered": (avg_sum / tot) if tot else 0.0,
        "answered": answered_total,
        "answered_rate": (answered_total / denom_total) if denom_total else 0.0,
    }
    results_dir = results_dir or _dirs()["results"]
    with open(results_dir / f"{dataset}.summary.json", "w", encoding="utf-8") as f:
        json.dump(summary, f, ensure_ascii=False, indent=2)
    return RunSummary(dataset, ts, tot, hit1, summary["pass@1"], tool_tag, int(k),
                      hitk, summary["pass@k"], summary["avg@k_answered"],
                      answered_total, summary["answered_rate"])


def main(argv=None):
    ap = argparse.ArgumentParser(description="Score predictions against standardized gold JSONL.")
    ap.add_argument("--dataset", default="all",
                    choices=["all", "aime24", "aime25", "math", "gaokao2023", "olympiadbench"])
    ap.add_argument("--k", type=int, default=int(os.getenv("PASS_K", "1")))
    args = ap.parse_args(argv)

    registry = data_registry()
    datasets = list(registry) if args.dataset == "all" else [args.dataset]
    rows: List[RunSummary] = []
    for ds in datasets:
        gold_path = Path(registry[ds])
        if not gold_path.exists():
            raise FileNotFoundError(f"Gold not found: {gold_path}")
        rows.append(score_dataset(ds, load_gold(gold_path),
                                  load_preds(collect_pred_paths(ds)), k=args.k))

    csv_path = _dirs()["results"] / "summary.csv"
    need_header = not csv_path.exists()
    with open(csv_path, "a", newline="", encoding="utf-8") as cf:
        wr = csv.writer(cf)
        if need_header:
            wr.writerow(["time", "dataset", "#_samples", "k", "pass@1", "pass@k", "avg@k"])
        for r in rows:
            wr.writerow([r.time, r.dataset, r.num, r.k, r.pass_at_1, r.pass_at_k, r.avg_at_k])


if __name__ == "__main__":
    main()
