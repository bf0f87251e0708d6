"""Rule-based per-dataset graders (+ LLM-judge fallback).

Behavior parity with the reference implementation's eval/rewards.py (Minerva normalization
57-84, strip_string 105-140, boxed extraction 142-165, AIME strict-int
192-233, MATH graders 249-298, Gaokao MCQ 303-329, Olympiad 334-344,
registry 364-374, LLMJudge 420-476, with_llm_judge 479-510).  The
normalization tables are the standard Minerva/lm-eval ones; scores are
strict 0/1 with max-over-graders composition per dataset.

A copy of ``lapha_tpu/evalsuite/rewards.py`` (host code; importing the JAX
package would pull in jax).
"""

from __future__ import annotations

import re
import unicodedata
from typing import Callable, Dict, List, Optional

ANS_TAG = re.compile(r"<answer>(.*?)</answer>", re.DOTALL | re.IGNORECASE)
BOXED = re.compile(r"\\boxed\{([^}]*)\}")
FINAL = re.compile(r"(?i)(?:^|\n)\s*(?:final\s*answer|answer)\s*[:：]\s*([^\n]+)")

_NUMERIC_TOKEN = re.compile(r"[-+]?\d+(?:/\d+)?|\d*\.\d+|\\sqrt\{[^}]+\}")


def _nfkc(s: str) -> str:
    return unicodedata.normalize("NFKC", s or "")


def _strip_dollars(s: str) -> str:
    return (s or "").strip().strip("$")


# ---------------------------------------------------------------- Minerva-style

MINERVA_SUBSTITUTIONS = [
    ("an ", ""), ("a ", ""), (".$", "$"), ("\\$", ""), (r"\ ", ""),
    (" ", ""), ("mbox", "text"), (",\\text{and}", ","), ("\\text{and}", ","),
    ("\\text{m}", "\\text{}"),
]
MINERVA_REMOVALS = [
    "square", "ways", "integers", "dollars", "mph", "inches", "hours", "km", "units",
    "\\ldots", "sue", "points", "feet", "minutes", "digits", "cents", "degrees", "cm",
    "gm", "pounds", "meters", "meals", "edges", "students", "childrentickets",
    "multiples", "\\text{s}", "\\text{.}", "\\text{\\ns}", "\\text{}^2", "\\text{}^3",
    "\\text{\\n}", "\\text{}", r"\mathrm{th}", r"^\circ", r"^{\circ}", r"\;",
    r",\!", "{,}", '"', "\\dots",
]


def normalize_final_answer(ans: str) -> str:
    """Minerva-like canonicalization of a short final answer."""
    ans = (ans or "").split("=")[-1]
    for a, b in MINERVA_SUBSTITUTIONS:
        ans = ans.replace(a, b)
    for expr in MINERVA_REMOVALS:
        ans = ans.replace(expr, "")
    ans = re.sub(r"(.*?)(\$)(.*?)(\$)(.*)", "$\\3$", ans)
    for wrapper in ("text", "textbf", "overline", "boxed"):
        ans = re.sub(rf"(\\{wrapper}\{{)(.*?)(\}})" if wrapper != "boxed" else r"(\\boxed\{)(.*)(\})",
                     "\\2", ans)
    ans = re.sub(r"(frac)([^{])(.)", r"frac{\2}{\3}", ans)
    ans = re.sub(r"(sqrt)([^{])", r"sqrt{\2}", ans)
    ans = ans.replace("$", "")
    if ans.replace(",", "").isdigit():
        ans = ans.replace(",", "")
    return ans.strip()


# ---------------------------------------------------------------- strip_string

def strip_string(s: str) -> str:
    """Aggressive whitespace/latex canonicalization (VERL/lm-eval family)."""
    s = _nfkc(s)
    for token in ("\n", "\\!", "\\,", "\\;", "\\left", "\\right", "\\$", " ", "\u00a0"):
        s = s.replace(token, "")
    s = re.sub(r"\\text\{([^}]*)\}", r"\1", s)
    s = re.sub(r"\\mathrm\{([^}]*)\}", r"\1", s)
    s = re.sub(r"(\\frac)([0-9])([0-9])", r"\\frac{\2}{\3}", s)
    s = re.sub(r"(\\sqrt)([0-9])", r"\\sqrt{\2}", s)
    s = s.strip("$")
    if re.fullmatch(r"-?\d+\.0+", s):
        s = s.split(".")[0]
    if re.fullmatch(r"-?\.\d+", s):
        s = s.replace(".", "0.", 1)
    return s


def last_boxed_only_string(s: str) -> Optional[str]:
    """Last balanced '\\boxed{...}' span, or None."""
    idx = s.rfind("\\boxed{")
    if idx < 0:
        return None
    depth = 0
    for i in range(idx, len(s)):
        if s[i] == "{":
            depth += 1
        elif s[i] == "}":
            depth -= 1
            if depth == 0:
                return s[idx : i + 1]
    return None


def remove_boxed(s: str) -> str:
    if s.startswith("\\boxed{") and s.endswith("}"):
        return s[len("\\boxed{"):-1]
    return s


def extract_from_completion(completion: str) -> str:
    """<answer> > \\boxed > 'Final Answer:' > last numeric-like token."""
    if not completion:
        return ""
    m = ANS_TAG.search(completion)
    if m:
        return _strip_dollars(_nfkc(m.group(1)))
    m = BOXED.search(completion)
    if m:
        return _strip_dollars(_nfkc(m.group(1)))
    m = FINAL.search(completion)
    if m:
        seg = re.split(r"[\n。]", m.group(1).strip())[0]
        return _strip_dollars(_nfkc(seg))
    nums = _NUMERIC_TOKEN.findall(completion)
    return _strip_dollars(_nfkc(nums[-1])) if nums else ""


# ---------------------------------------------------------------- AIME

def extract_aime_int(completion: str) -> Optional[int]:
    cand = extract_from_completion(completion)
    m = re.search(r"(\d{1,3})\b", cand)
    if m:
        cand = m.group(1)
    else:
        ints = re.findall(r"(?<!\d)(\d{1,3})(?!\d)", completion or "")
        cand = ints[-1] if ints else None
    if cand is None:
        return None
    try:
        val = int(cand)
    except Exception:
        return None
    return val if 0 <= val <= 999 else None


def _aime_gt_int(gt: str) -> Optional[int]:
    gt_clean = _nfkc(gt).strip()
    m = re.fullmatch(r"\s*0*(\d{1,3})\s*$", gt_clean)
    if m:
        return int(m.group(1))
    box = last_boxed_only_string(gt_clean)
    if box is not None:
        digits = re.sub(r"\D", "", remove_boxed(box))
        return int(digits) if digits else None
    g = re.findall(r"(\d{1,3})", gt_clean)
    return int(g[-1]) if g else None


def reward_aime_strict(completion: str, gt: str) -> float:
    pred, gold = extract_aime_int(completion), _aime_gt_int(gt)
    if pred is None or gold is None:
        return 0.0
    return 1.0 if pred == gold else 0.0


def reward_aime_strip_match(completion: str, gt: str) -> float:
    pred = strip_string(extract_from_completion(completion))
    gold = strip_string(extract_from_completion(gt))
    return 1.0 if pred and gold and pred == gold else 0.0


# ---------------------------------------------------------------- MATH

def _gt_raw(gt: str) -> str:
    box = last_boxed_only_string(gt or "")
    return remove_boxed(box) if box is not None else (gt or "")


def reward_math_minerva(completion: str, gt: str) -> float:
    m = ANS_TAG.search(completion or "")
    pred = normalize_final_answer(m.group(1) if m else extract_from_completion(completion))
    gold = normalize_final_answer(_gt_raw(gt))
    return 1.0 if pred == gold and pred != "" else 0.0


def reward_math_strip_string(completion: str, gt: str) -> float:
    pred = strip_string(extract_from_completion(completion))
    gold = strip_string(_gt_raw(gt))
    return 1.0 if pred and gold and pred == gold else 0.0


def reward_math_numeric_if_possible(completion: str, gt: str) -> float:
    pred_s = strip_string(extract_from_completion(completion))
    gold_s = strip_string(extract_from_completion(_gt_raw(gt)) or _gt_raw(gt))
    if pred_s.isdigit() and gold_s.isdigit():
        return 1.0 if int(pred_s) == int(gold_s) else 0.0
    try:
        return 1.0 if abs(float(pred_s) - float(gold_s)) <= 1e-9 else 0.0
    except Exception:
        return 0.0


# ---------------------------------------------------------------- Gaokao / Olympiad

def _extract_choice_letter(s: str) -> Optional[str]:
    s = _nfkc(s).upper()
    m = ANS_TAG.search(s)
    field = m.group(1) if m else s
    m2 = (re.search(r"\b([A-E])\b", field)
          or re.search(r"[(（\[]\s*([A-E])\s*[)）\]]", field)
          or re.search(r"[：:]\s*([A-E])\b", field))
    return m2.group(1) if m2 else None


def reward_gaokao_choice_or_math(completion: str, gt: str) -> float:
    gt_clean = _nfkc(gt).strip().upper()
    if re.fullmatch(r"[A-E]", gt_clean):
        return 1.0 if _extract_choice_letter(completion) == gt_clean else 0.0
    return max(
        reward_math_minerva(completion, gt),
        reward_math_strip_string(completion, gt),
        reward_math_numeric_if_possible(completion, gt),
    )


def reward_olympiad_rule_max(completion: str, gt: str) -> float:
    return max(
        reward_math_minerva(completion, gt),
        reward_math_strip_string(completion, gt),
        reward_math_numeric_if_possible(completion, gt),
    )


# ---------------------------------------------------------------- registry

def _max_rule_reward(fns: List[Callable[[str, str], float]]) -> Callable[[str, str], float]:
    def _r(completion: str, gt: str) -> float:
        best = 0.0
        for fn in fns:
            try:
                best = max(best, float(fn(completion, gt)))
            except Exception:
                continue
        return 1.0 if best >= 1.0 else 0.0
    return _r


RULE_REWARD_FUNCS: Dict[str, List[Callable[[str, str], float]]] = {
    "aime24": [reward_aime_strict, reward_aime_strip_match],
    "aime25": [reward_aime_strict, reward_aime_strip_match],
    "math": [reward_math_minerva, reward_math_strip_string, reward_math_numeric_if_possible],
    "gaokao2023": [reward_gaokao_choice_or_math],
    "olympiadbench": [reward_olympiad_rule_max],
}

REWARD_FUNCS: Dict[str, Callable[[str, str], float]] = {
    k: _max_rule_reward(v) for k, v in RULE_REWARD_FUNCS.items()
}


# ---------------------------------------------------------------- LLM judge

def _extract_final_answer(text: str) -> Optional[str]:
    if not text:
        return None
    for pat in (ANS_TAG, BOXED):
        m = pat.search(text)
        if m:
            return m.group(1).strip()
    m = FINAL.search(text)
    if m:
        return re.split(r"[\n。]", m.group(1).strip())[0].strip()
    return None


def _normalize_basic(s: Optional[str]) -> str:
    if s is None:
        return ""
    return re.sub(r"\s+", " ", s.strip().strip("$"))


def _parse_binary_score(text: str) -> float:
    ms = ANS_TAG.findall(text or "")
    if not ms:
        return 0.0
    try:
        return 1.0 if abs(float(ms[-1].strip()) - 1.0) < 1e-6 else 0.0
    except Exception:
        return 0.0


_JUDGE_PROMPT = """You are a grader.

Task: Decide if the model's answer matches the ground truth.
Rules:
- Output ONLY "<answer>1</answer>" if they are the same (equal numeric value or same exact text).
- Otherwise output ONLY "<answer>0</answer>".
- Do not include any explanation.

# Model Answer
{extracted}

# Ground Truth
{ground_truth}
"""


class LLMJudge:
    """Deterministic pre-check, then a binary <answer>0|1</answer> LLM call."""

    def __init__(self, tokenizer, llm):
        self.tokenizer = tokenizer
        self.llm = llm

    def score(self, model_output: str, ground_truth: str) -> float:
        extracted = _extract_final_answer(model_output)
        if extracted is None:
            return 0.0
        pred, gold = _normalize_basic(extracted), _normalize_basic(ground_truth)
        if pred == gold:
            return 1.0
        if pred.isdigit() and gold.isdigit() and int(pred) == int(gold):
            return 1.0

        from .adapters import GenParams

        msgs = [{"role": "user", "content": _JUDGE_PROMPT.format(
            extracted=extracted, ground_truth=ground_truth)}]
        try:
            chat = self.tokenizer.apply_chat_template(
                conversation=msgs, tokenize=False, add_generation_prompt=True)
        except TypeError:
            chat = self.tokenizer.apply_chat_template(conversation=msgs, tokenize=False)
        sp = GenParams(temperature=0.0, top_p=1.0, top_k=0, min_p=0.0,
                       repetition_penalty=1.0, max_tokens=16)
        out = self.llm.generate(prompts=[chat], sampling_params=sp, use_tqdm=False)
        toks = out[0].outputs[0].token_ids
        return _parse_binary_score(self.tokenizer.decode(toks, skip_special_tokens=True))


def with_llm_judge(primary_reward, judge_callable):
    """Escalate to the judge only when rule=0 AND an <answer> tag exists."""

    def _wrapped(completion: str, gold: str) -> float:
        try:
            s = float(primary_reward(completion, gold))
        except Exception:
            s = 0.0
        if s >= 1.0:
            return 1.0
        if not ANS_TAG.search(completion or ""):
            return 0.0
        try:
            return float(judge_callable(completion, gold))
        except Exception:
            return 0.0

    return _wrapped
