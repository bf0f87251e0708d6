"""Tree reward shaping: win-rates, hyperbolic V-map, ΔV edge rewards.

Behavior parity with the reference implementation's trainer/mtpo_trainer.py
compute_action_rewards (2448-3146): DAG construction with super-root
(2629-2657), bottom-up win_rate (2660-2704), terminal census / avgAcc
(2706-2728), on-path marking (2730-2749), V-map from the latent bank with
correct-leaf (+ optional CoT) anchors (2751-2838), max-v_pred pass@1
(2878-2886), and adaptive ΔV/format-bonus edge mixing (2888-2960).

Port of ``lapha_tpu/train/shaping.py``: the same host bookkeeping over
≤10³ nodes, with the V-map distances computed by the port's
``ops.potential_v`` (PyTorch, float32, on the host: the bank lives there).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..ops import potential_v

_ANSWER_RE = re.compile(r"<answer>.*?</answer>", re.DOTALL)


def has_answer(step: dict) -> bool:
    return bool(_ANSWER_RE.search(step.get("completion", "") or ""))


def fmt_bonus(completion: str) -> float:
    """1.0 iff the step looks like STEP-i:\\n<think>..</think>[answer|tool|ε]
    (reference _fmt_bonus, mtpo_trainer.py:2601-2627)."""
    c = completion or ""
    if not re.match(r"^STEP-\d+:\r?\n", c):
        return 0.0
    rest = re.sub(r"^STEP-\d+:\r?\n", "", c, count=1)
    if re.search(r"STEP-\d+:", rest):
        return 0.0
    think = re.match(r"<think>.*?</think>", rest, re.S)
    if not think:
        return 0.0
    remain = rest[think.end():].strip()
    if not remain:
        return 1.0
    if re.fullmatch(r"<answer>.*?</answer>", remain, re.S) or \
            re.fullmatch(r"<tool_call>.*?</tool_call>", remain, re.S):
        return 1.0
    return 0.0


class ShapingConfig:
    def __init__(self, *, depth: int, passk_threshold: float = 1.0, curvature: float = 1.0,
                 adaptive_fmt_bonus: bool = True, adapt_alpha_fmt: float = 1.0,
                 adapt_alpha_dv: float = 1.0, adapt_eps: float = 1e-8,
                 adapt_min_weight: float = 0.0, adapt_dv_var_eps: float = 1e-12,
                 adapt_dv_sum_eps: float = 1e-9, max_prompt_length: int = 0):
        self.depth = depth
        self.passk_threshold = passk_threshold
        self.curvature = max(curvature, 1e-8)
        self.adaptive_fmt_bonus = adaptive_fmt_bonus
        self.adapt_alpha_fmt = adapt_alpha_fmt
        self.adapt_alpha_dv = adapt_alpha_dv
        self.adapt_eps = adapt_eps
        self.adapt_min_weight = adapt_min_weight
        self.adapt_dv_var_eps = adapt_dv_var_eps
        self.adapt_dv_sum_eps = adapt_dv_sum_eps
        self.max_prompt_length = max_prompt_length


def compute_action_rewards(
    chains: list[list[dict]],
    reward_fns: list[Callable[[str, Any], float]],
    ground_truth: Any,
    cfg: ShapingConfig,
    *,
    bank=None,
    root_step: Optional[dict] = None,
    cot_anchor: Optional[np.ndarray] = None,
    agg_leaf: Callable = max,
    agg_internal: Callable = lambda xs: sum(xs) / len(xs),
) -> tuple[float, float, dict]:
    """Annotate every step with win_rate/is_leaf/is_correct/on_path/v_target/
    reward; returns (avgAcc, pass@1, diagnostics)."""

    # ---- 1) DAG ----
    children: dict[int, set[int]] = defaultdict(set)
    indeg: dict[int, int] = defaultdict(int)
    parent_of: dict[int, int] = {}
    steps: dict[int, dict] = {}
    for chain in chains:
        for i, st in enumerate(chain):
            sid = id(st)
            steps[sid] = st
            if i + 1 < len(chain):
                cid = id(chain[i + 1])
                steps[cid] = chain[i + 1]
                if cid not in children[sid]:
                    children[sid].add(cid)
                    indeg[cid] += 1
                    parent_of.setdefault(cid, sid)
    roots = [sid for sid in steps if indeg[sid] == 0]
    root_sid = None
    if root_step is not None:
        root_sid = id(root_step)
        steps[root_sid] = root_step
        children.setdefault(root_sid, set())
        for r in roots:
            children[root_sid].add(r)
            parent_of[r] = root_sid
        roots = [root_sid]
    for sid in list(steps):
        children.setdefault(sid, set())

    # ---- 2) bottom-up win_rate ----
    def is_terminal_leaf(st: dict, kids: set) -> bool:
        if kids:
            return False
        if has_answer(st):
            return True
        return int(st.get("current_depth") or 0) >= cfg.depth

    memo: dict[int, float | None] = {}

    def dfs_wr(sid: int):
        if sid in memo:
            return memo[sid]
        st = steps[sid]
        kids = children[sid]
        if not kids:
            terminal = is_terminal_leaf(st, kids)
            st["is_leaf"] = bool(terminal)
            if terminal:
                if "_true_reward" in st and agg_leaf is max:
                    # search already computed max(reward_fns) for this step —
                    # re-running would double expensive judges (LLM calls)
                    r = st["_true_reward"]
                elif reward_fns:
                    r = agg_leaf([f(st.get("completion", ""), ground_truth) for f in reward_fns])
                else:
                    r = 0.0
                st["win_rate"] = float(r)
            else:
                st["win_rate"] = None
            memo[sid] = st["win_rate"]
            return memo[sid]
        vals = [v for v in (dfs_wr(c) for c in kids) if v is not None]
        st["is_leaf"] = False
        st["win_rate"] = float(agg_internal(vals)) if vals else None
        memo[sid] = st["win_rate"]
        return memo[sid]

    for r in roots:
        dfs_wr(r)

    # ---- 3) census ----
    terminal_sids, answered_sids, correct_sids = [], [], []
    for sid, st in steps.items():
        if not children[sid] and bool(st.get("is_leaf", False)):
            terminal_sids.append(sid)
            if has_answer(st):
                answered_sids.append(sid)
            wr = st.get("win_rate")
            correct = wr is not None and float(wr) >= cfg.passk_threshold
            st["is_correct"] = bool(correct)
            if correct:
                correct_sids.append(sid)
        else:
            st["is_correct"] = False
    avg_acc = len(correct_sids) / len(terminal_sids) if terminal_sids else 0.0

    # ---- 4) on-path marking ----
    on_path: set[int] = set()
    for leaf in correct_sids:
        cur = leaf
        while cur is not None and cur not in on_path:
            on_path.add(cur)
            cur = parent_of.get(cur)
    for sid, st in steps.items():
        st["on_path"] = sid in on_path

    # ---- 5) V-map ----
    v_map: dict[int, float] = {sid: 0.0 for sid in steps}
    diag: dict[str, float] = {}
    if bank is not None and chains:
        node_sids = [sid for sid, st in steps.items() if st.get("hid_idx") is not None]
        if node_sids:
            idx = [int(steps[s]["hid_idx"]) for s in node_sids]
            Y = np.asarray(bank.index_select(idx), np.float32)  # (N, H)
            sid2row = {s: i for i, s in enumerate(node_sids)}

            anchors = []
            corr_rows = [sid2row[s] for s in correct_sids if s in sid2row]
            if corr_rows:
                anchors.append(Y[np.asarray(corr_rows)])
            if cot_anchor is not None:
                anchors.append(np.asarray(cot_anchor, np.float32).reshape(1, -1))

            if anchors and root_sid in sid2row:
                A = np.concatenate(anchors, axis=0)
                y_root = Y[sid2row[root_sid]]
                V = potential_v(torch.from_numpy(Y), torch.from_numpy(y_root),
                                torch.from_numpy(A), c=cfg.curvature, eps=1e-8).numpy()
                for sid, row in sid2row.items():
                    v_map[sid] = float(V[row])
                diag["vmap_mean"] = float(V.mean())
                diag["vmap_std"] = float(V.std())

    for sid, st in steps.items():
        st["v_target"] = float(v_map[sid])

    # ---- 6) pass@1: max-v_pred answered leaf correctness ----
    pass_at_1 = 0.0
    if answered_sids:
        best = max(answered_sids, key=lambda s: float(steps[s].get("v_pred") or -1e9))
        pass_at_1 = 1.0 if steps[best].get("is_correct", False) else 0.0

    # ---- 7) edge rewards ----
    if not cfg.adaptive_fmt_bonus:
        for sid, st in steps.items():
            p = parent_of.get(sid)
            st["reward"] = 0.0 if (sid == root_sid or p is None) \
                else float(v_map[sid] - v_map[p])
    else:
        dv_list, fmt_flags = [], []
        for sid, st in steps.items():
            p = parent_of.get(sid)
            if sid == root_sid or p is None:
                continue
            dv_list.append(v_map[sid] - v_map[p])
            fmt_flags.append(1.0 if fmt_bonus(st.get("completion", "")) > 0.0 else 0.0)

        p_fmt_good = float(np.mean(fmt_flags)) if fmt_flags else 0.0
        leaf_correct_rate = len(correct_sids) / max(1, len(terminal_sids))
        def_fmt = max(0.0, 1.0 - p_fmt_good)
        def_cont = max(0.0, 1.0 - leaf_correct_rate)

        dv_arr = np.asarray(dv_list, np.float32)
        has_dv_sig = bool(dv_arr.size > 0 and float(dv_arr.var()) > cfg.adapt_dv_var_eps
                          and float(dv_arr.sum()) > cfg.adapt_dv_sum_eps)
        raw_fmt = def_fmt ** cfg.adapt_alpha_fmt
        raw_dv = (def_cont ** cfg.adapt_alpha_dv) if has_dv_sig else 0.0
        denom = raw_fmt + raw_dv + cfg.adapt_eps
        w_fmt, w_dv = raw_fmt / denom, raw_dv / denom
        if raw_fmt > 0.0 and raw_dv > 0.0 and cfg.adapt_min_weight > 0.0:
            w_fmt = float(np.clip(w_fmt, cfg.adapt_min_weight, 1.0 - cfg.adapt_min_weight))
            w_dv = 1.0 - w_fmt

        for sid, st in steps.items():
            p = parent_of.get(sid)
            if sid == root_sid or p is None:
                st["reward"] = 0.0
                continue
            dv = max(0.0, v_map[sid] - v_map[p])
            fb = 1.0 if fmt_bonus(st.get("completion", "")) > 0.0 else 0.0
            st["reward"] = float(np.clip(w_dv * dv + w_fmt * fb, 0.0, 1.0))
        diag.update(w_fmt=w_fmt, w_dv=w_dv)

    diag.update(avg_acc=avg_acc, pass_at_1=pass_at_1,
                n_terminal=len(terminal_sids), n_correct=len(correct_sids))
    return avg_acc, pass_at_1, diag


def best_var_window_constrained(vals: np.ndarray, ok_mask: np.ndarray, k: int,
                                eps_pos: float = 1e-12):
    """Max-variance length-k window with ≥1 ok and ≥1 positive entry
    (reference _best_var_window_constrained, mtpo_trainer.py:1514-1538)."""
    n = int(vals.shape[0])
    if k <= 1 or k > n:
        return None, float("-inf")
    best_var, best_s = float("-inf"), None
    for s in range(0, n - k + 1):
        w = vals[s:s + k]
        if not ok_mask[s:s + k].any() or not (w > eps_pos).any():
            continue
        var = float(w.var(ddof=1))
        if var > best_var + 1e-12:
            best_var, best_s = var, s
    return (best_s, best_var) if best_s is not None else (None, float("-inf"))
