"""Test-time answer selection over MCTS chains.

Parity with the reference implementation's trainer/agent.py:1236-1419 (pick_best_leaf):
per-leaf features (backed-up Q, log-visit mass, path logprob, v_pred, value
monotonicity, length penalty, hyperbolic kNN density), z-scored and
weighted; leaves grouped by canonical answer; the group wins by logsumexp
soft evidence at temperature tau_group; the best-logit leaf in the winning
group is returned.

A copy of ``lapha_tpu/search/best_leaf.py`` (host code; importing the JAX
package would pull in jax).
"""

from __future__ import annotations

import math
import re
from collections import defaultdict

import numpy as np

_ANS_RE = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)

DEFAULT_WEIGHTS = dict(zQ=1.0, zlogN=0.8, zlogp=0.4, zv=0.3, zmono=0.3, zdens=0.4, zlen=0.2)


def _answer_text(completion: str) -> str:
    ms = _ANS_RE.findall(completion or "")
    return ms[-1].strip() if ms else ""


def _to_float(x, default=0.0) -> float:
    try:
        v = float(x)
        if math.isfinite(v):
            return v
    except Exception:
        pass
    return float(default)


def _zscore(a: np.ndarray) -> np.ndarray:
    if a.size == 0:
        return a
    return (a - a.mean()) / (a.std() + 1e-6)


def _ball_dist(u: np.ndarray, v: np.ndarray, eps: float = 1e-6) -> float:
    uu, vv = float(u @ u), float(v @ v)
    sq = max(0.0, uu + vv - 2.0 * float(u @ v))
    denom = max(eps, (1.0 - uu) * (1.0 - vv))
    return float(np.arccosh(max(1.0 + 2.0 * sq / denom, 1.0 + 1e-7)))


def _ranked_groups(chains, *, prefer_answer: bool = True, tau_group: float = 0.8,
                   k_nn: int = 5, weights: dict | None = None):
    """Score leaves and return answer groups sorted by soft evidence (desc);
    each group's leaves sorted by (logit, Q, logN) desc. None when no leaves."""
    w = dict(DEFAULT_WEIGHTS if weights is None else weights)

    items = []
    for ch in chains or []:
        if not ch:
            continue
        leaf = ch[-1]
        if leaf.get("disabled") or leaf.get("_disabled"):
            continue
        comp = leaf.get("completion", "") or ""
        has_ans = bool(_ANS_RE.search(comp))
        ans = _answer_text(comp) if has_ans else ""

        vs = [_to_float(st["v_pred"], np.nan) for st in ch if st.get("v_pred") is not None]
        vs = [v for v in vs if np.isfinite(v)]
        v_leaf = vs[-1] if vs else _to_float(leaf.get("v_pred", 0.0))

        mono_pen = sum(max(0.0, (a - b) - 1e-4) for a, b in zip(vs[:-1], vs[1:]))

        cids = leaf.get("completion_ids", None)
        clen = len(cids) if isinstance(cids, (list, tuple)) else (
            int(cids.shape[-1]) if hasattr(cids, "shape") else len(comp))
        len_pen = math.log1p(max(0, clen))

        q = _to_float(leaf.get("_Q", leaf.get("state_value", v_leaf)))
        log_n = math.log1p(max(0, int(leaf.get("_N", 0))))

        logp, has_lp = 0.0, False
        for st in ch:
            if "cum_logprob" in st:
                logp += _to_float(st["cum_logprob"])
                has_lp = True
            elif "p_prior" in st:
                logp += math.log(max(1e-12, _to_float(st["p_prior"])))
                has_lp = True
        if not has_lp:
            logp = 0.0

        hid = leaf.get("hid")
        hid_vec = None
        if isinstance(hid, (list, tuple)) and len(hid) >= 2:
            try:
                hid_vec = np.asarray(hid, np.float32)
            except Exception:
                hid_vec = None

        items.append(dict(chain=ch, leaf=leaf, has_ans=has_ans, ans=ans,
                          Q=q, logN=log_n, logp=logp, v=v_leaf,
                          mono=-mono_pen, neg_len=-len_pen, hid=hid_vec))

    if not items:
        return None

    if prefer_answer:
        answered = [it for it in items if it["has_ans"] and it["ans"]]
        if answered:
            items = answered

    # hyperbolic kNN density (closer neighborhood -> higher score)
    dens = np.zeros(len(items), np.float32)
    valid = [i for i, it in enumerate(items) if it["hid"] is not None]
    if len(valid) >= 3:
        for i in valid:
            ds = sorted(_ball_dist(items[i]["hid"], items[j]["hid"]) for j in valid if j != i)
            k = min(k_nn, len(ds))
            if k:
                dens[i] = -float(sum(ds[:k]) / k)
    for i, it in enumerate(items):
        it["dens"] = float(dens[i])

    feats = {name: _zscore(np.asarray([it[src] for it in items], np.float32))
             for name, src in (("zQ", "Q"), ("zlogN", "logN"), ("zlogp", "logp"),
                               ("zv", "v"), ("zmono", "mono"), ("zdens", "dens"),
                               ("zlen", "neg_len"))}
    logits = sum(w[name] * feats[name] for name in feats)
    for it, lg in zip(items, logits.tolist()):
        it["logit"] = float(lg)

    groups: dict[str, list] = defaultdict(list)
    for it in items:
        groups[it["ans"] or "__NOANS__"].append(it)

    def lse(xs):
        a = np.asarray(xs, np.float32)
        m = float(a.max())
        return m + float(np.log(np.exp(a - m).sum() + 1e-12))

    scored = []
    for ans, lst in groups.items():
        ev = lse([it["logit"] / max(1e-6, tau_group) for it in lst]) + 0.05 * math.log1p(len(lst))
        lst = sorted(lst, key=lambda it: (it["logit"], it["Q"], it["logN"]), reverse=True)
        scored.append((ev, ans, lst))
    scored.sort(key=lambda t: t[0], reverse=True)
    return scored


def pick_best_leaf(chains, *, prefer_answer: bool = True, tau_group: float = 0.8,
                   k_nn: int = 5, weights: dict | None = None):
    scored = _ranked_groups(chains, prefer_answer=prefer_answer, tau_group=tau_group,
                            k_nn=k_nn, weights=weights)
    if not scored:
        return None
    return scored[0][2][0]["leaf"]


def pick_top_leaves(chains, k: int, *, prefer_answer: bool = True, tau_group: float = 0.8,
                    k_nn: int = 5, weights: dict | None = None):
    """Up to k leaves for pass@k: answer-diverse first (best leaf of each group
    in evidence order, then runners-up round-robin). Element 0 is exactly
    pick_best_leaf's winner, preserving pass@1 semantics
    (reference pass@k row contract: eval/rollout_jsonl.py:1323-1338)."""
    scored = _ranked_groups(chains, prefer_answer=prefer_answer, tau_group=tau_group,
                            k_nn=k_nn, weights=weights)
    if not scored:
        return []
    out, rank = [], 0
    while len(out) < k:
        took = False
        for _, _, lst in scored:
            if rank < len(lst):
                out.append(lst[rank]["leaf"])
                took = True
                if len(out) >= k:
                    break
        if not took:
            break
        rank += 1
    return out
