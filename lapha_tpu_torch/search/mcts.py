"""Frontier-heap MCTS over LLM reasoning steps (host orchestrator).

Capability parity with the reference implementation's trainer/agent.py:194-1204
(MCTSAgent.search/_expand_and_evaluate): global-frontier PUCT selection,
batched breadth-n expansion through the generation engine, sibling priors
from cumulative logprobs, terminal rules (<answer>, depth, prompt echo,
length cap), tool-call execution, one batched value forward per round,
terminal-only backup, periodic latent clustering/pruning, one-off CoT
prefix injection, and chain extraction.

Port of ``lapha_tpu/search/mcts.py``, unchanged but for its imports: the
engine (the port's ``engine.Engine``) prefills each parent prompt once and
fans out breadth samples from shared KV; the value forward is one bucketed
call (``search/value_fn.py``), or a matvec on the engine-pooled hidden
(``from_pooled``). The tree itself stays host-side — it is irreducibly
sequential bookkeeping (SURVEY.md §7.3).
"""

from __future__ import annotations

import abc
import copy
import heapq
import math
import os
import random
import re
from typing import Any, Callable, ClassVar, Optional

import numpy as np

from .node import Node
from .tool_parse import parse_tool_calls
from .cluster import cluster_and_select_disabled

_ANSWER_RE = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)
_STEP_HDR_RE = re.compile(r"^STEP-\d+:\r?\n<think>\r?\n?")
_THINK_RE = re.compile(r"<think>(.*?)</think>", re.DOTALL)


def dump_step(step: dict, logfile: str) -> str:
    """Plain-text panel dump of one expansion (reference dump_with_rich,
    agent.py:37-53; rich markup is optional noise — keep greppable text)."""
    try:
        os.makedirs(os.path.dirname(logfile), exist_ok=True)
        parts = []
        for title, key in (("STATE VALUE", "state_value"), ("PROMPT", "prompt"),
                           ("COMPLETION", "completion"), ("GROUND TRUTH", "ground_truth")):
            parts.append(f"==== {title} ====\n{step.get(key)}\n")
        ids = step.get("completion_ids", []) or []
        pids = step.get("prompt_ids", []) or []
        parts.insert(1, f"==== CONTEXT LENGTH ====\n{len(ids) + len(pids)}\n")
        with open(logfile, "w", encoding="utf-8") as f:
            f.write("\n".join(parts))
    except Exception:
        pass
    return logfile


class MCTSAgent(abc.ABC):
    """Subclass with prompt templates + tools (run CLI defines Poor/Coder)."""

    SYSTEM_TEMPLATE: ClassVar[str]
    USER_TEMPLATE: ClassVar[str]
    TOOLS: ClassVar[dict[str, Callable]] = {}
    TOOLS_DESCRIPTION: ClassVar[Any] = ""

    def __init__(
        self,
        tokenizer,
        depth: int,
        breadth: int,
        output_dir: str,
        llm,
        max_model_len: int,
        sampling_params,
        value_fn,
        reward_fns: list | None = None,
        c_puct: float = 1.0,
        v_prior: float = 0.5,
        value_trust: float = 0.5,
        num_sim: int = 128,
        prune_per: int = 129,
        max_expands: int | str = 2,
        num_pos_sim: int = 4,
        passk_threshold: float = 1.0,
        leaves_per_sim: int = 1,
        hid_bank=None,
        rng: random.Random | None = None,
        dump_expansions: bool = False,
    ):
        self.tokenizer = tokenizer
        self.depth = int(depth)
        self.breadth = int(breadth)
        self.output_dir = output_dir
        self.llm = llm
        self.max_model_len = int(max_model_len or 0)
        self.sampling_params = sampling_params
        self.value_fn = value_fn
        self.reward_fns = reward_fns or []
        self.c_puct = float(c_puct)
        self.v_prior = float(v_prior)
        self.value_trust = float(value_trust)
        self.num_sim = int(num_sim)
        self.prune_per = int(prune_per)
        self.max_expands = max_expands
        self.num_pos_sim = int(num_pos_sim)
        self.passk_threshold = float(passk_threshold)
        self.leaves_per_sim = max(1, int(leaves_per_sim))
        self.hid_bank = hid_bank
        self.rng = rng or random.Random()
        self.dump_expansions = bool(dump_expansions)

        self._all_nodes: list[Node] = []
        self._next_cluster_id = 0
        self._cluster_centers: dict[int, np.ndarray] = {}
        self.root_h0: np.ndarray | None = None
        self.pos_counter = 0
        self._root_step: dict | None = None

    # ------------------------------------------------------------- frontier

    def _global_score(self, node: Node, expand_total: int) -> float:
        q_eff = float(node.Q if node.N > 0 else (node.state_value or 0.0))
        return q_eff + self.c_puct * node.P * math.sqrt(expand_total + 1) / (1.0 + node.N)

    def _can_expand(self, node: Node) -> bool:
        if node.is_terminal or node.disabled:
            return False
        if isinstance(self.max_expands, int):
            return node.expand_calls < self.max_expands
        if self.max_expands == "decay":
            return node.expand_calls < max(1, self.depth - node.depth**2 + 1)
        return True

    def _push(self, heap: list, node: Node, expand_total: int) -> None:
        if self._can_expand(node):
            heapq.heappush(heap, (-self._global_score(node, expand_total), id(node), node))

    def _pop_batch(self, heap: list, k: int) -> list[Node]:
        batch: list[Node] = []
        seen: set[int] = set()
        while heap and len(batch) < max(1, k):
            _, nid, node = heapq.heappop(heap)
            if nid in seen or not self._can_expand(node):
                continue
            seen.add(nid)
            batch.append(node)
        return batch

    # ------------------------------------------------------------- support material

    def read_support_material(self, table_paths):
        from .support import read_support_material

        return read_support_material(table_paths)

    # ------------------------------------------------------------- CoT prefix

    def _cot_prefix(self, cot: str | None) -> str | None:
        """First half of the CoT's <think> body (token-capped), used as a
        one-off prefill (reference agent.py:319-382)."""
        if not cot:
            return None
        try:
            m = _THINK_RE.search(str(cot))
            if not m or not m.group(1):
                return None
            ids = self.tokenizer(m.group(1), add_special_tokens=False)["input_ids"]
            if not ids:
                return None
            half = max(1, len(ids) // 2)
            cap = getattr(self.sampling_params, "max_tokens", None)
            take = half if cap is None else min(int(cap) // 2, half)
            if take <= 0:
                return None
            return self.tokenizer.decode(ids[:take], skip_special_tokens=True)
        except Exception:
            return None

    # ------------------------------------------------------------- search

    def search(
        self,
        question: str,
        support_material_path: Optional[list[str]] = None,
        ground_truth: Optional[str] = None,
        cot: Optional[str] = None,
    ) -> list[list[dict[str, Any]]]:
        # fresh per-search state: the reference accumulates _all_nodes across
        # search() calls when one agent serves many questions (eval value
        # mode), so pruning clusters the current tree together with stale
        # nodes from earlier questions — a quirk we deliberately fix
        # (PARITY.md deviations).
        self._all_nodes = []
        self._next_cluster_id = 0
        self._cluster_centers = {}
        self.pos_counter = 0

        material, material_str = self.read_support_material(support_material_path)
        material_str = f"# Given this:\n{material_str}" if material_str else ""

        system_prompt = self.SYSTEM_TEMPLATE.format(step_limit=self.depth)
        user_prompt = self.USER_TEMPLATE.format(
            support_material_str=material_str, question=question
        )
        root_msgs = [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": user_prompt},
        ]
        prompt = self._render_chat(root_msgs)
        prompt_ids = list(self.tokenizer(prompt, add_special_tokens=True)["input_ids"])

        root_step = {
            "prompt": prompt,
            "prompt_ids": prompt_ids,
            "ground_truth": ground_truth,
            "completion": "",
            "completion_ids": [],
            "hostaged": False,
            "state_value": None,
            "current_depth": 0,
            "system_prompt": system_prompt,
            "user_prompt": user_prompt,
        }
        root = Node(None, 1.0, root_step, root_msgs, copy.deepcopy(material), 0)

        # root eval: v_pred + cached root_h0; bank stores y_root = 0
        ids = np.asarray(prompt_ids, np.int64)[None, :]
        if self.max_model_len and ids.shape[1] > self.max_model_len:
            ids = ids[:, -self.max_model_len:]
        attn = np.ones_like(ids)
        y_root, v_root, h0_root = self.value_fn(
            input_ids=ids, attention_mask=attn,
            response_mask=attn, prompt_mask=attn,
            root_h0=None, return_h0=True,
        )
        vp = float(np.asarray(v_root).reshape(-1)[0])
        root.step["v_pred"] = vp
        root.v_pred = vp
        sv = self.value_trust * vp + (1.0 - self.value_trust) * self.v_prior
        root.step["state_value"] = sv
        root.state_value = sv
        self.root_h0 = np.asarray(h0_root, np.float32).reshape(-1)
        root.step["root_h0"] = self.root_h0

        y_zero = np.zeros_like(np.asarray(y_root).reshape(-1))
        root.step["hid_idx"] = self.hid_bank.add(y_zero) if self.hid_bank is not None else None
        root.hid_idx = root.step["hid_idx"]
        root.step["hid"] = y_zero.astype(np.float16).tolist()
        root.hid = root.step["hid"]
        self._root_step = root.step

        cot_prefix = self._cot_prefix(cot)
        cot_used = False

        expand_total = 0
        frontier: list = []
        self._push(frontier, root, expand_total)

        total_rounds = max(1, self.num_sim // self.leaves_per_sim)
        half_round = total_rounds // 2
        self.pos_counter = 0

        for sim_i in range(total_rounds):
            if self.pos_counter >= self.num_pos_sim:
                break

            inject_cot = None
            if cot_prefix and not cot_used and sim_i >= half_round and self.pos_counter == 0:
                inject_cot = cot_prefix
                cot_used = True

            leaves = self._pop_batch(frontier, self.leaves_per_sim)
            if not leaves:
                break

            creations = self._expand_and_evaluate(
                leaves, ground_truth, self.breadth, cot_prefix=inject_cot
            )
            expand_total += len(leaves)

            for parent, kids in creations:
                for ch in kids:
                    if ch.is_terminal:
                        ch.backup(float(ch.state_value or 0.0))
                self._push(frontier, parent, expand_total)
                for ch in kids:
                    self._push(frontier, ch, expand_total)

            if self.prune_per and (sim_i + 1) % self.prune_per == 0:
                self.cluster_and_prune()
                frontier = []
                stack, seen = [root], set()
                while stack:
                    cur = stack.pop()
                    if id(cur) in seen:
                        continue
                    seen.add(id(cur))
                    self._push(frontier, cur, expand_total)
                    stack.extend(ch for ch in cur.children if not ch.disabled)

        return self._extract_chains(root)

    def _extract_chains(self, root: Node) -> list[list[dict[str, Any]]]:
        chains: list[list[dict[str, Any]]] = []

        def dfs(n: Node, chain: list[dict[str, Any]]):
            if n.parent is not None:
                n.step["_N"] = int(n.N)
                n.step["_Q"] = float(n.Q)
                n.step["_P"] = float(n.P)
                n.step["_depth"] = int(n.depth)
                n.step["_terminal"] = bool(n.is_terminal)
                n.step["_disabled"] = bool(n.disabled)
                chain = chain + [n.step]
            if not n.children:
                chains.append(chain)
            else:
                for ch in n.children:
                    dfs(ch, chain)

        dfs(root, [])
        return chains

    # ------------------------------------------------------------- expansion

    def _render_chat(self, messages: list[dict]) -> str:
        return self.tokenizer.apply_chat_template(
            conversation=messages,
            tools=self.TOOLS_DESCRIPTION or None,
            tokenize=False,
            add_generation_prompt=True,
        )

    def _expand_and_evaluate(
        self,
        leaves: list[Node],
        ground_truth,
        breadth: int,
        *,
        cot_prefix: Optional[str] = None,
    ) -> list[tuple[Node, list[Node]]]:
        parents = [n for n in leaves if self._can_expand(n)]
        if not parents:
            return []

        # 1) prompts: chat prefix + step header + injected prefill
        # (mutually-exclusive injection modes, reference agent.py:816-830:
        # a hostaged parent prefills "wait"; otherwise an unused CoT prefix)
        prompts, prompt_ids_list, headers, injects, modes = [], [], [], [], []
        for node in parents:
            node.expand_calls += 1
            node.step["expand_calls"] = node.expand_calls
            depth = int(node.step.get("current_depth", 0)) + 1
            header = f"STEP-{depth}:\n<think>\n"
            if node.step.get("hostaged", False):
                inject, mode = "wait", "wait"
            elif cot_prefix:
                inject, mode = cot_prefix, "cot"
            else:
                inject, mode = "", "none"
            ptext = self._render_chat(node.messages) + header + inject
            prompts.append(ptext)
            prompt_ids_list.append(list(self.tokenizer(ptext, add_special_tokens=True)["input_ids"]))
            headers.append(header)
            injects.append(inject)
            modes.append(mode)

        # 2) one engine call, n=breadth per prompt
        self.sampling_params.n = int(breadth)
        responses = self.llm.generate(prompts=prompts, sampling_params=self.sampling_params, use_tqdm=False)

        # 3) parse children
        specs = []  # (parent_i, k, step, messages, context, terminal)
        priors_by_parent: list[list[float]] = []
        for pi, resp in enumerate(responses):
            outs = resp.outputs
            cums = [float(o.cumulative_logprob) for o in outs]
            if cums:
                m = max(cums)
                exps = [math.exp(c - m) for c in cums]
                z = sum(exps)
                priors = [e / z for e in exps] if z > 0 else [1.0 / len(exps)] * len(exps)
            else:
                priors = []
            priors_by_parent.append(priors)

            parent = parents[pi]
            for k, o in enumerate(outs):
                spec = self._build_child_spec(
                    parent, o, prompts[pi], prompt_ids_list[pi], headers[pi], injects[pi],
                    ground_truth, inject_mode=modes[pi],
                )
                if self.dump_expansions:
                    dump_step(spec[0], os.path.join(self.output_dir, f"tmp{pi}-{k}.txt"))
                specs.append((pi, k) + spec)

        # 4) one batched value forward for ALL children
        rows = []
        kept = []
        pad_id = int(getattr(self.tokenizer, "pad_token_id", 0) or 0)
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        for (pi, k, step, msgs, ctx, terminal) in specs:
            p_ids = np.asarray(step["prompt_ids"], np.int64)
            c_ids = np.asarray(step["completion_ids"], np.int64)
            if c_ids.size == 0:
                step["disabled"] = True
                step["error"] = "empty completion_ids"
                continue
            c_mask = np.ones_like(c_ids)
            if eos_id is not None:
                hits = np.where(c_ids == int(eos_id))[0]
                if hits.size:
                    c_mask[hits[0] + 1:] = 0  # keep eos, drop after
            full = np.concatenate([p_ids, c_ids])
            rmask = np.concatenate([np.zeros_like(p_ids), c_mask])
            pmask = np.concatenate([np.ones_like(p_ids), np.zeros_like(c_ids)])
            if self.max_model_len and full.size > self.max_model_len:
                full, rmask, pmask = (a[-self.max_model_len:] for a in (full, rmask, pmask))
            if rmask.sum() <= 0:
                rmask = np.ones_like(full)
            rows.append((full, rmask, pmask))
            kept.append((pi, k, step, msgs, ctx, terminal))

        if not rows:
            return [(p, []) for p in parents]

        L = max(r[0].size for r in rows)
        B = len(rows)
        ids2d = np.full((B, L), pad_id, np.int64)
        attn2d = np.zeros((B, L), np.int64)
        resp2d = np.zeros((B, L), np.int64)
        pm2d = np.zeros((B, L), np.int64)
        for i, (full, rmask, pmask) in enumerate(rows):
            n = full.size
            ids2d[i, :n] = full
            attn2d[i, :n] = 1
            resp2d[i, :n] = rmask
            pm2d[i, :n] = pmask

        # fused path: the engine already pooled each sample's final hidden
        # during generation (collect_h0) — value scoring is then a matvec
        pooled = [step.get("_pooled_hidden") for (_pi, _k, step, *_rest) in kept]
        if all(p_ is not None for p_ in pooled) and hasattr(self.value_fn, "from_pooled"):
            y_batch, v_batch = self.value_fn.from_pooled(
                np.stack([np.asarray(p_, np.float32) for p_ in pooled]),
                root_h0=self.root_h0)
        else:
            y_batch, v_batch = self.value_fn(
                input_ids=ids2d, attention_mask=attn2d,
                response_mask=resp2d, prompt_mask=pm2d,
                root_h0=self.root_h0, return_h0=False,
            )

        # 5) materialize children
        created: dict[int, list[Node]] = {i: [] for i in range(len(parents))}
        for row, (pi, k, step, msgs, ctx, terminal) in enumerate(kept):
            v_pred = float(np.asarray(v_batch).reshape(-1)[row])
            priors = priors_by_parent[pi]
            p_prior = float(priors[k]) if priors else 1.0 / max(1, breadth)
            step["p_prior"] = p_prior

            true_r = max((f(step["completion"], ground_truth) for f in self.reward_fns), default=0.0)
            step["_true_reward"] = float(true_r)  # reused by reward shaping
            if self.num_pos_sim < self.num_sim and true_r >= self.passk_threshold:
                self.pos_counter += 1

            if terminal:
                state_value = float(true_r)
            else:
                state_value = self.value_trust * v_pred + (1.0 - self.value_trust) * self.v_prior

            step["v_pred"] = v_pred
            step["state_value"] = state_value
            y_row = np.asarray(y_batch)[row]
            step["hid_idx"] = self.hid_bank.add(y_row) if self.hid_bank is not None else None
            step["hid"] = y_row.astype(np.float16).tolist()
            step["disabled"] = False

            child = Node(parents[pi], p_prior, step, msgs, ctx, step["current_depth"])
            child.is_terminal = bool(terminal)
            child.v_pred = v_pred
            child.state_value = state_value
            parents[pi].children.append(child)
            self._all_nodes.append(child)
            created[pi].append(child)

        return [(parents[i], created.get(i, [])) for i in range(len(parents))]

    def _build_child_spec(self, parent, output, prompt, prompt_ids, header, inject,
                          ground_truth, inject_mode: str = "none"):
        """One generated sample -> (step, messages, context, terminal)."""
        gen_ids = list(output.token_ids)
        gen_text = self.tokenizer.decode(gen_ids, skip_special_tokens=True)
        body = (inject + gen_text) if inject else gen_text
        completion = header + body
        completion_ids = gen_ids
        terminal = bool(_ANSWER_RE.search(completion))

        current_depth = int(parent.step["current_depth"]) + 1

        # echo detection: body text or a tool-call block already in the prompt
        hdr_m = _STEP_HDR_RE.match(completion)
        body_nohdr = completion[hdr_m.end():].strip() if hdr_m else completion.strip()
        is_echo = bool(body_nohdr) and body_nohdr in prompt
        for blk in re.findall(r"<tool_call>.*?</tool_call>", completion, flags=re.S):
            if blk.strip() and blk.strip() in prompt:
                is_echo = True
        if current_depth >= self.depth or is_echo:
            terminal = True

        # hostage: an <answer> emitted without terminating is held hostage —
        # strip the answer and mark the node so its NEXT expansion prefills
        # "wait" (reference agent.py:929-941; dormant there too because
        # <answer> always terminates above).
        hostaged = False
        if not terminal and _ANSWER_RE.search(completion):
            hostaged = True
            completion = completion.split("<answer>")[0]
            completion_ids = list(self.tokenizer(
                completion + "<|im_end|>", add_special_tokens=True)["input_ids"])

        if self.max_model_len and len(prompt_ids) + len(completion_ids) >= self.max_model_len:
            terminal = True

        # the live hostage producer: children born from a CoT-injection round
        # carry teacher-forced text, so their next expansion is prefilled with
        # "wait" to force reflection (consumes the flag at agent.py:817-825).
        if inject_mode == "cot" and not terminal:
            hostaged = True

        # tool execution
        results: list[dict] = []
        new_context = dict(parent.context)
        try:
            assistant_msg = parse_tool_calls(completion)
        except Exception:
            assistant_msg = {"role": "assistant", "content": completion}
            tool_response = [{"role": "user",
                              "content": "Error: can not parse your <tool_call></tool_call> block."}]
        else:
            tool_response = []
            kept_calls = []
            for call in assistant_msg.get("tool_calls", []) or []:
                fn = call.get("function") or {}
                name = fn.get("name")
                args = fn.get("arguments", {})
                if not name:
                    tool_response.append({"role": "user", "content": f"Error: tool name missing for '<tool_call>{fn}</tool_call>'."})
                    continue
                func = self.TOOLS.get(name)
                if func is None:
                    tool_response.append({"role": "user", "content": f"Error: no such a tool named '{name}'."})
                    continue
                if isinstance(args, str):
                    try:
                        import json as _json
                        args = _json.loads(args)
                    except Exception:
                        tool_response.append({"role": "user", "content": f"Error: tool arguments must be JSON object. Got string: {str(args)[:200]}..."})
                        continue
                if not isinstance(args, dict):
                    tool_response.append({"role": "user", "content": f"Error: tool arguments must be an object/dict, got {type(args).__name__}."})
                    continue
                try:
                    out, new_ctx = func(context=new_context, **args)
                except Exception as e:
                    tool_response.append({"role": "tool", "name": name,
                                          "content": f"Var: e; Type: {type(e).__name__}\n{e}"})
                    continue
                new_context.update(new_ctx)
                results.append(new_ctx)
                tool_response.append({"role": "tool", "name": name, "content": out})
                kept_calls.append(call)
            assistant_msg["tool_calls"] = kept_calls

        messages = parent.messages + [assistant_msg] + tool_response

        step = {
            "prompt": prompt,
            "prompt_ids": prompt_ids,
            "completion": completion,
            "completion_ids": completion_ids,
            "ground_truth": ground_truth,
            "results": results,
            "current_depth": current_depth,
            "hostaged": hostaged,
            "cum_logprob": float(output.cumulative_logprob),
            "state_value": None,
        }
        ph = getattr(output, "pooled_hidden", None)
        if ph is not None:
            step["_pooled_hidden"] = ph
        return (step, messages, new_context, terminal)

    # ------------------------------------------------------------- pruning

    def cluster_and_prune(self) -> None:
        nodes = [n for n in self._all_nodes if n.hid is not None and not n.disabled]
        if len(nodes) <= 1:
            if len(nodes) == 1 and nodes[0].cluster_id is None:
                cid = self._next_cluster_id
                nodes[0].cluster_id = cid
                nodes[0].step["cluster_id"] = cid
                self._cluster_centers[cid] = np.asarray(nodes[0].hid, np.float32)
                self._next_cluster_id += 1
            return

        Z = np.stack([np.asarray(n.hid, np.float32) for n in nodes])
        labels, centers, disabled = cluster_and_select_disabled(Z, self.rng)
        base = self._next_cluster_id
        self._cluster_centers = {base + int(l): c for l, c in centers.items()}
        for i, n in enumerate(nodes):
            cid = base + int(labels[i])
            n.cluster_id = cid
            n.step["cluster_id"] = cid
            n.disabled = bool(disabled[i])
            n.step["disabled"] = bool(disabled[i])
        self._next_cluster_id = base + int(labels.max()) + 1
