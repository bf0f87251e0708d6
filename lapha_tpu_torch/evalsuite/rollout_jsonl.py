"""Rollout CLI: react / value / single modes (reference-compatible).

Flag + JSONL-contract parity with the reference implementation's eval/rollout_jsonl.py
(flags 1038-1089; output rows 1323-1338 with
dataset/qid/question/completion/final_answer/completions/final_answers/k;
first-row str sanity check 1314-1321).

Port of ``lapha_tpu/evalsuite/rollout_jsonl.py``: the same flags, agents and
rows. The engine is the port's ("tpu"; "vllm" accepted; "jet", block
diffusion, with the SDAR knobs from the environment), plus "fake" for
hermetic tests; value mode
wires the port's ValueFunction + LatentBank + MCTS from
``lapha_tpu_torch.search``. One flag is new, ``--device`` (default "cuda":
without a card it raises, as the loaders do; "cpu" runs on the CPU).
``--value-device`` keeps its flag: "tpu" and "auto" mean the card, and a
value device other than the engine's raises (the value model shares it).
"""

from __future__ import annotations

import argparse
import copy
import gc
import hashlib
import json
import os
import re
import traceback
import unicodedata
from typing import Any, ClassVar, Dict, List, Optional

from ..search import LatentBank, MCTSAgent, parse_tool_calls, pick_top_leaves
from ..tools import description, execute_python_code
from .adapters import GenParams, build_engine_adapter

_ANS_TAG = re.compile(r"<answer>(.*?)</answer>", re.DOTALL | re.IGNORECASE)
_BOXED = re.compile(r"\\boxed\{([^}]*)\}")
_FINAL = re.compile(r"(?:^|\n)\s*(?:Final\s*Answer|Answer)\s*[:：]\s*(.+)", re.IGNORECASE)


def _qid(question: str) -> str:
    qn = unicodedata.normalize("NFKC", question).encode("utf-8")
    return hashlib.sha1(qn).hexdigest()[:10]


def _norm(s: str) -> str:
    return unicodedata.normalize("NFKC", s or "").strip().strip("$")


def _extract_answer(text: str, aime_hint: bool = False) -> str:
    """<answer> > \\boxed > Final Answer > (aime: last small int) > last number."""
    if not text:
        return ""
    m = _ANS_TAG.search(text)
    if m:
        return _norm(m.group(1))
    m = _BOXED.search(text)
    if m:
        return _norm(m.group(1))
    m = _FINAL.search(text)
    if m:
        return _norm(re.split(r"[\n。]", m.group(1).strip())[0])
    if aime_hint:
        ints = re.findall(r"(?<!\d)(\d{1,3})(?!\d)", text)
        if ints:
            return ints[-1].lstrip("0") or "0"
    nums = re.findall(r"[-+]?\d+(?:/\d+)?|\d*\.\d+|\\sqrt\{[^}]+\}", text)
    return _norm(nums[-1]) if nums else ""


def _build_reward_fns(dataset_name: str):
    from .eval_math import build_judge_adapter
    from .rewards import REWARD_FUNCS, LLMJudge, with_llm_judge

    reward_primary = REWARD_FUNCS.get(dataset_name)
    if reward_primary is None:
        return []
    if os.getenv("USE_LLM_JUDGE", "0") in ("1", "true", "True"):
        from transformers import AutoTokenizer

        jt = AutoTokenizer.from_pretrained(os.environ["JUDGE_TOKENIZER_PATH"],
                                           trust_remote_code=True, use_fast=True)
        judge = LLMJudge(jt, build_judge_adapter(jt))
        return [with_llm_judge(reward_primary, judge.score)]
    return [lambda c, a: float(reward_primary(c, a))]


# --------------------------------------------------------------------- ReAct

class ReActAgent:
    """Depth-limited ReAct loop (breadth forced to 1 in react mode)."""

    SYSTEM_TEMPLATE: ClassVar[str]
    USER_TEMPLATE: ClassVar[str]
    TOOLS: ClassVar[Dict[str, Any]] = {}
    TOOLS_DESCRIPTION: ClassVar[Any] = None

    def __init__(self, tokenizer, depth, breadth, output_dir, llm, sampling_params,
                 max_model_len: Optional[int] = None):
        self.tokenizer = tokenizer
        self.depth = depth
        self.breadth = breadth
        self.output_dir = output_dir
        self.llm = llm
        self.sampling_params = sampling_params
        self.max_model_len = max_model_len

    def _generate_batch(self, messages: List[dict], ground_truth: str, n_variants: int) -> List[dict]:
        prompt = self.tokenizer.apply_chat_template(
            conversation=messages, tools=self.TOOLS_DESCRIPTION,
            tokenize=False, add_generation_prompt=True,
        )
        prompt_ids = list(self.tokenizer(prompt, add_special_tokens=True)["input_ids"])

        # early stop: over-long context never reaches the engine
        if self.max_model_len is not None and len(prompt_ids) > self.max_model_len:
            stub = ("<think>Context length exceeded max_model_len; stopping generation."
                    "</think><answer></answer>")
            return [{"prompt": prompt, "completion": stub, "prompt_ids": prompt_ids,
                     "completion_ids": [], "ground_truth": ground_truth, "reward": None}
                    for _ in range(n_variants)]

        outs = self.llm.generate(prompts=[prompt] * n_variants,
                                 sampling_params=self.sampling_params, use_tqdm=False)
        results = []
        for out in outs:
            token_ids = list(out.outputs[0].token_ids)
            completion = self.tokenizer.decode(token_ids, skip_special_tokens=False)
            completion = completion.replace("<|im_end|>", "")
            results.append({"prompt": prompt, "completion": completion,
                            "prompt_ids": prompt_ids, "completion_ids": token_ids,
                            "ground_truth": ground_truth, "reward": None})
        return results

    def read_support_material(self, table_paths):
        from ..search.support import read_support_material

        return read_support_material(table_paths)

    def react_recursive(self, question, support_material_path=None, ground_truth=None,
                        assistant_and_tool_msg=None, current_chain=None,
                        current_depth=1, previous_variables=None):
        previous_variables = dict(previous_variables or {})
        material, material_str = self.read_support_material(support_material_path)
        assistant_and_tool_msg = copy.deepcopy(assistant_and_tool_msg) if assistant_and_tool_msg else []
        current_chain = current_chain or []

        material_str = f"# Given this:\n{material_str}" if material_str else ""
        msgs = [
            {"role": "system", "content": self.SYSTEM_TEMPLATE},
            {"role": "user", "content": self.USER_TEMPLATE.format(
                support_material_str=material_str, question=question)},
        ]
        responses = self._generate_batch(msgs + assistant_and_tool_msg,
                                         ground_truth or "", self.breadth)

        all_chains: List[List[dict]] = []
        for resp in responses:
            resp["current_depth"] = current_depth
            local_msgs = copy.deepcopy(assistant_and_tool_msg)
            local_chain = current_chain.copy()
            resp["results"] = []

            try:
                prior = [m.get("content", "") for m in assistant_and_tool_msg]
                if "<answer>" in resp["completion"] or resp["completion"] in prior:
                    local_chain.append(resp)
                    all_chains.append(local_chain)
                    continue
                try:
                    assistant_msg = parse_tool_calls(resp["completion"])
                except Exception as e:
                    assistant_msg = {"role": "assistant", "content": resp["completion"]}
                    resp["results"].append({"parse_error": str(e)})
                    local_msgs.append({"role": "tool", "name": "none",
                                       "content": f"Parse error: {type(e).__name__}: {e}"})
                local_msgs.append(assistant_msg)

                tool_calls = assistant_msg.get("tool_calls", [])
                if tool_calls:
                    for call in tool_calls:
                        name = call["function"]["name"]
                        args = call["function"]["arguments"] or {}
                        if name not in self.TOOLS:
                            raise ValueError(f"Unknown tool: {name}")
                        context = {**previous_variables, **material}
                        try:
                            out_str, new_ctx = self.TOOLS[name](**args, context=context)
                        except Exception:
                            out_str, new_ctx = f"Tool execution error:\n{traceback.format_exc()}", context
                        local_msgs.append({"role": "tool", "name": name, "content": out_str})
                        previous_variables = {k: v for k, v in new_ctx.items() if k not in material}
                else:
                    local_msgs.append({"role": "user", "content": "Please continue."})
            except Exception:
                resp["results"].append({"error": traceback.format_exc()})
                local_msgs.append({"role": "tool", "name": "none", "content": traceback.format_exc()})

            local_chain.append(resp)
            if current_depth + 1 <= self.depth:
                all_chains.extend(self.react_recursive(
                    question=question, support_material_path=support_material_path,
                    ground_truth=ground_truth, assistant_and_tool_msg=local_msgs,
                    current_chain=local_chain, current_depth=current_depth + 1,
                    previous_variables=previous_variables))
            else:
                all_chains.append(local_chain)

        gc.collect()
        return all_chains


class CoderAgent(ReActAgent):
    TOOLS = {"execute_python_code": execute_python_code}
    TOOLS_DESCRIPTION = description
    SYSTEM_TEMPLATE = """\
SOLVE THE PROBLEM STEP-BY-STEP. PRESENT THE ANSWER TO EXIT THE LOOP.

# Guidelines
→ Each assistant response must contain exactly one "<think>...</think>" block.
  · If the final answer is ready, use "<answer>...</answer>" block to terminate the loop.
  · No content other than whitespace may appear outside these tags.
→ Begin every response with "STEP-(\\d+):\\n<think>...", 1 step per response."""
    USER_TEMPLATE = """\
{support_material_str}
# Please answer:
{question}
👆
format the FINAL answer as `<answer>...</answer>`"""


class PoorAgent(ReActAgent):
    """Single-turn non-agent prompt (no tools, no STEP prefix)."""

    TOOLS = {}
    TOOLS_DESCRIPTION = None
    SYSTEM_TEMPLATE = """\
You are NOT an agent. Answer in ONE message.
Rules:
  - Produce exactly one "<think>...</think>" block.
  - Then produce one "<answer>...</answer>" block with the final answer only.
  - Do not use tools. Do not include any "STEP-" prefixes. Stop after the final answer."""
    USER_TEMPLATE = """\
{support_material_str}
# Please answer (single-turn):
{question}
👆
format the FINAL answer as `<answer>...</answer>`"""

    def react_recursive(self, question: str, **kwargs):
        msgs = [
            {"role": "system", "content": self.SYSTEM_TEMPLATE},
            {"role": "user", "content": self.USER_TEMPLATE.format(
                support_material_str="", question=question)},
        ]
        resp = self._generate_batch(msgs, kwargs.get("ground_truth", "") or "", 1)[0]
        return [[resp]]


class MCoderAgent(MCTSAgent):
    TOOLS = {"execute_python_code": execute_python_code}
    TOOLS_DESCRIPTION = description
    SYSTEM_TEMPLATE = """\
SOLVE THE PROBLEM STEP-BY-STEP. PRESENT THE ANSWER TO EXIT THE LOOP.

# Guidelines
→ Each assistant response must contain exactly one "<think>...</think>" block.
  · If the final answer is ready, use "<answer>...</answer>" block to terminate the loop.
  · No content other than whitespace may appear outside these tags.
→ Finish your REACTION within {step_limit} step(s).
→ Begin every response with "STEP-(\\d+):\\n<think>...", 1 step per response."""
    USER_TEMPLATE = """\
{support_material_str}
# Please answer:
{question}
"""


# --------------------------------------------------------------------- value fn

def build_value_fn(base_lm_path: str, value_head_path: Optional[str], *,
                   max_model_len: int = 4096, device="cuda"):
    """Load base LM + head on ``device`` into the bucketed ValueFunction
    (HFValueFunction equivalent, rollout_jsonl.py:719-1015). Without a head
    file the head is drawn from ``torch.Generator(device).manual_seed(0)``,
    a stream other than the JAX package's ``jax.random.key(0)``."""
    import torch

    from ..models import loader, value_model
    from ..search.value_fn import ValueFunction

    params, cfg = loader.load_params(base_lm_path, device=device)
    if value_head_path:
        head = loader.load_value_head(value_head_path, cfg.hidden_size, device=device)
    else:
        head = value_model.init_value_head(cfg.hidden_size,
                                           torch.Generator(device).manual_seed(0))
    return ValueFunction(params, head, cfg, max_model_len=max_model_len), params, cfg


# --------------------------------------------------------------------- main

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Roll out predictions (pass@1) with ReAct or MCTS.")
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--dataset-name", required=True)
    ap.add_argument("--mode", choices=["react", "value", "single"], default="react")
    ap.add_argument("--tokenizer-path", required=True)
    ap.add_argument("--engine", choices=["vllm", "jet", "tpu", "fake"], default="tpu")
    ap.add_argument("--base-url", default="")
    ap.add_argument("--tensor-parallel-size", type=int, default=int(os.getenv("JET_TP_SIZE", "1")))
    ap.add_argument("--max-new-tokens", type=int, default=1024)
    ap.add_argument("--temperature", type=float, default=0.2)
    ap.add_argument("--top-p", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--repetition-penalty", type=float, default=1.05)
    ap.add_argument("--min-p", type=float, default=0.0)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--breadth", type=int, default=6)
    ap.add_argument("--k", "--rollout-k", dest="rollout_k", type=int, default=1)
    ap.add_argument("--value-base", default=None)
    ap.add_argument("--value-head", default=None)
    ap.add_argument("--value-model", default=None)
    ap.add_argument("--value-device", default="tpu",
                    help='"tpu" or "auto": the card; must be the engine\'s --device')
    ap.add_argument("--value-dtype", default="auto")
    ap.add_argument("--max-model-len", type=int, default=10240)
    ap.add_argument("--mcts-c-puct", type=float, default=1.0)
    ap.add_argument("--mcts-v-prior", type=float, default=0.5)
    ap.add_argument("--mcts-value-trust", type=float, default=0.5)
    ap.add_argument("--mcts-num-sim", type=int, default=64)
    ap.add_argument("--mcts-prune-per", type=int, default=128)
    ap.add_argument("--mcts-max-expands", default=2)
    ap.add_argument("--mcts-num-pos-sim", type=int, default=4)
    ap.add_argument("--mcts-passk-threshold", type=float, default=1.0)
    ap.add_argument("--mcts-leaves-per-sim", type=int,
                    default=int(os.getenv("MCTS_LEAVES_PER_SIM", "1")))
    ap.add_argument("--limit", type=int, default=None)
    # native-engine extras (not in the reference CLI)
    ap.add_argument("--max-batch", type=int, default=int(os.getenv("TPU_MAX_BATCH", "16")))
    ap.add_argument("--seed", type=int, default=0)
    # net-new serving levers (engine/engine.py; env-overridable): int8 KV
    # cache and prompt-lookup speculative decoding
    ap.add_argument("--kv-quant", choices=["int8"],
                    default=os.getenv("TPU_KV_QUANT") or None)
    ap.add_argument("--spec-decode", choices=["pld"],
                    default=os.getenv("TPU_SPEC_DECODE") or None)
    ap.add_argument("--spec-k", type=int, default=int(os.getenv("TPU_SPEC_K", "3")))
    # the port's device: the card unless the CPU is asked for
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def main(argv=None, *, engine_override=None, value_fn_override=None, tokenizer_override=None):
    import torch

    from ..models.loader import _device

    args = build_parser().parse_args(argv)
    device = _device(args.device, "rollout_jsonl (--device)")
    if args.tensor_parallel_size > 1:
        raise ValueError(f"--tensor-parallel-size {args.tensor_parallel_size}: the port runs "
                         "on one device; multi-device serving is ROADMAP A11")

    if tokenizer_override is not None:
        tokenizer = tokenizer_override
    else:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer_path,
                                                  trust_remote_code=True, use_fast=True)
        if tokenizer.pad_token is None:
            tokenizer.pad_token = tokenizer.eos_token

    sampling = GenParams(
        temperature=args.temperature, top_p=args.top_p, top_k=args.top_k,
        min_p=args.min_p, repetition_penalty=args.repetition_penalty,
        max_tokens=args.max_new_tokens, seed=args.seed or None,
        remasking_strategy=os.getenv("SDAR_REMASKING_STRATEGY", "low_confidence_dynamic"),
        block_length=int(os.getenv("SDAR_BLOCK_LENGTH", "4")),
        denoising_steps=int(os.getenv("SDAR_DENOISING_STEPS", "4")),
        dynamic_threshold=float(os.getenv("SDAR_DYNAMIC_THRESHOLD", "0.9")),
    )

    if engine_override is not None:
        llm = engine_override
    else:
        engine_kw = dict(
            model_path=os.getenv("JET_MODEL_PATH", args.tokenizer_path),
            max_model_len=int(args.max_model_len),
            max_batch=max(int(args.max_batch),
                          int(args.breadth) * max(1, int(args.mcts_leaves_per_sim))),
        )
        if args.mode == "value":
            engine_kw["collect_h0"] = True  # fused value scoring
        if args.kv_quant:
            engine_kw["kv_quant"] = args.kv_quant
        if args.spec_decode:
            engine_kw["spec_decode"] = args.spec_decode
            engine_kw["spec_k"] = int(args.spec_k)
        llm = build_engine_adapter(args.engine, tokenizer=tokenizer, device=device, **engine_kw)

    agent = None
    mcts_agent = None
    if args.mode == "value":
        value_device = "cuda" if args.value_device in ("tpu", "auto") else args.value_device
        if torch.device(value_device) != device:
            raise ValueError(f"--value-device {args.value_device} is not the engine's device "
                             f"{device}: the value model runs beside the engine")
        if value_fn_override is not None:
            value_fn = value_fn_override
        else:
            value_fn, _, _ = build_value_fn(
                args.value_model or args.value_base or args.tokenizer_path,
                args.value_head, max_model_len=int(args.max_model_len), device=device)
        max_expands = args.mcts_max_expands
        if isinstance(max_expands, str) and max_expands.lstrip("-").isdigit():
            max_expands = int(max_expands)
        mcts_agent = MCoderAgent(
            tokenizer=tokenizer, depth=max(1, args.depth), breadth=max(1, args.breadth),
            output_dir="./eval", llm=llm, max_model_len=int(args.max_model_len),
            sampling_params=sampling, value_fn=value_fn,
            reward_fns=_build_reward_fns(args.dataset_name),
            c_puct=float(args.mcts_c_puct), v_prior=float(args.mcts_v_prior),
            value_trust=float(args.mcts_value_trust), num_sim=int(args.mcts_num_sim),
            prune_per=int(args.mcts_prune_per), max_expands=max_expands,
            num_pos_sim=int(args.mcts_num_pos_sim),
            passk_threshold=float(args.mcts_passk_threshold),
            leaves_per_sim=max(1, int(args.mcts_leaves_per_sim)),
            hid_bank=LatentBank(),
        )
    elif args.mode == "single":
        agent = PoorAgent(tokenizer=tokenizer, depth=1, breadth=1, output_dir="./eval",
                          llm=llm, sampling_params=sampling,
                          max_model_len=int(args.max_model_len))
    else:
        agent = CoderAgent(tokenizer=tokenizer, depth=max(1, args.depth), breadth=1,
                           output_dir="./eval", llm=llm, sampling_params=sampling,
                           max_model_len=int(args.max_model_len))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    aime_hint = "aime" in args.dataset_name.lower()
    wrote_any = False
    total = 0

    with open(args.out, "w", encoding="utf-8") as fout, open(args.data, encoding="utf-8") as f:
        for line in f:
            if args.limit is not None and total >= args.limit:
                break
            if not line.strip():
                continue
            ex = json.loads(line)
            question = str(ex["question"])
            qid = str(ex.get("id") or _qid(question))

            if args.mode == "value":
                chains = mcts_agent.search(question=question, ground_truth=ex["answer"],
                                           support_material_path=None, cot=None)
                k_req = max(1, int(args.rollout_k or 1))
                # leaves[0] == pick_best_leaf's winner, so completion/final
                # (the pass@1 fields) are unchanged from the reference's k=1
                # contract; extra leaves populate pass@k without re-searching.
                leaves = pick_top_leaves(chains, k_req, prefer_answer=True)
                completions = [lf["completion"] for lf in leaves] or [
                    "<think>...</think><answer></answer>"]
                finals = [_extract_answer(c) for c in completions]
                completion, final, k_used = completions[0], finals[0], len(completions)
            else:
                k_used = max(1, int(args.rollout_k or 1))
                completions, finals = [], []
                for _ in range(k_used):
                    chains = agent.react_recursive(
                        question=question, support_material_path=None,
                        ground_truth=ex["answer"], assistant_and_tool_msg=None,
                        current_chain=None, current_depth=1, previous_variables={})
                    best_leaf = None
                    for ch in chains:
                        if not ch:
                            continue
                        cand = ch[-1]
                        if _ANS_TAG.search(cand.get("completion", "")):
                            best_leaf = cand
                            break
                        if best_leaf is None:
                            best_leaf = cand
                    comp_i = best_leaf.get("completion", "") if best_leaf else "<think>...</think><answer></answer>"
                    completions.append(comp_i)
                    finals.append(_extract_answer(comp_i, aime_hint=aime_hint))
                completion, final = completions[0], finals[0]

            if not wrote_any:
                assert isinstance(completion, str), f"completion is not str: {type(completion)}"
                assert not completion.lstrip().startswith("{"), (
                    "completion looks like a stringified dict/object")
                wrote_any = True

            fout.write(json.dumps(dict(
                dataset=args.dataset_name, qid=qid, question=question,
                completion=completion, final_answer=final,
                completions=completions, final_answers=finals, k=int(k_used),
            ), ensure_ascii=False) + "\n")
            total += 1
    return total


if __name__ == "__main__":
    main()
