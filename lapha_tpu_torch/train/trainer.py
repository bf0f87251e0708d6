"""MTPOTrainer: MCTS rollouts + hyperbolic shaping + GRPO/value update, in PyTorch.

Port of ``lapha_tpu/train/trainer.py`` on one device:

- generation (the port's ``Engine``), value scoring (``ValueFunction``) and
  the update share ONE set of parameter tensors: the update step changes
  them in place, then ``engine.update_params(params)`` drops the prefix
  cache computed under the old weights — the JAX trainer's pointer swap,
- the policy+value update is ``losses.make_update_fn`` (LM forward with the
  flash kernels, chunked log-probs, GRPO + value MSE, the optax chain of
  ``train.optim``),
- checkpoints are ``torch.save`` files of {params, head, opt_state, step},
  one per ``step_N`` directory written under a temporary name and renamed
  into place, so a ``step_N`` directory that exists is complete; resume
  prefers the newest ``step_N`` over the ``latest`` pointer; metrics keep
  the reference's scalar names.

Each step plots its first four trees on the Poincaré disk
(``train/viz.py``, a side output: without matplotlib no PNG is written),
and ``save_model`` writes the HF-layout export and the value head.

Left out: the named remat policies (ROADMAP A7) and the multi-device mesh
(``mesh_model``/``mesh_sequence`` > 1 raise).
"""

from __future__ import annotations

import copy
import json
import os
import random
import re
import shutil
import time
from collections import defaultdict
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..engine.adapter import SamplingParams
from ..engine.engine import Engine
from ..models import value_model
from ..models.quant import is_quantized, leaf_device
from ..search import LatentBank
from ..search.value_fn import ValueFunction
from . import losses, optim
from .config import MTPOConfig
from .shaping import ShapingConfig, best_var_window_constrained, compute_action_rewards, has_answer
from .viz import plot_tree_disk


class MetricsWriter:
    """JSONL metrics + optional TensorBoard (torch SummaryWriter if present),
    with the reference's scalar names."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            pass

    def add_scalar(self, name: str, value: float, step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, "name": name, "value": float(value)}) + "\n")
        if self.tb is not None:
            self.tb.add_scalar(name, float(value), step)


def _quantized_paths(tree, path: str = "") -> list[str]:
    if is_quantized(tree):
        return [path]
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _quantized_paths(v, f"{path}/{k}")]
    return []


class MTPOTrainer:
    def __init__(
        self,
        model: str | tuple,
        agent_cls_list: Sequence[type],
        args: MTPOConfig,
        reward_fns: Sequence[Callable],
        train_dataset,
        eval_dataset=None,
        tokenizer=None,
        mesh=None,
        device=None,
    ):
        if mesh is not None or args.mesh_model > 1 or args.mesh_sequence > 1:
            raise NotImplementedError("multi-device training (mesh) is ROADMAP A11, "
                                      "not ported yet")
        self.args = args
        self.agent_cls_list = list(agent_cls_list)
        self.reward_fns = list(reward_fns)
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset

        # ---- model + tokenizer ----
        if isinstance(model, str):
            from ..models import loader

            self.params, self.model_cfg = loader.load_params(
                model, dtype=torch.bfloat16 if args.bf16 else torch.float32,
                device=device or "cuda")
            if tokenizer is None:
                from transformers import AutoTokenizer  # ~8 s to import: only when needed

                tokenizer = AutoTokenizer.from_pretrained(model, trust_remote_code=True)
                if tokenizer.pad_token is None:
                    tokenizer.pad_token = tokenizer.eos_token
        else:
            self.params, self.model_cfg = model
        quant_leaves = _quantized_paths(self.params)
        if quant_leaves:
            # the JAX trainer's refusal: quantized weights are for serving
            raise ValueError(
                "MTPOTrainer requires full-precision parameters; got "
                f"{len(quant_leaves)} quantized leaves (first: {quant_leaves[0]}). "
                "Quantized params are for SERVING (Engine / load_params(quantize=...)). "
                "To train, reload the checkpoint with quantize=None.")
        self.device = leaf_device(self.params["embed"]["weight"])
        losses.check_attn_impl(args.attn_implementation, self.device)
        self.tokenizer = tokenizer
        gen = torch.Generator(device=self.device).manual_seed(args.seed)
        self.head = value_model.make_value_head(args.value_head_type,
                                                self.model_cfg.hidden_size, gen)

        # ---- engine + value fn share the training tensors ----
        pad_mult = min(128, args.max_model_len)
        self.engine = Engine(
            self.params, self.model_cfg, self.tokenizer,
            max_model_len=args.max_model_len,
            max_batch=max(args.breadth * max(1, args.leaves_per_sim), 8),
            pad_multiple=pad_mult,
            seed=args.seed,
            collect_h0=True,  # fused value scoring during rollouts
            kv_quant=args.engine_kv_quant,
            spec_decode=args.engine_spec_decode,
            spec_k=args.engine_spec_k,
        )
        self.value_fn = ValueFunction(
            self.params, self.head, self.model_cfg,
            max_model_len=args.max_model_len, pad_multiple=pad_mult,
            no_head_scale=args.no_head_scale, curvature=args.curvature,
            value_activation=args.value_activation,
        )

        # ---- optimizer ----
        total_steps = args.max_steps if args.max_steps > 0 else 1000
        warmup = max(1, int(args.warmup_ratio * total_steps))
        remat = args.remat_policy if args.gradient_checkpointing else False
        self.optimizer = optim.build_trainer_optimizer(args, total_steps, warmup)
        self._update = losses.make_update_fn(
            self.model_cfg, self.optimizer,
            loss_kwargs=dict(
                temperature=args.temperature,
                eps_low=args.epsilon, eps_high=args.epsilon_high,
                loss_type=args.loss_type,
                importance_level=args.importance_sampling_level,
                value_w=args.value_w, beta=args.beta,
                max_completion_length=args.max_completion_length,
                no_head_scale=args.no_head_scale,
                value_activation=args.value_activation,
                remat=remat,
                attn_impl=args.attn_implementation,
            ),
        )
        self.opt_state = self.optimizer.init(losses.tree_leaves((self.params, self.head)))
        self.ref_params = None  # set lazily if beta > 0
        self._value_sumsq_grad = losses.make_value_sumsq_grad_fn(
            self.model_cfg, no_head_scale=args.no_head_scale,
            value_activation=args.value_activation, remat=remat,
            attn_impl=args.attn_implementation)

        self.sampling_params = SamplingParams(
            n=args.breadth, temperature=args.temperature, top_p=args.top_p,
            top_k=args.top_k, min_p=args.min_p,
            repetition_penalty=args.repetition_penalty,
            max_tokens=args.max_completion_length,
        )
        self.shaping_cfg = ShapingConfig(
            depth=args.depth, passk_threshold=args.passk_threshold,
            curvature=args.curvature, adaptive_fmt_bonus=args.adaptive_fmt_bonus,
            adapt_alpha_fmt=args.adapt_alpha_fmt, adapt_alpha_dv=args.adapt_alpha_dv,
            adapt_eps=args.adapt_eps, adapt_min_weight=args.adapt_min_weight,
            adapt_dv_var_eps=args.adapt_dv_var_eps,
            adapt_dv_sum_eps=args.adapt_dv_sum_eps,
            max_prompt_length=args.max_prompt_length,
        )

        self.global_step = 0
        self.rng = random.Random(args.seed)
        self.writer = MetricsWriter(args.output_dir)
        self._metrics: dict[str, list] = defaultdict(list)
        os.makedirs(args.output_dir, exist_ok=True)
        self.question: str | None = None  # current rollout question (judge context)
        # self-judge appended to reward_fns like the reference
        # (mtpo_trainer.py:804, 3148-3205); the 0.8 exact-match score is
        # deliberately below passk_threshold so max-composition with the
        # rule reward shadows it unless only the judge fires (SURVEY §7.4)
        self.reward_fns.append(self.self_evolving)

    # ------------------------------------------------------------- self judge

    def self_evolving(self, model_output: str, ground_truth) -> float:
        """Policy-as-judge fallback reward (reference mtpo_trainer.py:3148)."""
        matches = re.findall(r"<answer>(.*?)</answer>", model_output or "")
        if not matches:
            return 0.0
        extracted = matches[-1]
        if str(ground_truth) not in extracted:
            return 0.0
        if str(ground_truth) == extracted:
            return 0.8
        prompt_body = (self.question or "").split("👆")[0]
        prompt = (
            "Evaluate the model's answer against the human-annotated ground truth.\n\n"
            "## Instructions\n"
            "1. Return a correctness score **either 0 or 1** (1 represents "
            "model_output == ground_truth).\n"
            "3. Wrap **only** the final score in `<answer>…</answer>`.\n\n"
            f"## Query\n{prompt_body}\n\n"
            f"## Model Output\n{extracted}\n\n"
            f"## Ground Truth\n{ground_truth}"
        )
        chat = self.tokenizer.apply_chat_template(
            conversation=[{"role": "user", "content": prompt}],
            tokenize=False, add_generation_prompt=True)
        sp = copy.copy(self.sampling_params)
        sp.n = 1
        # generation errors (a kernel's refusal, a CUDA fault) propagate;
        # only a verdict that is not a number scores 0
        out = self.engine.generate(prompts=[chat], sampling_params=sp, use_tqdm=False)
        text = self.tokenizer.decode(list(out[0].outputs[0].token_ids),
                                     skip_special_tokens=True)
        verdict = re.findall(r"<answer>(.*?)</answer>", text)
        try:
            return 1.0 if verdict and float(verdict[-1]) == 1.0 else 0.0
        except ValueError:
            return 0.0

    # ------------------------------------------------------------- rollout

    def _make_agent(self, hid_bank: LatentBank):
        cls = self.rng.choice(self.agent_cls_list)
        agent = cls(
            tokenizer=self.tokenizer, depth=self.args.depth, breadth=self.args.breadth,
            output_dir=self.args.output_dir, llm=self.engine,
            max_model_len=self.args.max_model_len, sampling_params=self.sampling_params,
            value_fn=self.value_fn, reward_fns=self.reward_fns,
            c_puct=self.args.c_puct, v_prior=self.args.v_prior,
            value_trust=self.args.value_trust, num_sim=self.args.num_sim,
            prune_per=self.args.prune_per, max_expands=self.args.max_expands,
            num_pos_sim=self.args.num_pos_sim,
            passk_threshold=self.args.passk_threshold,
            leaves_per_sim=self.args.leaves_per_sim,
            hid_bank=hid_bank, rng=self.rng,
        )
        return agent

    def _ensure_hid_idx_coverage(self, chains, hid_bank, root_step=None,
                                 batch_size: int = 8) -> int:
        """Embed any steps missing a latent-bank row before shaping
        (reference mtpo_trainer.py:1329-1444): nodes whose value batch was
        skipped during search (e.g. transiently disabled rows) still need a
        ball point for the V-map. Returns the number embedded."""
        missing = []
        seen = set()
        for chain in chains:
            for st in chain:
                if id(st) in seen or st.get("hid_idx") is not None:
                    continue
                seen.add(id(st))
                p_ids = st.get("prompt_ids")
                c_ids = st.get("completion_ids")
                if not p_ids or not c_ids:
                    continue
                missing.append(st)
        if not missing:
            return 0
        root_h0 = None
        if root_step is not None and root_step.get("root_h0") is not None:
            root_h0 = np.asarray(root_step["root_h0"], np.float32).reshape(-1)
        for lo in range(0, len(missing), batch_size):
            chunk = missing[lo:lo + batch_size]
            L = max(len(st["prompt_ids"]) + len(st["completion_ids"]) for st in chunk)
            ids = np.zeros((len(chunk), L), np.int64)
            attn = np.zeros_like(ids)
            resp = np.zeros_like(ids)
            pm = np.zeros_like(ids)
            for i, st in enumerate(chunk):
                pl_, cl_ = len(st["prompt_ids"]), len(st["completion_ids"])
                ids[i, :pl_] = st["prompt_ids"]
                ids[i, pl_:pl_ + cl_] = st["completion_ids"]
                attn[i, :pl_ + cl_] = 1
                resp[i, pl_:pl_ + cl_] = 1
                pm[i, :pl_] = 1
            y, _v = self.value_fn(input_ids=ids, attention_mask=attn,
                                  response_mask=resp, prompt_mask=pm,
                                  root_h0=root_h0, return_h0=False)
            for i, st in enumerate(chunk):
                st["hid_idx"] = hid_bank.add(np.asarray(y[i], np.float32))
                st["hid"] = np.asarray(y[i], np.float16).tolist()
        return len(missing)

    def _embed_cot_anchor(self, cot, root_step) -> Optional[np.ndarray]:
        """Embed the dataset's reference CoT as an extra "correct leaf"
        anchor for d_goal (reference mtpo_trainer.py:2506-2518, 2788-2811):
        tokenize it (str) or accept pre-tokenized ids, append EOS so the
        trace looks finish-like, left-truncate prompt||cot to max_model_len
        with completion-pooling masks, and run value_fn with the root
        centering. Returns (1, H) float32 ball point or None."""
        if cot is None or root_step is None:
            return None
        p_ids = root_step.get("prompt_ids")
        if not p_ids:
            return None
        if isinstance(cot, str):
            c_ids = [int(t) for t in
                     self.tokenizer(cot, add_special_tokens=False)["input_ids"]]
        else:
            c_ids = [int(t) for t in cot]
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        if eos_id is not None and (not c_ids or c_ids[-1] != int(eos_id)):
            c_ids.append(int(eos_id))
        if not c_ids:
            return None
        p_ids = [int(t) for t in p_ids]
        full = p_ids + c_ids
        resp = [0] * len(p_ids) + [1] * len(c_ids)
        pm = [1] * len(p_ids) + [0] * len(c_ids)
        mx = int(self.args.max_model_len or 0)
        if mx > 0 and len(full) > mx:
            full, resp, pm = full[-mx:], resp[-mx:], pm[-mx:]
        ids = np.asarray([full], np.int64)
        root_h0 = None
        if root_step.get("root_h0") is not None:
            root_h0 = np.asarray(root_step["root_h0"], np.float32).reshape(-1)
        y, _v = self.value_fn(input_ids=ids, attention_mask=np.ones_like(ids),
                              response_mask=np.asarray([resp], np.int64),
                              prompt_mask=np.asarray([pm], np.int64),
                              root_h0=root_h0, return_h0=False)
        return np.asarray(y, np.float32).reshape(1, -1)

    def rollout_batch(self, inputs: list[dict]) -> dict:
        """MCTS per question -> shaped rewards -> grouped training samples.

        Group building parity (mtpo_trainer.py:1611-1763): skip all-zero
        v_target trees and avgAcc>=0.8 trees; bucket by prompt_ids; require
        >= breadth samples, reward variance, positive v_target; pick the
        best-variance window of size breadth; <=2 groups/tree; stop at
        num_groups. Every rejection is counted by reason.
        """
        args = self.args
        eps_reward, eps_vt = 1e-12, 1e-8
        rej = dict(trees_no_v_signal=0, trees_no_samples=0,
                   trees_high_acc=0, buckets_small=0,
                   buckets_no_reward_var=0, buckets_no_pos_v_target=0)
        step_samples: list[dict] = []
        mse_nodes: list[dict] = []
        avg_accs, pass1s = [], []
        group_count = 0
        mse_tree_cnt = 0
        viz_payload = []

        for idx, inp in enumerate(inputs):
            if group_count >= args.num_groups:
                break
            self.question = inp["question"]
            hid_bank = LatentBank()
            agent = self._make_agent(hid_bank)
            chains = agent.search(
                question=inp["question"],
                support_material_path=inp.get("support_material_path"),
                ground_truth=inp["ground_truth"],
                # search gets no CoT (reference call site mtpo_trainer.py:
                # 1581-1586, SURVEY §7.4); shaping gets it as a d_goal
                # anchor below (reference 1603, 2788-2811)
                cot=None,
            )
            self._ensure_hid_idx_coverage(chains, hid_bank,
                                          root_step=agent._root_step)
            cot_anchor = self._embed_cot_anchor(inp.get("cot"), agent._root_step)
            avg_acc, pass1, diag = compute_action_rewards(
                chains, self.reward_fns, inp["ground_truth"], self.shaping_cfg,
                bank=hid_bank, root_step=agent._root_step,
                cot_anchor=cot_anchor)
            if "vmap_mean" in diag:
                # per tree at the same step, like the reference
                # (mtpo_trainer.py:2833-2838)
                self.writer.add_scalar("VMap/mean", diag["vmap_mean"], self.global_step)
                self.writer.add_scalar("VMap/std", diag["vmap_std"], self.global_step)
            avg_accs.append(avg_acc)
            pass1s.append(pass1)
            viz_payload.append((chains, agent._root_step, hid_bank))

            has_sig = any(abs(float(st.get("v_target", 0.0))) > eps_vt
                          for ch in chains for st in ch)
            if not has_sig:
                rej["trees_no_v_signal"] += 1
                continue

            # dedup by step identity; keep per-sample fields
            local_samples, seen = [], set()
            for chain in chains:
                for st in chain:
                    sid = id(st)
                    if sid in seen:
                        continue
                    seen.add(sid)
                    p_ids = st.get("prompt_ids")
                    c_ids = st.get("completion_ids")
                    if not p_ids or c_ids is None or len(c_ids) == 0:
                        continue
                    local_samples.append(dict(
                        prompt_ids=list(map(int, p_ids))[-args.max_prompt_length:],
                        completion_ids=list(map(int, c_ids)),
                        tree_id=idx,
                        state_value=float(st.get("state_value") or 0.0),
                        reward=float(st.get("reward") or 0.0),
                        is_leaf=bool(st.get("is_leaf", False)),
                        depth=int(st.get("current_depth", 0)),
                        is_correct=bool(st.get("is_correct", False)),
                        on_path=bool(st.get("on_path", False)),
                        v_target=float(st.get("v_target", 0.0)),
                        v_pred=float(st.get("v_pred") or 0.0),
                        has_answer=has_answer(st),
                    ))
            if not local_samples:
                rej["trees_no_samples"] += 1
                continue

            if args.num_trees != -1 and mse_tree_cnt < args.num_trees:
                mse_nodes.extend(dict(prompt_ids=s["prompt_ids"],
                                      completion_ids=s["completion_ids"],
                                      v_target=s["v_target"]) for s in local_samples)
                mse_tree_cnt += 1

            if avg_acc >= 0.8:
                rej["trees_high_acc"] += 1
                continue  # training-stability skip

            buckets: dict[tuple, list[dict]] = defaultdict(list)
            for s in local_samples:
                buckets[tuple(s["prompt_ids"])].append(s)

            tree_groups = 0
            for samples in buckets.values():
                if group_count >= args.num_groups or tree_groups >= 2:
                    break
                if args.breadth > 0 and len(samples) < args.breadth:
                    rej["buckets_small"] += 1
                    continue
                r_vals = [s["reward"] for s in samples]
                if max(r_vals) - min(r_vals) <= eps_reward:
                    rej["buckets_no_reward_var"] += 1
                    continue
                if max(s["v_target"] for s in samples) <= eps_vt:
                    rej["buckets_no_pos_v_target"] += 1
                    continue
                ss = sorted(samples, key=lambda s: s["reward"], reverse=True)
                vals = np.asarray([s["reward"] for s in ss], np.float32)
                start, _ = best_var_window_constrained(vals, np.ones_like(vals, bool),
                                                       args.breadth)
                chosen = ss[:args.breadth] if start is None else ss[start:start + args.breadth]
                step_samples.extend(chosen)
                group_count += 1
                tree_groups += 1

        batch_avg_acc = float(np.mean(avg_accs)) if avg_accs else 0.0
        batch_pass1 = float(np.mean(pass1s)) if pass1s else 0.0
        self.writer.add_scalar("avgAcc", batch_avg_acc, self.global_step)
        self.writer.add_scalar("pass@1", batch_pass1, self.global_step)
        # Poincaré-disk plot of each of the first four trees
        viz_dir = os.path.join(args.output_dir, "viz", f"step-{self.global_step}")
        for tid, (chains, root_step, _bank) in enumerate(viz_payload[:4]):
            plot_tree_disk(chains, root_step, os.path.join(viz_dir, f"tree{tid}_disk.png"),
                           title=f"tree{tid}")
        for k, v in rej.items():
            if v:
                self.writer.add_scalar(f"Rollout/rej_{k}", v, self.global_step)
        return dict(step_samples=step_samples, mse_nodes=mse_nodes,
                    avg_acc=batch_avg_acc, pass_at_1=batch_pass1,
                    num_groups=group_count, viz=viz_payload, rejections=rej)

    # ------------------------------------------------------------- update

    def train_step(self, inputs: list[dict]) -> dict:
        if self.args.profile_dir and self.global_step == self.args.profile_step:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                m = self._train_step_inner(inputs)
            os.makedirs(self.args.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.args.profile_dir,
                                                  f"step-{self.global_step - 1}.json"))
        else:
            m = self._train_step_inner(inputs)
        # save boundary checked HERE so early-return steps (no trainable
        # samples) cannot bump global_step past a due save silently
        if self.args.save_steps > 0 and self.global_step % self.args.save_steps == 0:
            self.save_checkpoint()
        return m

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train_step_inner(self, inputs: list[dict]) -> dict:
        t0 = time.perf_counter()
        rollout = self.rollout_batch(inputs)
        t_rollout = time.perf_counter() - t0
        samples = rollout["step_samples"]
        metrics = dict(avg_acc=rollout["avg_acc"], pass_at_1=rollout["pass_at_1"],
                       num_groups=rollout["num_groups"], rollout_s=t_rollout,
                       n_samples=len(samples))
        metrics.update({f"rej_{k}": v for k, v in
                        rollout.get("rejections", {}).items() if v})
        if not samples:
            # every tree/bucket was filtered — say WHY, not a bare loss=0
            metrics["loss"] = 0.0
            metrics["skipped"] = "no_trainable_groups"
            self.global_step += 1
            return metrics

        pad_id = int(getattr(self.tokenizer, "pad_token_id", 0) or 0)
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        packed = losses.pack_samples(samples, pad_id, eos_id, self.args.max_prompt_length)
        if packed is None:
            metrics["loss"] = 0.0
            metrics["skipped"] = "pack_samples_empty"
            self.global_step += 1
            return metrics

        # align to the rows pack_samples actually kept (defensive drops must
        # not shift later rows onto a neighbor's advantage/target)
        kept_samples = [samples[i] for i in packed["kept"].tolist()]
        key2gid: dict[tuple, int] = {}
        gids = []
        for s in kept_samples:
            key = tuple(s["prompt_ids"])
            key2gid.setdefault(key, len(key2gid))
            gids.append(key2gid[key])
        B_real = len(kept_samples)
        adv = losses.group_advantages(np.asarray([s["reward"] for s in kept_samples]),
                                      np.asarray(gids), self.args.scale_rewards)
        Bb = packed["ids"].shape[0]
        advantages = np.zeros(Bb, np.float32)
        advantages[:B_real] = adv
        v_target = np.zeros(Bb, np.float32)
        v_target[:B_real] = [s["v_target"] for s in kept_samples]
        samples = kept_samples

        batch = losses.batch_to_device(packed, self.device)
        batch["advantages"] = torch.as_tensor(advantages, device=self.device)
        batch["v_target"] = torch.as_tensor(v_target, device=self.device)

        # chosen-sample dumps per step/group (reference 1795-1837)
        try:
            from ..search.mcts import dump_step as _dump_step

            dump_root = os.path.join(self.args.output_dir, "train",
                                     f"step-{self.global_step}")
            counts: dict[int, int] = defaultdict(int)
            for s, gid in zip(samples, gids):
                i_local = counts[gid]
                counts[gid] += 1
                dec = getattr(self.tokenizer, "decode", None)
                _dump_step({
                    "state_value": s.get("reward"),
                    "prompt_ids": s["prompt_ids"],
                    "completion_ids": s["completion_ids"],
                    "prompt": dec(s["prompt_ids"], skip_special_tokens=False) if dec else "",
                    "completion": dec(s["completion_ids"], skip_special_tokens=False) if dec else "",
                    "ground_truth": s.get("ground_truth"),
                }, os.path.join(dump_root, f"group-{gid}", f"tmp{i_local}.txt"))
        except Exception:
            pass

        ref_logps = None
        if self.args.beta > 0.0:
            if self.ref_params is None:
                self.ref_params = losses.tree_map(lambda t: t.detach().clone(), self.params)
            ref_logps = losses.ref_logps_fn(self.ref_params, batch, self.model_cfg,
                                            self.args.temperature)

        # num_trees != -1: value MSE over ALL nodes of the first num_trees
        # trees replaces the step-sample MSE (reference 2171-2296) — grads
        # accumulated over micro-batches, injected into the main update
        extra_grads = None
        value_w_override = None
        mse_nodes = rollout.get("mse_nodes") or []
        if self.args.num_trees != -1 and mse_nodes:
            mbs = max(1, int(self.args.mse_micro_bs))
            acc = None
            total_cnt = 0.0
            total_sq = 0.0
            for lo in range(0, len(mse_nodes), mbs):
                chunk = mse_nodes[lo:lo + mbs]
                packed_m = losses.pack_samples(chunk, pad_id, eos_id,
                                               self.args.max_prompt_length,
                                               batch_multiple=1)
                if packed_m is None:
                    continue
                kept_m = [chunk[i] for i in packed_m["kept"].tolist()]
                mb = losses.batch_to_device(packed_m, self.device)
                vt = np.zeros(packed_m["ids"].shape[0], np.float32)
                vt[:len(kept_m)] = [float(c.get("v_target", 0.0)) for c in kept_m]
                mb["v_target"] = torch.as_tensor(vt, device=self.device)
                sq, cnt, grads = self._value_sumsq_grad(self.params, self.head, mb)
                total_sq += float(sq)
                total_cnt += float(cnt)
                acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
            if acc is not None and total_cnt > 0:
                scale = self.args.value_w / total_cnt
                extra_grads = [g.float() * scale for g in acc]
                value_w_override = 0.0
                metrics["value_loss_all_nodes"] = total_sq / total_cnt
                self.writer.add_scalar("Loss/ValueLoss", total_sq / total_cnt,
                                       self.global_step)

        self._sync()
        t1 = time.perf_counter()
        # multi-epoch PPO (num_iterations > 1): cache the pre-update policy
        # logps once so later iterations' PPO ratio/clip are live; iteration
        # 1 with old_logps is identical to on-policy (ratio == 1), so
        # num_iterations=1 skips the extra pass.
        old_logps = None
        if self.args.num_iterations > 1:
            old_logps = losses.ref_logps_fn(self.params, batch, self.model_cfg,
                                            self.args.temperature)
        for _it in range(max(1, self.args.num_iterations)):
            self.params, self.head, self.opt_state, step_metrics = self._update(
                self.params, self.head, self.opt_state, batch, ref_logps,
                extra_grads, value_w_override=value_w_override,
                old_logps=old_logps)
        step_metrics = {k: float(v) for k, v in step_metrics.items()}
        self._sync()
        metrics.update(step_metrics, update_s=time.perf_counter() - t1)

        # weight sync: the engine and value fn hold these tensors, changed
        # in place; the prefix cache was computed under the old weights
        self.engine.update_params(self.params)
        self.value_fn.update_params(self.params, self.head)

        for name, key in (("Loss/ValueLoss", "value_loss"), ("Loss/PolicyLoss", "policy_loss"),
                          ("Loss/Loss", "loss"), ("Metrics/KL", "kl")):
            if key in step_metrics:
                self.writer.add_scalar(name, step_metrics[key], self.global_step)

        # Metrics/ContextLength: mean prompt+completion length over the
        # step's ANSWERED samples (reference mtpo_trainer.py:2420-2444)
        ctx = [len(s["prompt_ids"]) + len(s["completion_ids"])
               for s in samples if s.get("has_answer", False)]
        avg_ctx = float(np.mean(ctx)) if ctx else 0.0
        metrics["context_length"] = avg_ctx
        self.writer.add_scalar("Metrics/ContextLength", avg_ctx, self.global_step)

        self.global_step += 1
        return metrics

    def train(self, resume_from_checkpoint: Optional[str] = None, max_steps: Optional[int] = None):
        if resume_from_checkpoint:
            self.load_checkpoint(resume_from_checkpoint)
        elif self.args.resume_from_checkpoint:
            self.load_checkpoint(self.args.resume_from_checkpoint)

        steps = max_steps or (self.args.max_steps if self.args.max_steps > 0 else None)
        bs = self.args.per_device_train_batch_size
        data = list(self.train_dataset)
        i = 0
        history = []
        while True:
            if steps is not None and self.global_step >= steps:
                break
            if i >= len(data):
                i = 0
            batch = data[i : i + bs]
            i += bs
            if not batch:
                break
            m = self.train_step(batch)
            history.append(m)
            if self.args.debug_print:
                print(f"[step {self.global_step}] " +
                      " ".join(f"{k}={v:.4g}" for k, v in m.items()
                               if isinstance(v, (int, float))))
            if steps is None and i >= len(data):
                break
        self.save_checkpoint()
        return history

    # ------------------------------------------------------------- checkpoints

    def _ckpt_dir(self) -> str:
        return os.path.join(self.args.output_dir, "checkpoints")

    def finish_pending_saves(self):
        """Saves are synchronous in the port; kept for the JAX trainer's API."""

    def save_checkpoint(self):
        """Write {params, head, opt_state, step} to ``step_N/state.pt``: into
        a temporary directory first, renamed into place when complete, then
        the ``latest`` pointer. A crash leaves either no ``step_N`` or a
        whole one, and resume prefers the newest ``step_N`` (a crash after
        the rename but before the pointer write loses nothing)."""
        ckpt_dir = os.path.abspath(self._ckpt_dir())
        os.makedirs(ckpt_dir, exist_ok=True)
        final = os.path.join(ckpt_dir, f"step_{self.global_step}")
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        detach = lambda t: t.detach() if isinstance(t, torch.Tensor) else t  # noqa: E731
        torch.save({"params": losses.tree_map(detach, self.params),
                    "head": losses.tree_map(detach, self.head),
                    "opt_state": self.opt_state, "step": self.global_step},
                   os.path.join(tmp, "state.pt"))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        with open(os.path.join(ckpt_dir, "latest"), "w") as f:
            f.write(str(self.global_step))

    def load_checkpoint(self, path: Optional[str] = None):
        if path in (None, True):
            steps = []
            if os.path.isdir(self._ckpt_dir()):
                for name in os.listdir(self._ckpt_dir()):
                    m = re.fullmatch(r"step_(\d+)", name)
                    if m:
                        steps.append(int(m.group(1)))
            latest = os.path.join(self._ckpt_dir(), "latest")
            if not steps and not os.path.exists(latest):
                return False
            step = max(steps) if steps else int(open(latest).read().strip())
            path = os.path.join(os.path.abspath(self._ckpt_dir()), f"step_{step}")
            self.global_step = step
        else:
            # explicit path: recover the step counter from the dir name so
            # resumed runs don't restart metrics/saves at step 0
            m = re.search(r"step[_-](\d+)", os.path.basename(os.path.normpath(str(path))))
            if m:
                self.global_step = int(m.group(1))
        state = torch.load(os.path.join(path, "state.pt"), map_location=self.device,
                           weights_only=False)
        # copy into the live tensors: the engine and value fn hold them
        with torch.no_grad():
            for dst, src in zip(losses.tree_leaves((self.params, self.head)),
                                losses.tree_leaves((state["params"], state["head"]))):
                dst.copy_(src)
        self.opt_state = state["opt_state"]
        self.engine.update_params(self.params)
        self.value_fn.update_params(self.params, self.head)
        return True

    def save_model(self, out_dir: str, src_config_dir: Optional[str] = None):
        """Export the policy (HF layout, f32) and the value head as
        ``value_head.npz`` and ``value_head.pt``: the reference's
        policy/value-head split, no post-processing step needed."""
        from ..models import loader

        loader.export_hf(self.params, self.model_cfg, out_dir, src_config_dir=src_config_dir)
        loader.save_value_head(os.path.join(out_dir, "value_head.npz"), self.head)
        loader.save_value_head(os.path.join(out_dir, "value_head.pt"), self.head)
