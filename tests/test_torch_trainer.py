"""The port's MTPOTrainer end to end on the CPU at a tiny size: one
train_step (MCTS rollout -> hyperbolic shaping -> GRPO + value update), as
tests/test_train.py drives the JAX trainer, plus the checkpoint rules.

The first test gives the trainer the JAX package's scripted ``FakeEngine``
(plain Python), as the JAX test does; ``test_train_step_matches_jax_trainer``
runs the JAX trainer and the port side by side on the same weights and
compares what each step trains on and what it leaves; the third runs the
port's own ``Engine`` on random tiny weights with a token-id chat
tokenizer, so the whole slice (engine, value function, search, shaping,
update) runs through the port.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from lapha_tpu.engine import FakeEngine
from lapha_tpu_torch.models import qwen2
from lapha_tpu_torch.search import MCTSAgent
from lapha_tpu_torch.train import MTPOConfig, MTPOTrainer
from lapha_tpu_torch.train import losses

from test_search import ChatTok


class PoorAgent(MCTSAgent):
    TOOLS = {}
    TOOLS_DESCRIPTION = ""
    SYSTEM_TEMPLATE = "Solve step by step. Limit {step_limit} steps."
    USER_TEMPLATE = "{support_material_str}\nQ: {question}"


class IdChatTok:
    """Words <i> are token i; any other word hashes into the vocabulary, so
    decode -> encode round-trips every generated id."""

    eos_token_id = 1
    pad_token_id = 0

    def __init__(self, vocab: int):
        self.vocab = vocab

    def _id(self, w):
        m = re.fullmatch(r"<(\d+)>", w)
        return int(m.group(1)) if m else 2 + sum(map(ord, w)) % (self.vocab - 2)

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [self._id(w) for w in text.split()]}

    def decode(self, ids, skip_special_tokens=True, **kw):
        return " ".join(f"<{int(i)}>" for i in ids
                        if not (skip_special_tokens and int(i) in (0, 1)))

    def apply_chat_template(self, conversation, tools=None, tokenize=False,
                            add_generation_prompt=True, **kw):
        text = "\n".join(f"<|{m['role']}|> {m.get('content', '')}" for m in conversation)
        return text + ("\n<|assistant|>\n" if add_generation_prompt else "\n")


DATASET = [
    {"question": "what is 2+2?", "ground_truth": "4", "support_material_path": [],
     "cot": "add two and two to get <answer>4</answer>"},
    {"question": "what is 1+3?", "ground_truth": "4", "support_material_path": []},
]


def _args(out, **kw):
    base = dict(output_dir=str(out), model_name_or_path=None, depth=3, breadth=2, num_sim=6,
                num_pos_sim=99, prune_per=100, num_groups=4, max_model_len=512,
                max_prompt_length=256, max_completion_length=32,
                per_device_train_batch_size=2, num_generations=2, save_steps=0, bf16=False,
                gradient_checkpointing=False, mesh_model=1, debug_print=False)
    base.update(kw)
    return MTPOConfig(**base)


def _model(vocab=4096, seed=0):
    cfg = qwen2.Qwen2Config.tiny(vocab_size=vocab)
    return qwen2.init_params(cfg, torch.Generator().manual_seed(seed)), cfg


def _reward(c, gt):
    return 1.0 if f"<answer>{gt}</answer>" in c else 0.0


def test_trainer_full_step_tiny(tmp_path):
    """The counterpart of tests/test_train.py::test_trainer_full_step_tiny:
    fake-engine rollout -> shaping -> update. The warmup schedule gives lr 0
    on the first update, so a second step shows the update moving the
    weights the engine and the value function hold."""
    params, cfg = _model()
    tok = ChatTok()
    eng = FakeEngine(tok, script=[
        (r"STEP-2", ["done </think> <answer>4</answer>", "done2 </think> <answer>7</answer>"]),
        (r".", ["go </think> on", "go2 </think> on"]),
    ])
    args = _args(tmp_path, learning_rate=1e-3, warmup_ratio=0.0)
    trainer = MTPOTrainer(model=(params, cfg), agent_cls_list=[PoorAgent], args=args,
                          reward_fns=[_reward], train_dataset=DATASET, tokenizer=tok)
    trainer.engine = eng  # fake generation; the value fn stays real (tiny model)
    before = params["layers"]["attn"]["q_proj"]["w"].detach().clone()

    m = trainer.train_step(DATASET)
    assert trainer.global_step == 1
    assert m["n_samples"] > 0 and m["num_groups"] >= 1
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0
    assert m["rollout_s"] > 0 and m["update_s"] > 0
    after = trainer.params["layers"]["attn"]["q_proj"]["w"]
    assert after is params["layers"]["attn"]["q_proj"]["w"]  # updated in place
    assert trainer.value_fn.params is trainer.params
    assert trainer.opt_state["count"] == 1
    assert max(float(mu.abs().max()) for mu in trainer.opt_state["mu"]) > 0
    trainer.train_step(DATASET)
    assert trainer.global_step == 2 and trainer.opt_state["count"] == 2
    assert not torch.equal(before, after.detach())
    lines = [json.loads(line) for line in open(os.path.join(args.output_dir, "metrics.jsonl"))]
    names = {line["name"] for line in lines}
    assert {"avgAcc", "pass@1", "VMap/mean", "VMap/std", "Loss/Loss", "Loss/PolicyLoss",
            "Loss/ValueLoss", "Metrics/ContextLength"} <= names


def _np(x):
    return None if x is None else np.array(x.detach() if isinstance(x, torch.Tensor) else x,
                                           np.float32)


def _spy(trainer) -> list:
    """Record a host copy of every update call's inputs on ``trainer`` (the
    JAX step donates its buffers)."""
    import jax

    calls = []
    inner = trainer._update

    def update(params, head, opt_state, batch, ref_logps=None, extra_grads=None, **kw):
        calls.append(dict(batch={k: _np(v) for k, v in batch.items()}, ref_logps=_np(ref_logps),
                          extra_grads=None if extra_grads is None else
                          [_np(g) for g in jax.tree.leaves(extra_grads)],
                          **{k: _np(v) for k, v in kw.items()}))
        return inner(params, head, opt_state, batch, ref_logps, extra_grads, **kw)

    trainer._update = update
    return calls


@pytest.mark.parametrize("case", [
    dict(beta=0.1),                              # the ref-KL term: ref_logps_fn
    dict(num_trees=2, mse_micro_bs=4),           # all-nodes value MSE as extra grads
    dict(num_iterations=2, learning_rate=1e-3, warmup_ratio=0.0),  # old_logps; epoch 2 moves
], ids=["beta", "num_trees", "num_iterations"])
def test_train_step_matches_jax_trainer(tmp_path, case):
    """The JAX trainer and the port, on the same tiny weights and value head,
    the same scripted engine and seed, run one train_step. Equal: the
    rollout's counts, the packed batch, the gid-aligned advantages and
    v_targets, ref/old logps, the all-nodes extra gradients, the loss and its
    parts, Adam's first moment (the clipped gradient) and the params after.
    Tolerance: 1e-4 (f32; XLA and PyTorch sum in different orders)."""
    import jax

    from lapha_tpu.models import Qwen2Config as JCfg
    from lapha_tpu.models import qwen2 as jq
    from lapha_tpu.train.trainer import MTPOTrainer as JTrainer
    from lapha_tpu_torch.models import loader

    from test_search import PoorAgent as JPoorAgent

    jcfg = JCfg.tiny(vocab_size=4096)
    jparams = jq.init_params(jcfg, jax.random.key(0))
    tparams = loader.params_from_numpy(jax.tree.map(np.asarray, jparams))
    tcfg = qwen2.Qwen2Config.tiny(vocab_size=4096)
    script = [(r"STEP-2", ["done </think> <answer>4</answer>",
                           "done2 </think> <answer>7</answer>"]),
              (r".", ["go </think> on", "go2 </think> on"])]
    side = {}
    for name, model, agent in (("jax", (jparams, jcfg), JPoorAgent),
                               ("torch", (tparams, tcfg), PoorAgent)):
        cls = JTrainer if name == "jax" else MTPOTrainer
        tr = cls(model=model, agent_cls_list=[agent], args=_args(tmp_path / name, **case),
                 reward_fns=[_reward], train_dataset=DATASET, tokenizer=ChatTok())
        tr.engine = FakeEngine(ChatTok(), script=script)
        side[name] = (tr, _spy(tr))
    (jt, jcalls), (tt, tcalls) = side["jax"], side["torch"]
    with torch.no_grad():  # the port takes the JAX value head (made from a JAX key)
        for dst, src in zip(losses.tree_leaves(tt.head), jax.tree.leaves(jt.head)):
            dst.copy_(torch.from_numpy(_np(src)))
    before = [_np(p) for p in jax.tree.leaves((jparams, jt.head))]

    jm, tm = jt.train_step(DATASET), tt.train_step(DATASET)

    for key in ("n_samples", "num_groups", "avg_acc", "pass_at_1"):
        assert tm[key] == pytest.approx(jm[key], abs=1e-6), key
    assert tm["n_samples"] > 0 and len(tcalls) == len(jcalls) == case.get("num_iterations", 1)
    assert {k for k in tm if k.startswith("rej_")} == {k for k in jm if k.startswith("rej_")}
    for key in ("loss", "policy_loss", "value_loss", "kl", "v_pred_mean", "grad_norm",
                "value_loss_all_nodes"):
        if key in jm:
            assert tm[key] == pytest.approx(jm[key], abs=1e-4, rel=1e-4), key
    assert ("value_loss_all_nodes" in tm) == ("num_trees" in case)
    tol = dict(atol=1e-4, rtol=1e-4)
    for jc, tc in zip(jcalls, tcalls):
        assert tc["batch"].keys() == jc["batch"].keys()
        for key, jv in jc["batch"].items():
            np.testing.assert_allclose(tc["batch"][key], jv, err_msg=key, **tol)
        for key in ("ref_logps", "old_logps", "value_w_override"):
            jv, tv = jc.get(key), tc.get(key)
            assert (jv is None) == (tv is None), key
            if jv is not None:
                np.testing.assert_allclose(tv, jv, err_msg=key, **tol)
        assert (jc["extra_grads"] is None) == (tc["extra_grads"] is None)
        for a, b in zip(tc["extra_grads"] or [], jc["extra_grads"] or []):
            np.testing.assert_allclose(a, b, **tol)
    jadam = next(s for s in jt.opt_state if hasattr(s, "mu"))
    for a, b in zip(tt.opt_state["mu"], jax.tree.leaves(jadam.mu)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-4)
    moved = 0.0
    for a, b, p0 in zip(losses.tree_leaves((tt.params, tt.head)),
                        jax.tree.leaves((jt.params, jt.head)), before):
        np.testing.assert_allclose(_np(a), _np(b), **tol)
        moved = max(moved, float(np.abs(_np(b) - p0).max()))
    if "num_iterations" in case:
        assert moved > 1e-4  # lr is 0 on the schedule's first count, live on the second


def test_trainer_step_through_the_port_engine(tmp_path):
    """No fakes: the port's Engine generates, its ValueFunction scores, the
    search, shaping and update run on random tiny weights. Random weights
    may give no trainable group; the step then says why."""
    params, cfg = _model(vocab=512)
    args = _args(tmp_path, depth=2, breadth=3, num_sim=2, leaves_per_sim=1,
                 max_completion_length=6, max_model_len=256, gradient_checkpointing=True,
                 num_trees=1, beta=1e-8, learning_rate=1e-3, warmup_ratio=0.0)
    trainer = MTPOTrainer(model=(params, cfg), agent_cls_list=[PoorAgent], args=args,
                          reward_fns=[_reward], train_dataset=DATASET,
                          tokenizer=IdChatTok(cfg.vocab_size))
    m = trainer.train_step(DATASET)
    assert trainer.global_step == 1
    if m["n_samples"] > 0:
        assert np.isfinite(m["loss"]) and np.isfinite(m["value_loss_all_nodes"])
    else:
        assert m["skipped"] == "no_trainable_groups"
    out = trainer.engine.generate(["<5> <6> <7>"], trainer.sampling_params)
    assert len(out[0].outputs) == args.breadth


def _trainer(out, seed):
    params, cfg = _model(vocab=512, seed=seed)
    return MTPOTrainer(model=(params, cfg), agent_cls_list=[PoorAgent],
                       args=_args(out, depth=2, num_sim=2, max_model_len=256),
                       reward_fns=[], train_dataset=[], tokenizer=ChatTok())


def test_checkpoint_roundtrip_and_stale_latest(tmp_path):
    """save -> resume restores params, head, optimizer state and step; resume
    prefers the newest finalised step_N over a stale `latest` pointer and
    ignores an unfinished temporary directory; an explicit path restores
    the step from its name."""
    t1 = _trainer(tmp_path, 0)
    t1.opt_state["count"] = 5
    t1.global_step = 3
    t1.save_checkpoint()
    t1.global_step = 9
    with torch.no_grad():
        t1.head["w"].add_(1.0)
    t1.save_checkpoint()
    ckpt = os.path.join(str(tmp_path), "checkpoints")
    with open(os.path.join(ckpt, "latest"), "w") as f:
        f.write("3")  # the crash window: pointer behind the newest checkpoint
    os.makedirs(os.path.join(ckpt, "step_12.tmp-1"))  # a save that never finished

    t2 = _trainer(tmp_path, 9)
    held = t2.engine.params["embed"]["weight"]
    assert t2.load_checkpoint()
    assert t2.global_step == 9 and t2.opt_state["count"] == 5
    torch.testing.assert_close(t2.head["w"], t1.head["w"])
    for a, b in zip(losses.tree_leaves(t2.params), losses.tree_leaves(t1.params)):
        torch.testing.assert_close(a, b)
    assert t2.engine.params["embed"]["weight"] is held  # restored in place

    t3 = _trainer(tmp_path, 7)
    assert t3.load_checkpoint(os.path.join(ckpt, "step_3"))
    assert t3.global_step == 3
    assert not torch.equal(t3.head["w"], t1.head["w"])
    empty = _trainer(tmp_path / "none", 1)
    assert empty.load_checkpoint() is False


def test_trainer_refuses_what_is_not_ported(tmp_path):
    params, cfg = _model(vocab=512)
    with pytest.raises(NotImplementedError, match="A11"):
        MTPOTrainer(model=(params, cfg), agent_cls_list=[PoorAgent],
                    args=_args(tmp_path, mesh_model=2), reward_fns=[], train_dataset=[],
                    tokenizer=ChatTok())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _trainer(tmp_path, 0).save_model(str(tmp_path / "export"))
