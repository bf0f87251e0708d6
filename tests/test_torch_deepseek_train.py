"""lapha_tpu_torch's DeepSeek MLA training path against lapha_tpu (CPU, f32,
tiny configs): the plain backward of the flash attention with V narrower
than Q/K (the CPU side of K2 at Q/K 192, V 128) against the interpret-mode
Pallas backward, every gradient leaf of ``losses.loss_and_metrics`` and one
``make_update_fn`` step for a V2-shaped model (full q, softmax, greedy) and
a V3-shaped one (q_lora, sigmoid + a random correction bias, noaux_tc,
group-limited), ``ref_logps_fn`` on a DeepSeek tree, the remat rule, and
``MTPOTrainer`` on a DeepSeek tree.

The tiny model is tests/test_torch_deepseek.py's (``TINY``, ``_pair``): 3
layers (one dense, two MoE), H 64, 4 heads, kv_lora_rank 32, Q/K 24 (nope
16 + rope 8), V 16, 8 experts top-2 of width 24 and one shared expert. The
JAX side runs jitted with its dense attention (the CPU default of the
model) for the model-level checks; the attention op's backward is checked
against the Pallas kernels in interpret mode. The port runs remat "full".

Tolerances: the plain backward within 1e-5 of the interpret-mode kernels
(the same f32 formulas summed in another order); loss, metrics, gradient
leaves, params after one step and Adam's mu within atol 1e-4 + rtol 1e-4
(tests/test_torch_moe_train.py's: XLA and PyTorch sum in other orders, the
log-softmax is chunked); the V3 correction bias's gradient exactly zero on
both sides (it only chooses experts); ref logps within 1e-4; remat's
gradients equal to the gradients without it, bit for bit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lapha_tpu.engine import FakeEngine
from lapha_tpu.models import value_model as jvm
from lapha_tpu.ops import flash_attention as jfa
from lapha_tpu.train import losses as jl
from lapha_tpu_torch.models import deepseek as td
from lapha_tpu_torch.models import loader
from lapha_tpu_torch.ops import _cuda
from lapha_tpu_torch.ops import flash_attention as tfa
from lapha_tpu_torch.train import MTPOTrainer
from lapha_tpu_torch.train import losses as tl
from lapha_tpu_torch.train import optim as topt

from test_search import ChatTok
from test_torch_deepseek import OP_ATOL, V, _pair
from test_torch_trainer import DATASET, PoorAgent, _args, _reward

GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = {
    "v2": {},  # V2-Lite-shaped: full q, softmax scores, greedy top-k
    "v3": dict(q_lora_rank=24, scoring_func="sigmoid", topk_method="noaux_tc", n_group=4,
               topk_group=2, norm_topk_prob=True, routed_scaling_factor=2.5),
}
LOSS_KW = dict(temperature=0.7, eps_low=0.2, eps_high=0.28, loss_type="grpo",
               importance_level="token", value_w=0.5, beta=0.0, max_completion_length=16)
BIAS = "0.moe_layers.moe.router.bias"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- the attention backward

def test_narrow_v_plain_backward_matches_pallas_interpret():
    """dq, dk and dv of the port's autograd Function on the CPU (the plain
    FA-2 backward from the LSE, dO of V's width) against jax.vjp of the
    Pallas flash attention in interpret mode: Q/K 24, V 16, nh = nkv = 4
    (MLA expands K/V per head), a padded row and a hole of invalid keys.
    Upstream gradients at padded query rows are zero, as in training."""
    rng = np.random.default_rng(11)
    B, T, nh, dh, dv, scale = 2, 40, 4, 24, 16, 0.3
    q, k = (rng.normal(size=(B, T, nh, dh)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, T, nh, dv)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[0, 31:] = 0
    mask[1, 10:14] = 0
    g = rng.normal(size=(B, T, nh, dv)).astype(np.float32) * mask[:, :, None, None]
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, jnp.asarray(mask), scale=scale,
                                                         block_q=16, block_k=16, interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    jg = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, _t(mask), scale=scale)
    assert out.shape == (B, T, nh, dv)
    tg = torch.autograd.grad(out, leaves, _t(g))
    assert [tuple(a.shape) for a in tg] == [(B, T, nh, dh), (B, T, nh, dh), (B, T, nh, dv)]
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=OP_ATOL, rtol=0,
                                   err_msg=f"d{name}")


def test_narrow_v_backward_launch_names():
    """The narrow-V backward launches count under their own names, which
    the launch counters hold, and the kernels take (192, 128)."""
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert tfa.launch_name(name, narrowv=True) == name + "_narrowv"
        for w in (0, 8):
            for cap in (0.0, 5.0):
                assert tfa.launch_name(name, w, cap, narrowv=True) in _cuda.LAUNCHES
    assert (192, 128) in tfa.BWD_HEAD_DIMS and (192, 128) in tfa.FWD_HEAD_DIMS


# ---------------------------------------------------------------- gradients and one update step

@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """(name, jcfg, numpy tree, tcfg, numpy value head, JAX's (loss,
    metrics) and gradients of loss_and_metrics on ``_packed()``)."""
    jcfg, jp, tcfg, _ = _pair(3, **FAMILIES[request.param])
    tree = jax.tree_util.tree_map(np.asarray, jp)
    head = jax.tree_util.tree_map(np.asarray,
                                  jvm.init_value_head(jcfg.hidden_size, jax.random.key(1)))
    packed = _packed()
    jout, jg = jax.jit(jax.value_and_grad(
        lambda ph: jl.loss_and_metrics(ph[0], ph[1], _jbatch(packed), jcfg, remat=False,
                                       **LOSS_KW), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, (tree, head)))
    return request.param, jcfg, tree, tcfg, head, jout, jg


def _packed():
    """4 ragged rows of 12-token prompts and 5-14-token completions (32
    columns), advantages and value targets."""
    rng = np.random.default_rng(2)
    samples = [dict(prompt_ids=rng.integers(2, V, 12).tolist(),
                    completion_ids=rng.integers(2, V, 5 + 3 * i).tolist()) for i in range(4)]
    packed = jl.pack_samples(samples, pad_id=0, eos_id=1, max_prompt_length=16,
                             pad_multiple=16, batch_multiple=4)
    packed["advantages"] = np.array([1.0, -0.5, 0.5, -0.2], np.float32)
    packed["v_target"] = np.array([1.0, 0.0, 0.5, 0.2], np.float32)
    return packed


def _jbatch(packed):
    return {k: jnp.asarray(v) for k, v in packed.items() if k != "kept"}


def _names(tree, head):
    return [p for p, _ in tl.tree_paths((tree, head))]


def test_loss_gradients_match_jax(family):
    """torch.autograd.grad of loss_and_metrics (remat "full") against
    jax.grad of JAX's, every leaf of both layer groups and the value head:
    q (or q_a, q_a_norm, q_b), kv_a, kv_a_norm, kv_b, o, the norms, the
    dense MLP, the router (through the combine weights), the expert stacks
    and the shared experts. V3's correction bias gets exact zeros on both
    sides, as a zero tensor in the port (not None)."""
    name, _, tree, tcfg, head, (jloss, jm), jg = family
    packed = _packed()
    tp, th = loader.params_from_numpy(tree), loader.params_from_numpy(head)
    leaves = tl._trainable(tp, th)
    tloss, tm = tl.loss_and_metrics(tp, th, tl.batch_to_device(packed, "cpu"), tcfg,
                                    remat="full", logits_chunk=8, **LOSS_KW)
    tg = tl._grads(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **GRAD_TOL)
    for key in ("policy_loss", "value_loss", "v_pred_mean", "completion_tokens"):
        np.testing.assert_allclose(float(torch.as_tensor(tm[key]).detach()), float(jm[key]),
                                   err_msg=key, **GRAD_TOL)
    names = _names(tp, th)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(names) == len(jleaves) == len(tg)
    for n, a, b in zip(names, tg, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=n, **GRAD_TOL)
    grads = dict(zip(names, tg))
    for n, g in grads.items():
        if n != BIAS:
            assert g.abs().max() > 0, n
    for n in ("attn.kv_b.w", "attn.kv_a.w", "attn.o.w",
              "attn.q_b.w" if name == "v3" else "attn.q.w"):
        assert f"0.dense_layers.{n}" in grads and f"0.moe_layers.{n}" in grads
    assert "0.moe_layers.moe.router.w" in grads and "0.moe_layers.moe.shared.up_proj.w" in grads
    if name == "v3":
        assert grads[BIAS].shape == tp["moe_layers"]["moe"]["router"]["bias"].shape
        assert not grads[BIAS].any() and not np.asarray(jleaves[names.index(BIAS)]).any()


def test_update_step_matches_jax(family):
    """One make_update_fn step of the port (clip, Adam with f32 mu, decayed
    weights of 0.1, lr 1e-3) against the same optax chain applied to JAX's
    gradients of the same weights and batch (what JAX's make_update_fn
    does after its value_and_grad): the loss, the grad norm, the params
    after the step and Adam's mu. The V3 correction bias moves by the weight
    decay alone on both sides (its mu stays 0)."""
    name, _, tree, tcfg, head, (jloss, _), jg = family
    packed = _packed()
    lr, wd = 1e-3, 0.1
    chain = optax.chain(optax.clip_by_global_norm(1.0),
                        optax.scale_by_adam(b1=0.9, b2=0.999, mu_dtype=jnp.float32),
                        optax.add_decayed_weights(wd), optax.scale_by_learning_rate(lr))
    def jstep(g, params):
        state = chain.init(params)
        updates, state = chain.update(g, state, params)
        return optax.apply_updates(params, updates), state, optax.global_norm(g)

    (jp, jh), jstate, jnorm = jax.jit(jstep)(jg, jax.tree_util.tree_map(jnp.asarray,
                                                                         (tree, head)))

    tp, th = loader.params_from_numpy(tree), loader.params_from_numpy(head)
    opt = topt.AdamChain(topt.constant_schedule(lr), max_grad_norm=1.0, weight_decay=wd)
    tstate = opt.init(tl.tree_leaves((tp, th)))
    tstep = tl.make_update_fn(tcfg, opt, loss_kwargs=dict(LOSS_KW, remat="full"))
    tp, th, tstate, tm = tstep(tp, th, tstate, tl.batch_to_device(packed, "cpu"))

    np.testing.assert_allclose(float(tm["loss"]), float(jloss), **GRAD_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jnorm), **GRAD_TOL)
    names = _names(tp, th)
    before = jax.tree_util.tree_leaves((tree, head))
    after = jax.tree_util.tree_leaves((jp, jh))
    mu = jax.tree_util.tree_leaves(jstate[1].mu)
    assert len(names) == len(after) == len(mu) == len(tstate["mu"])
    for n, t, j, tmu, jmu in zip(names, tl.tree_leaves((tp, th)), after, tstate["mu"], mu):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), err_msg=n, **GRAD_TOL)
        np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), err_msg=f"mu {n}", **GRAD_TOL)
    moved = {n: float(np.abs(np.asarray(a) - b).max()) for n, a, b in zip(names, after, before)}
    assert moved["0.moe_layers.attn.kv_b.w"] > 5e-4 and moved["0.dense_layers.attn.kv_b.w"] > 5e-4
    if name == "v3":
        i = names.index(BIAS)
        assert not tstate["mu"][i].any()
        bias = before[i]
        np.testing.assert_allclose(tl.tree_leaves((tp, th))[i].detach().numpy(),
                                   bias - lr * wd * bias, **GRAD_TOL)


def test_ref_logps_match_jax(family):
    """ref_logps_fn on a DeepSeek tree goes through the DeepSeek forward
    (models.model_module), as JAX's does: the masked per-token logps of the
    packed batch within 1e-4."""
    _, jcfg, tree, tcfg = family[:4]
    packed = _packed()
    jlp = jl.ref_logps_fn(jax.tree_util.tree_map(jnp.asarray, tree), _jbatch(packed), jcfg, 0.7)
    tlp = tl.ref_logps_fn(loader.params_from_numpy(tree), tl.batch_to_device(packed, "cpu"),
                          tcfg, 0.7)
    assert tlp.shape == (4, packed["ids"].shape[1] - 1) and not tlp.requires_grad
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4, rtol=0)


# ---------------------------------------------------------------- the remat rule

def test_remat_truthy_values_recompute_with_the_same_gradients(monkeypatch):
    """remat True, "full" and the named policy "save_qkv" each recompute
    every layer body in the backward (JAX checkpoints the layer scan on any
    truthy value) and give the gradients of remat False, bit for bit."""
    _, _, tcfg, tree = _pair(3)
    packed = tl.batch_to_device(_packed(), "cpu")
    head = {"w": torch.full((tcfg.hidden_size,), 0.01), "b": torch.zeros(())}
    calls = []
    body = td._layer_body

    def counting(*a, **kw):
        calls.append(1)
        return body(*a, **kw)

    monkeypatch.setattr(td, "_layer_body", counting)
    grads = {}
    for remat in (False, True, "full", "save_qkv"):
        p = tl.tree_map(lambda t: t.detach().clone(), tree)
        h = tl.tree_map(lambda t: t.detach().clone(), head)
        leaves = tl._trainable(p, h)
        del calls[:]
        loss, _ = tl.loss_and_metrics(p, h, packed, tcfg, remat=remat, **LOSS_KW)
        grads[remat] = tl._grads(loss, leaves)
        assert len(calls) == tcfg.num_hidden_layers * (2 if remat else 1), remat
    for remat in (True, "full", "save_qkv"):
        for a, b in zip(grads[remat], grads[False]):
            assert torch.equal(a, b), remat


# ---------------------------------------------------------------- the trainer

def test_trainer_builds_and_steps_on_a_deepseek_tree(tmp_path, monkeypatch):
    """MTPOTrainer on a tiny DeepSeek tree builds its Engine, ValueFunction,
    update and value-sum-of-squares functions, and one train_step (the
    scripted FakeEngine's rollout, a fake reward, gradient checkpointing
    with a named policy and the KL reference of beta 1e-8) updates the
    tree in place; save_model (which raised until it was ported) writes the
    DeepSeek export and both value-head files, read back bit-equal. The metrics
    go to the JSONL file only (TensorBoard's import pulls in TensorFlow
    here, ~10 s)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _, _, tcfg, params = _pair(5, vocab_size=1024)
    args = _args(tmp_path, depth=2, num_sim=2, learning_rate=1e-3, warmup_ratio=0.0,
                 gradient_checkpointing=True, remat_policy="save_qkv", beta=1e-8)
    tok = ChatTok()
    trainer = MTPOTrainer(model=(params, tcfg), agent_cls_list=[PoorAgent], args=args,
                          reward_fns=[_reward], train_dataset=DATASET, tokenizer=tok)
    assert trainer.engine._mod is td
    trainer.engine = FakeEngine(tok, script=[
        (r"STEP-2", ["done </think> <answer>4</answer>", "done2 </think> <answer>7</answer>"]),
        (r".", ["go </think> on", "go2 </think> on"]),
    ])
    kv_b = params["moe_layers"]["attn"]["kv_b"]["w"]
    m = trainer.train_step(DATASET)
    assert trainer.global_step == 1 and trainer.opt_state["count"] == 1
    assert m["n_samples"] > 0 and np.isfinite(m["loss"]) and m["grad_norm"] > 0
    assert trainer.params["moe_layers"]["attn"]["kv_b"]["w"] is kv_b  # the tree itself
    names = _names(trainer.params, trainer.head)
    for leaf in ("0.moe_layers.attn.kv_b.w", "0.dense_layers.attn.kv_b.w",
                 "0.moe_layers.moe.experts.down_proj.w"):  # the first moment of the update
        assert trainer.opt_state["mu"][names.index(leaf)].abs().max() > 0, leaf
    assert trainer.ref_params is not None  # the KL reference ran on the DeepSeek tree
    out = str(tmp_path / "hf")
    trainer.save_model(out)
    back, _ = loader.load_params(out, cfg=tcfg, dtype=torch.float32, device="cpu")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(trainer.params)):
        assert torch.equal(a, b.detach())
    for name in ("value_head.npz", "value_head.pt"):
        h = loader.load_value_head(os.path.join(out, name), tcfg.hidden_size, device="cpu")
        assert all(torch.equal(h[k], trainer.head[k].detach()) for k in ("w", "b")), name


def test_dense_only_deepseek_trains():
    """A DeepSeek config without routed experts has only the dense group;
    its loss gradients reach every leaf."""
    _, _, tcfg, tree = _pair(4, n_routed_experts=0)
    assert "moe_layers" not in tree
    packed = tl.batch_to_device(_packed(), "cpu")
    head = {"w": torch.full((tcfg.hidden_size,), 0.01), "b": torch.zeros(())}
    leaves = tl._trainable(tree, head)
    loss, _ = tl.loss_and_metrics(tree, head, packed, tcfg, remat="full", **LOSS_KW)
    for n, g in zip(_names(tree, head), tl._grads(loss, leaves)):
        assert g.abs().max() > 0, n
