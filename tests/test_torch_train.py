"""The port's training pieces against lapha_tpu.train (CPU, f32): packing,
advantages, the GRPO/value loss and every gradient leaf, remat, the
optimizer chain and reward shaping, on the same numpy inputs.

The JAX loss runs with ``attn_impl="pallas"`` (its flash forward and K2
backward in interpret mode); the port's with its plain attention, through
the same autograd Function as on the card. Tolerances:
- packing and advantages: exact (the same numpy code);
- loss and gradient leaves: atol 1e-4 + rtol 1e-4 — f32 summation order
  differs (XLA vs PyTorch, blocked vs dense attention, chunked log-softmax);
- optimizer: params within 1e-5 after two steps on the same gradients;
- shaping: V-map, rewards and flags within 1e-6 (f32 geodesics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import qwen2 as jq
from lapha_tpu.models import value_model as jvm
from lapha_tpu.search import LatentBank as JBank
from lapha_tpu.train import ShapingConfig as JShaping
from lapha_tpu.train import compute_action_rewards as j_rewards
from lapha_tpu.train import losses as jl
from lapha_tpu_torch.models import loader as tloader
from lapha_tpu_torch.models import qwen2 as tq
from lapha_tpu_torch.search import LatentBank as TBank
from lapha_tpu_torch.train import ShapingConfig as TShaping
from lapha_tpu_torch.train import compute_action_rewards as t_rewards
from lapha_tpu_torch.train import losses as tl
from lapha_tpu_torch.train import optim as topt

GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg = JCfg.tiny(attn_impl="pallas")
    jp = jq.init_params(jcfg, jax.random.key(0))
    jh = jvm.init_value_head(jcfg.hidden_size, jax.random.key(1))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return jcfg, jp, jh, tq.Qwen2Config.tiny(), to_np(jp), to_np(jh)


def _samples(vocab, B=4, seed=0):
    rng = np.random.default_rng(seed)
    # ragged completion lengths so grpo/bnpo/dr_grpo normalizations differ;
    # row 1 carries an EOS (id 1) mid-completion
    out = [dict(prompt_ids=rng.integers(2, vocab, 6).tolist(),
                completion_ids=rng.integers(2, vocab, 3 + 2 * i).tolist()) for i in range(B)]
    out[1]["completion_ids"][2] = 1
    return out


def _packed(vocab):
    packed = jl.pack_samples(_samples(vocab), pad_id=0, eos_id=1, max_prompt_length=64,
                             pad_multiple=16, batch_multiple=8)
    Bb = packed["ids"].shape[0]
    packed["advantages"] = np.r_[1.0, -0.5, 0.5, -0.2, np.zeros(Bb - 4)].astype(np.float32)
    packed["v_target"] = np.r_[1.0, 0.0, 0.5, 0.2, np.zeros(Bb - 4)].astype(np.float32)
    return packed


def _tparams(np_tree):
    return tloader.params_from_numpy(np_tree)


def test_packing_and_advantages_equal_jax():
    samples = _samples(500, B=6) + [dict(prompt_ids=[0, 0], completion_ids=[5])]
    for pad_id, eos_id in ((0, 1), (1, 1)):
        a = jl.pack_samples(samples, pad_id, eos_id, max_prompt_length=5, pad_multiple=8,
                            batch_multiple=4)
        b = tl.pack_samples(samples, pad_id, eos_id, max_prompt_length=5, pad_multiple=8,
                            batch_multiple=4)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    r = np.array([1.0, 0.0, 1.0, 1.0, 0.3, 0.9])
    g = np.array([0, 0, 1, 1, 2, 2])
    for scale in ("none", "group", "batch", True, False):
        np.testing.assert_array_equal(tl.group_advantages(r, g, scale),
                                      jl.group_advantages(r, g, scale))


@pytest.mark.parametrize("loss_type,level,beta,old", [
    ("grpo", "token", 0.0, False),
    ("bnpo", "sequence", 0.1, False),
    ("dr_grpo", "token", 0.1, True),
])
def test_loss_and_every_gradient_leaf_match_jax(models, loss_type, level, beta, old):
    jcfg, jp, jh, tcfg, np_p, np_h = models
    packed = _packed(jcfg.vocab_size)
    kw = dict(temperature=0.7, eps_low=0.2, eps_high=0.28, loss_type=loss_type,
              importance_level=level, value_w=0.5, beta=beta, max_completion_length=16)
    rng = np.random.default_rng(3)
    L = packed["ids"].shape[1]
    # a reference/old policy that differs from the current one, so the KL
    # term and the PPO ratio/clip are live
    ref = (rng.normal(size=(8, L - 1)) * 0.3 - 6.0).astype(np.float32) if beta else None
    old_lp = (rng.normal(size=(8, L - 1)) * 0.3 - 6.0).astype(np.float32) if old else None

    jbatch = {k: jnp.asarray(v) for k, v in packed.items() if k != "kept"}
    jkw = dict(kw, remat=False,
               ref_logps=None if ref is None else jnp.asarray(ref),
               old_logps=None if old_lp is None else jnp.asarray(old_lp))
    (jloss, jm), jg = jax.value_and_grad(
        lambda ph: jl.loss_and_metrics(ph[0], ph[1], jbatch, jcfg, **jkw),
        has_aux=True)((jp, jh))

    tp, th = _tparams(np_p), _tparams(np_h)
    leaves = tl._trainable(tp, th)
    tbatch = tl.batch_to_device(packed, "cpu")
    tloss, tm = tl.loss_and_metrics(
        tp, th, tbatch, tcfg, remat=True, logits_chunk=8,
        ref_logps=None if ref is None else torch.from_numpy(ref),
        old_logps=None if old_lp is None else torch.from_numpy(old_lp), **kw)
    tg = torch.autograd.grad(tloss, leaves)

    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **GRAD_TOL)
    for key in ("policy_loss", "value_loss", "kl", "v_pred_mean", "completion_tokens"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), err_msg=key, **GRAD_TOL)
    jpaths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path((jp, jh))]
    tpaths = [p for p, _ in tl.tree_paths((tp, th))]
    assert len(jpaths) == len(tpaths)
    for name, a, b in zip(tpaths, tg, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_ref_logps_fn_matches_jax(models, temperature):
    """The frozen per-token logps of the KL term and of num_iterations > 1."""
    jcfg, jp, _, tcfg, np_p, _ = models
    packed = _packed(jcfg.vocab_size)
    j = jl.ref_logps_fn(jp, {k: jnp.asarray(v) for k, v in packed.items() if k != "kept"},
                        jcfg, temperature)
    t = tl.ref_logps_fn(_tparams(np_p), tl.batch_to_device(packed, "cpu"), tcfg, temperature)
    assert not t.requires_grad and t.shape == j.shape
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)


@pytest.mark.parametrize("remat", [False, "full"])
def test_value_sumsq_grad_fn_matches_jax(models, remat):
    """The all-nodes value MSE's micro-batch (sum of squares, count, every
    gradient leaf of the sum)."""
    jcfg, jp, jh, tcfg, np_p, np_h = models
    packed = _packed(jcfg.vocab_size)
    jsq, jcnt, jg = jl.make_value_sumsq_grad_fn(jcfg, remat=remat)(
        jp, jh, {k: jnp.asarray(v) for k, v in packed.items() if k != "kept"})
    tsq, tcnt, tg = tl.make_value_sumsq_grad_fn(tcfg, remat=remat)(
        _tparams(np_p), _tparams(np_h), tl.batch_to_device(packed, "cpu"))
    np.testing.assert_allclose(float(tsq), float(jsq), **GRAD_TOL)
    assert float(tcnt) == float(jcnt) == 4.0
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(tg) == len(jleaves)
    for a, b in zip(tg, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    assert max(float(a.abs().max()) for a in tg[:-2]) > 0  # reaches the LM, not the head only


def test_remat_full_equals_no_remat(models):
    """remat "full" recomputes each layer in the backward: same loss and grads."""
    _, _, _, tcfg, np_p, np_h = models
    packed = _packed(tcfg.vocab_size)
    kw = dict(temperature=1.0, eps_low=0.2, eps_high=0.2, loss_type="grpo",
              importance_level="token", value_w=1.0, beta=0.0, max_completion_length=16)
    out = []
    for remat in (False, "full"):
        tp, th = _tparams(np_p), _tparams(np_h)
        leaves = tl._trainable(tp, th)
        loss, _ = tl.loss_and_metrics(tp, th, tl.batch_to_device(packed, "cpu"), tcfg,
                                      remat=remat, **kw)
        out.append((float(loss), torch.autograd.grad(loss, leaves)))
    assert out[0][0] == pytest.approx(out[1][0], abs=1e-7)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tq.remat_policy("save_qkv")


@pytest.mark.parametrize("every_k", [1, 2])
def test_optimizer_chain_matches_optax(every_k):
    """clip_by_global_norm -> adam(mu f32) -> decayed weights -> warmup-cosine
    lr (the JAX trainer's chain, trainer.py:177-207), MultiSteps for k > 1:
    params after two applied steps on the same gradients."""
    rng = np.random.default_rng(every_k)
    shapes = [(5, 7), (7,), (3, 2, 4)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    # step 1 is clipped (norm > 1), the later ones are not
    grads = [[rng.normal(size=s).astype(np.float32) * sc for s in shapes]
             for sc in (3.0, 0.05, 0.04, 0.02)]
    lr, total, warmup, wd = 1e-2, 10, 1, 0.1

    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(total, warmup + 1))
    chain = optax.chain(optax.clip_by_global_norm(1.0),
                        optax.scale_by_adam(b1=0.9, b2=0.999, mu_dtype=jnp.float32),
                        optax.add_decayed_weights(wd), optax.scale_by_learning_rate(sched))
    if every_k > 1:
        chain = optax.MultiSteps(chain, every_k_schedule=every_k)
    jp = [jnp.asarray(p) for p in params]
    state = chain.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = topt.AdamChain(topt.trainer_schedule("cosine", lr, warmup, total), max_grad_norm=1.0,
                         weight_decay=wd, every_k=every_k)
    tstate = opt.init(tp)
    for g in grads[:2 * every_k]:
        upd, state = chain.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.apply(tp, [torch.from_numpy(x) for x in g], tstate)
    moved = max(float(np.abs(np.asarray(a) - p).max()) for a, p in zip(jp, params))
    assert moved > 1e-3  # the lr schedule is live on the second applied step
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    # optax's dtypes: mu in f32, nu in the parameter dtype
    st = topt.AdamChain(topt.constant_schedule(1e-3), max_grad_norm=1.0).init(
        [torch.zeros(3, dtype=torch.bfloat16)])
    assert st["mu"][0].dtype == torch.float32 and st["nu"][0].dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["linear", "constant", "cosine"])
def test_trainer_schedules_match_optax(kind):
    lr, warmup, total = 3e-4, 5, 40
    t = topt.trainer_schedule(kind, lr, warmup, total)
    if kind == "cosine":
        j = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total)
    elif kind == "linear":
        j = optax.join_schedules([optax.linear_schedule(0.0, lr, warmup),
                                  optax.linear_schedule(lr, 0.0, total - warmup)], [warmup])
    else:
        j = optax.join_schedules([optax.linear_schedule(0.0, lr, warmup),
                                  optax.constant_schedule(lr)], [warmup])
    for c in (0, 1, 4, 5, 6, 20, 39, 40, 60):
        # optax evaluates schedules in f32, the port in f64: ~1e-6 relative
        assert t(c) == pytest.approx(float(j(c)), rel=1e-5, abs=1e-12)


def _chain_tree():
    """root -> a -> {b_correct(terminal), c_wrong(terminal)} (tests/test_train.py)."""
    root = dict(completion="", current_depth=0, prompt_ids=[1], completion_ids=[],
                hid_idx=0, v_pred=0.5)
    a = dict(completion="STEP-1:\n<think>t</think>", current_depth=1,
             prompt_ids=[1], completion_ids=[2], hid_idx=1, v_pred=0.6)
    b = dict(completion="STEP-2:\n<think>u</think>\n<answer>4</answer>", current_depth=2,
             prompt_ids=[1, 2], completion_ids=[3], hid_idx=2, v_pred=0.9)
    c = dict(completion="STEP-2:\n<think>v</think>\n<answer>7</answer>", current_depth=2,
             prompt_ids=[1, 2], completion_ids=[4], hid_idx=3, v_pred=0.2)
    return root, [[a, b], [a, c]]


@pytest.mark.parametrize("case", ["semantics", "dead_tree", "cot_anchor", "no_adaptive"])
def test_compute_action_rewards_matches_jax(case):
    pts = np.array([[0.0, 0.0], [0.3, 0.0], [0.6, 0.0], [0.1, 0.5]], np.float32)
    if case == "dead_tree":
        pts = np.random.default_rng(0).normal(size=(4, 2)).astype(np.float32) * 0.1
    reward = ((lambda comp, gt: 0.0) if case == "dead_tree" else
              (lambda comp, gt: 1.0 if "<answer>4</answer>" in comp else 0.0))
    cot = np.array([[0.2, 0.4]], np.float32) if case == "cot_anchor" else None
    if case == "cot_anchor":
        reward = lambda comp, gt: 0.0  # noqa: E731 — the CoT is the only anchor
    kw = dict(depth=3, adaptive_fmt_bonus=case != "no_adaptive")
    out = []
    for bank_cls, cfg_cls, fn in ((JBank, JShaping, j_rewards), (TBank, TShaping, t_rewards)):
        root, chains = _chain_tree()
        bank = bank_cls()
        for p in pts:
            bank.add(p)
        res = fn(chains, [reward], "4", cfg_cls(**kw), bank=bank, root_step=root,
                 cot_anchor=cot)
        steps = [root] + [chains[0][0], chains[0][1], chains[1][1]]
        out.append((res, steps))
    (ja, jp1, jd), jsteps = out[0]
    (ta, tp1, td), tsteps = out[1]
    assert (ta, tp1) == (ja, jp1)
    assert td.keys() == jd.keys()
    for key in jd:
        assert td[key] == pytest.approx(jd[key], abs=1e-6), key
    for js, ts in zip(jsteps, tsteps):
        for key in ("win_rate", "is_leaf", "is_correct", "on_path", "v_target", "reward"):
            if isinstance(js.get(key), float):
                assert ts[key] == pytest.approx(js[key], abs=1e-6), key
            else:
                assert ts.get(key) == js.get(key), key
