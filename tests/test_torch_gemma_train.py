"""lapha_tpu_torch's Gemma training path against lapha_tpu (CPU, f32, tiny
configs): the flash-attention backward at head dim 256 (with and without
the logit softcap, windowed and full), every gradient leaf of
``losses.loss_and_metrics`` and one ``make_update_fn`` step for gemma2 and
gemma3_text, and Gemma-2's training log-probs, which apply no final
softcap on either side (ROADMAP C2 (e)).

The tiny configs are the published Gemma-2-2B and Gemma-3-1B dicts cut to 4
layers, H 64, 4/2 heads of dim 16 and 8-token windows (Gemma-3 alternating
sliding and global layers), ``query_pre_attn_scalar`` 24. Gemma-2's caps are
5 on the attention logits and 2 on the final ones, and its q/k projections
and embedding are scaled up (x8, x10, as tests/test_torch_gemma.py does) so
that the logits reach 1-3x the caps; the gradient tests also run with the
softcap planted off and must then fail.

The JAX side runs as its own tests run it on the CPU: ``attn_impl="pallas"``
puts its flash forward and K2 backward (``_dq_kernel``, ``_dkv_kernel``, the
softcap's chain rule) in interpret mode; the port runs its plain attention
through the same autograd Function as on the card, remat "full". Weights
are the port's init carried to both sides through numpy.

Tolerances: the plain backward within 1e-4 of jax.grad of the interpret-mode
kernels (the same f32 products summed in another order); loss, metrics,
gradient leaves, params after one step and Adam's mu within atol 1e-4 +
rtol 1e-4 (as the dense and MoE models' training tests: XLA and PyTorch sum
in other orders, the log-softmax is chunked), the update at lr 1e-3 (see
tests/test_torch_moe_train.py), plus the difference the two sides' own
gradients make to Adam's first step (up to 2·lr on an element whose
gradient is f32 noise near 0 and flips sign; 0 where the gradients agree in
sign or are 0); the log-probs within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import GEMMA2_2B_CONFIG, GEMMA3_1B_CONFIG, _max_logits
from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import value_model as jvm
from lapha_tpu.ops import flash_attention as jfa
from lapha_tpu.train import losses as jl
from lapha_tpu_torch.models import loader, qwen2
from lapha_tpu_torch.ops import flash_attention as tfa
from lapha_tpu_torch.train import losses as tl
from lapha_tpu_torch.train import optim as topt

ATOL = 1e-4
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
V = 300
CAP = 5.0        # the tiny Gemma-2's attention softcap
FINAL_CAP = 2.0  # and its final one
TINY = dict(num_hidden_layers=4, hidden_size=64, intermediate_size=128, vocab_size=V,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16, sliding_window=8,
            query_pre_attn_scalar=24.0)
FAMILIES = {
    "gemma2": dict(GEMMA2_2B_CONFIG, attn_logit_softcapping=CAP,
                   final_logit_softcapping=FINAL_CAP, **TINY),
    "gemma3": dict(GEMMA3_1B_CONFIG, sliding_window_pattern=2, **TINY),
}
LOSS_KW = dict(temperature=0.7, eps_low=0.2, eps_high=0.28, loss_type="grpo",
               importance_level="token", value_w=0.5, beta=0.0, max_completion_length=16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- K2 at head dim 256

@pytest.mark.parametrize("softcap", [0.0, CAP])
@pytest.mark.parametrize("window", [0, 8])
def test_dh256_backward_matches_pallas_interpret(softcap, window):
    """dq, dk, dv of the port's autograd Function on the CPU (the plain
    backward the card's K2 is held to) at head dim 256, Gemma's scale 1/16,
    4/2 heads, a padded row: against jax.grad of the Pallas custom_vjp in
    interpret mode. With the softcap |s| reaches ~4x the cap, and the plain
    backward without it fails the same check."""
    rng = np.random.default_rng(30 + window + int(softcap))
    B, T, nh, nkv, dh = 2, 24, 4, 2, 256
    q = (rng.normal(size=(B, T, nh, dh)) * (6.0 if softcap else 1.0)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, nkv, dh)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(B, T, nh, dh)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, 17:] = 0
    real = mask[:, :, None, None].astype(np.float32)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), window=window, softcap=softcap,
                                  scale=1.0 / 16, block_q=8, block_k=8, interpret=True)
        return jnp.sum(out * jnp.asarray(do * real))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, _t(mask), window=window, softcap=softcap, scale=1.0 / 16)
    tg = torch.autograd.grad(out, leaves, _t(do * real))
    for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=name)
    if softcap:
        s = np.einsum("btkgd,bskd->bkgts", q.reshape(B, T, nkv, 2, dh), k) / 16
        assert np.abs(s).max() > 3 * softcap  # the cap bites
        out = tfa.flash_attention(*leaves, _t(mask), window=window, scale=1.0 / 16)
        bad = torch.autograd.grad(out, leaves[0], _t(do * real))[0]
        assert np.abs(bad.numpy() - np.asarray(jg[0])).max() > 100 * ATOL


# ---------------------------------------------------------------- the model: gradients, update

def _configs(family):
    j = dataclasses.replace(JCfg.from_hf(FAMILIES[family]), dtype=jnp.float32,
                            attn_impl="pallas")
    t = dataclasses.replace(qwen2.Qwen2Config.from_hf(FAMILIES[family]), dtype=torch.float32)
    return j, t


def _trees(family):
    """The port's init for ``family`` as one numpy tree, with random norm
    scales and (Gemma-2) q/k projections x8 and the embedding x10 so that
    both caps bite, and a value head."""
    _, tcfg = _configs(family)
    tree = jax.tree_util.tree_map(lambda t: t.numpy(),
                                  qwen2.init_params(tcfg, torch.Generator().manual_seed(5)))
    rng = np.random.default_rng(41)
    layers = tree["layers"]
    for name in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                 "post_feedforward_layernorm"):
        s = layers[name]["scale"]
        layers[name]["scale"] = (1.0 + rng.normal(size=s.shape) * 0.3).astype(np.float32)
    if family == "gemma2":
        tree["embed"]["weight"] = tree["embed"]["weight"] * np.float32(10.0)
        for p in ("q_proj", "k_proj"):
            layers["attn"][p]["w"] = layers["attn"][p]["w"] * np.float32(8.0)
    head = jax.tree_util.tree_map(np.asarray,
                                  jvm.init_value_head(tcfg.hidden_size, jax.random.key(1)))
    return tree, head


def _packed():
    """4 ragged rows of 12-token prompts and 5-15-token completions (32
    columns: past the 8-token windows), advantages and value targets."""
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


def _port_grads(tree, head, packed, tcfg):
    tp, th = loader.params_from_numpy(tree), loader.params_from_numpy(head)
    leaves = tl._trainable(tp, th)
    loss, metrics = tl.loss_and_metrics(tp, th, tl.batch_to_device(packed, "cpu"), tcfg,
                                        remat="full", logits_chunk=8, **LOSS_KW)
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, grads, [p for p, _ in tl.tree_paths((tp, th))]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gemma_loss_gradients_match_jax(family):
    """torch.autograd.grad of loss_and_metrics (remat "full") against
    jax.grad of JAX's, every leaf: the embedding, q/k/v/o, the four sandwich
    norms, the MLP, Gemma-3's q/k norms, the final norm and the value head.
    For Gemma-2 the attention logits reach past the cap, and the port with
    its softcap planted off misses JAX's gradients."""
    jcfg, tcfg = _configs(family)
    tree, head = _trees(family)
    packed = _packed()
    assert packed["ids"].shape[1] > 8  # past the windows
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda ph: jl.loss_and_metrics(ph[0], ph[1], _jbatch(packed), jcfg, remat=False,
                                       **LOSS_KW), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, (tree, head)))
    tloss, tm, tg, names = _port_grads(tree, head, packed, tcfg)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **GRAD_TOL)
    for key in ("policy_loss", "value_loss", "v_pred_mean", "completion_tokens"):
        np.testing.assert_allclose(float(torch.as_tensor(tm[key]).detach()), float(jm[key]),
                                   err_msg=key, **GRAD_TOL)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(names) == len(jleaves)
    for name, a, b in zip(names, tg, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)
    grads = dict(zip(names, tg))
    for name in names:  # every weight of every layer gets a gradient
        if name.startswith("0.layers.") and not name.endswith(".b"):
            assert (grads[name].flatten(1).abs().amax(1) > 0).all(), name
    if family == "gemma2":
        s_max, _ = _max_logits(loader.params_from_numpy(tree), tcfg,
                               tl.batch_to_device(packed, "cpu"))
        assert s_max > 2 * CAP
        _, _, bad, _ = _port_grads(tree, head, packed,
                                   dataclasses.replace(tcfg, attn_softcap=0.0))
        i = names.index("0.layers.attn.q_proj.w")
        assert np.abs(bad[i].numpy() - np.asarray(jleaves[i])).max() > 100 * GRAD_TOL["atol"]


def _step_dir(mu):
    """Adam's first step over lr for each element: it moves by
    lr·g/(|g| + 1e-8), g the clipped gradient (= 10·mu)."""
    g = 10.0 * np.asarray(mu, np.float64)
    return g / (np.abs(g) + 1e-8)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gemma_update_step_matches_jax(family):
    """One make_update_fn step (clip, Adam with f32 mu, lr 1e-3) of each side
    on the same weights and batch: loss, grad norm, Adam's mu, and the params
    after the step within GRAD_TOL plus the difference that the two sides'
    own gradients make to the step, lr·|dir_jax - dir_port|
    (:func:`_step_dir`). That is 0 where both gradients agree in sign (to
    ~1e-8) or are 0, and up to 2·lr where a gradient is f32 noise near 0
    and its sign differs (Gemma-2's layer-0 k_proj has one such element, at
    ~1e-6 against a largest ~0.17); the gradients themselves are held to
    GRAD_TOL through Adam's mu."""
    jcfg, tcfg = _configs(family)
    tree, head = _trees(family)
    packed = _packed()
    lr = 1e-3
    chain = optax.chain(optax.clip_by_global_norm(1.0),
                        optax.scale_by_adam(b1=0.9, b2=0.999, mu_dtype=jnp.float32),
                        optax.scale_by_learning_rate(lr))
    jp, jh = jax.tree_util.tree_map(jnp.asarray, (tree, head))
    jstate = chain.init((jp, jh))
    jstep = jl.make_update_fn(jcfg, chain, loss_kwargs=dict(LOSS_KW, remat=False))
    jp, jh, jstate, jm = jstep(jp, jh, jstate, _jbatch(packed))

    tp, th = loader.params_from_numpy(tree), loader.params_from_numpy(head)
    opt = topt.AdamChain(topt.constant_schedule(lr), max_grad_norm=1.0)
    tstate = opt.init(tl.tree_leaves((tp, th)))
    tstep = tl.make_update_fn(tcfg, opt, loss_kwargs=dict(LOSS_KW, remat="full"))
    tp, th, tstate, tm = tstep(tp, th, tstate, tl.batch_to_device(packed, "cpu"))

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **GRAD_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **GRAD_TOL)
    names = [p for p, _ in tl.tree_paths((tp, th))]
    before = jax.tree_util.tree_leaves((tree, head))
    after = jax.tree_util.tree_leaves((jp, jh))
    mu = jax.tree_util.tree_leaves(jstate[1].mu)
    assert len(names) == len(after) == len(mu) == len(tstate["mu"])
    moved = 0.0
    for name, t, j, j0, tmu, jmu in zip(names, tl.tree_leaves((tp, th)), after, before,
                                        tstate["mu"], mu):
        j, jmu = np.asarray(j), np.asarray(jmu)
        excess = (np.abs(t.detach().numpy() - j) - GRAD_TOL["atol"] - GRAD_TOL["rtol"] * np.abs(j)
                  - lr * np.abs(_step_dir(jmu) - _step_dir(tmu.numpy())))
        assert excess.max() <= 0, (name, float(excess.max()))
        np.testing.assert_allclose(tmu.numpy(), jmu, err_msg=f"mu {name}", **GRAD_TOL)
        moved = max(moved, float(np.abs(np.asarray(j) - j0).max()))
    assert moved > 5e-4  # the step moved the weights


# ---------------------------------------------------------------- C2 (e): no final softcap

def test_gemma2_training_logps_apply_no_final_softcap_like_jax():
    """Gemma-2's training log-probs (``_selective_logps_chunked``, the
    policy's log p of each target) from the same post-norm hidden states
    and tied head: the port equals JAX, and both are the log-softmax of the
    UNCAPPED logits (the engine samples from the capped ones: ROADMAP C2
    (e), kept for parity). The hidden states are scaled so that the logits
    reach past the final cap of 2, where a capped log-softmax differs."""
    jcfg, tcfg = _configs("gemma2")
    tree, _ = _trees("gemma2")
    rng = np.random.default_rng(7)
    hidden = rng.normal(size=(2, 12, TINY["hidden_size"])).astype(np.float32)
    targets = rng.integers(0, V, (2, 12)).astype(np.int32)
    temperature = 0.7
    j = jl._selective_logps_chunked(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                                    jnp.asarray(hidden), jnp.asarray(targets), temperature,
                                    chunk=8)
    t = tl._selective_logps_chunked(loader.params_from_numpy(tree), tcfg, _t(hidden),
                                    _t(targets), temperature, chunk=8)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL, rtol=0)
    logits = hidden @ tree["embed"]["weight"].T
    assert np.abs(logits).max() > 2 * FINAL_CAP

    def logps(z):
        z = z / temperature
        z = z - z.max(-1, keepdims=True)
        return np.take_along_axis(z - np.log(np.exp(z).sum(-1, keepdims=True)),
                                  targets[..., None], -1)[..., 0]

    np.testing.assert_allclose(np.asarray(j), logps(logits), atol=ATOL, rtol=0)
    capped = np.tanh(logits / FINAL_CAP) * FINAL_CAP
    assert np.abs(logps(capped) - np.asarray(j)).max() > 100 * ATOL
