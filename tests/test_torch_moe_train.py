"""lapha_tpu_torch's MoE training path against lapha_tpu (CPU, f32, tiny
configs): the grouped GEMM's backward (dX and the transposed grouped GEMM
``tgmm``), then every gradient leaf of ``losses.loss_and_metrics`` and one
``make_update_fn`` step for qwen2_moe (with a shared expert), qwen3_moe and
gpt_oss.

The JAX side runs as its own tests run it on the CPU: ``_grouped_gemm`` is
``jax.lax.ragged_dot`` there (its VJP the reference for dX and dW), and
megablox's Pallas ``gmm(..., transpose_rhs=True)`` and ``tgmm`` — the two
kernels of ``_gmm_bwd`` on the TPU — run in interpret mode. The models run
with ``moe_impl="gather"``, the exact implementation the port's "auto"
takes; the port runs remat "full". Weights are the port's init carried to
both sides through numpy, with random sinks and biases for gpt_oss (whose
window, 8, is shorter than the packed rows).

Tolerances: the plain dX and dW within 1e-5 of the largest reference entry
(the same f32 products summed in another order); an expert without rows
gets exact zeros on both sides. Loss, metrics, gradient leaves, params after
one step and Adam's mu within atol 1e-4 + rtol 1e-4 (as the dense model's
training tests: XLA and PyTorch sum in other orders, the log-softmax is
chunked); the update step at lr 1e-3 (its docstring says why).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import value_model as jvm
from lapha_tpu.ops import moe as jmoe
from lapha_tpu.train import losses as jl
from lapha_tpu_torch.models import loader, qwen2
from lapha_tpu_torch.ops import grouped_gemm as tgg
from lapha_tpu_torch.train import losses as tl
from lapha_tpu_torch.train import optim as topt
from test_torch_moe import RAGGED, _rows

GG_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
V = 300
FAMILIES = {
    # qwen2_moe: qkv bias, softmax-then-top-k, a sigmoid-gated shared expert
    "qwen2_moe": dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
                      shared_expert_intermediate_size=48, attention_bias=True),
    # qwen3_moe: per-head q/k norms, renormalised top-k, no shared expert
    "qwen3_moe": dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
                      norm_topk_prob=True, qk_norm=True, head_dim=24, attention_bias=False),
    # gpt_oss: sinks, o_proj bias, biased top-k router, fused gate|up experts
    # with biases and the clamped GLU; a sliding layer, then a full one
    "gpt_oss": dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
                    intermediate_size=32, num_attention_heads=4, num_key_value_heads=2,
                    head_dim=16, layer_windows=(8, 0), attn_sinks=True, o_proj_bias=True,
                    attention_bias=True, moe_style="gptoss", rms_norm_eps=1e-5,
                    rope_theta=150000.0),
}
LOSS_KW = dict(temperature=0.7, eps_low=0.2, eps_high=0.28, loss_type="grpo",
               importance_level="token", value_w=0.5, beta=0.0, max_completion_length=16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_rel(t_out, ref, rtol=GG_RTOL):
    ref = np.asarray(ref)
    err = float(np.abs(t_out.detach().numpy() - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


# ---------------------------------------------------------------- the grouped GEMM's backward

@pytest.mark.parametrize("sizes", [
    (3, 0, 1, 7, 0, 5),      # empty groups and a group of one row
    (0, 0, 16, 0, 0, 0),     # one expert takes every row
    (2, 0, 4, 0, 0, 3),      # rows past the groups: their dX is 0
] + RAGGED)
def test_grouped_gemm_backward_plain_matches_jax_vjp(sizes):
    """dX and dW of the port's autograd Function on the CPU (the plain dX and
    tgmm) against jax.vjp of _grouped_gemm (ragged_dot); the ragged cases
    are those of tests/test_torch_moe.py (the wgmma kernels' edges)."""
    rng = np.random.default_rng(sum(sizes))
    M, K, N = _rows(sizes), 24, 40
    gs = np.asarray(sizes, np.int32)
    xs = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(len(sizes), K, N)).astype(np.float32)
    dout = rng.normal(size=(M, N)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jmoe._grouped_gemm(a, b, jnp.asarray(gs)),
                     jnp.asarray(xs), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dout))
    txs, tw = _t(xs).requires_grad_(True), _t(w).requires_grad_(True)
    tdx, tdw = torch.autograd.grad(tgg.grouped_gemm(txs, tw, _t(gs)), (txs, tw), _t(dout))
    _close_rel(tdx, jdx)
    _close_rel(tdw, jdw)
    # the plain versions are the backward's own
    _close_rel(tgg.grouped_gemm_dx_plain(_t(dout), _t(w), _t(gs)), jdx)
    _close_rel(tgg.grouped_gemm_tgmm_plain(_t(xs), _t(dout), _t(gs)), jdw)
    assert not tdx[gs.sum():].any()
    for g in np.flatnonzero(gs == 0):
        assert not tdw[g].any() and not np.asarray(jdw[g]).any()


def test_grouped_gemm_backward_plain_matches_megablox_interpret():
    """The plain dX and dW against the two Pallas kernels of megablox's
    _gmm_bwd, gmm(transpose_rhs=True) and tgmm, in interpret mode: 4 groups
    (one empty) over 256 rows, K = N = 128 (megablox's tiles). tgmm writes
    exact zeros for the empty group, and so does the plain version."""
    mb = importlib.import_module("jax.experimental.pallas.ops.tpu.megablox.gmm")
    rng = np.random.default_rng(7)
    M, K, N = 256, 128, 128
    gs = np.array([100, 0, 60, 96], np.int32)
    xs = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(4, K, N)).astype(np.float32)
    dy = rng.normal(size=(M, N)).astype(np.float32)
    jdx = mb.gmm(jnp.asarray(dy), jnp.asarray(w), jnp.asarray(gs), jnp.float32,
                 transpose_rhs=True, interpret=True)
    jdw = mb.tgmm(jnp.asarray(xs.T), jnp.asarray(dy), jnp.asarray(gs), jnp.float32,
                  interpret=True)
    tdx = tgg.grouped_gemm_dx_plain(_t(dy), _t(w), _t(gs))
    tdw = tgg.grouped_gemm_tgmm_plain(_t(xs), _t(dy), _t(gs))
    _close_rel(tdx, jdx)
    _close_rel(tdw, jdw)
    assert not np.asarray(jdw[1]).any() and not tdw[1].any()


# ---------------------------------------------------------------- gradients and one update step

def _configs(family):
    kw = dict(vocab_size=V, tie_word_embeddings=False, **FAMILIES[family])
    return JCfg.tiny(moe_impl="gather", **kw), qwen2.Qwen2Config.tiny(**kw)


def _trees(family):
    """The port's init for ``family`` as one numpy tree (gpt_oss: random
    sinks, attention, router and expert biases; the init's are zero), and
    a value head."""
    _, tcfg = _configs(family)
    tree = jax.tree_util.tree_map(lambda t: t.numpy(),
                                  qwen2.init_params(tcfg, torch.Generator().manual_seed(5)))
    if family == "gpt_oss":
        rng = np.random.default_rng(31)
        a, m = tree["layers"]["attn"], tree["layers"]["moe"]
        a["sinks"] = (rng.normal(size=a["sinks"].shape) * 2.0).astype(np.float32)
        for leaf in (a["q_proj"], a["k_proj"], a["v_proj"], a["o_proj"],
                     m["experts"]["gate_up"], m["experts"]["down"]):
            leaf["b"] = (rng.normal(size=leaf["b"].shape) * 0.1).astype(np.float32)
        m["router"]["b"] = (rng.normal(size=m["router"]["b"].shape) * 0.5).astype(np.float32)
    head = jax.tree_util.tree_map(np.asarray,
                                  jvm.init_value_head(tcfg.hidden_size, jax.random.key(1)))
    return tree, head


def _packed():
    """4 ragged rows of 12-token prompts and 5-15-token completions (32
    columns: past gpt_oss's window of 8), advantages and value targets."""
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


@pytest.mark.parametrize("family", list(FAMILIES))
def test_moe_loss_gradients_match_jax(family):
    """torch.autograd.grad of loss_and_metrics (remat "full": the routing is
    recomputed in the backward) against jax.grad of JAX's, every leaf: the
    router (through the combine weights), every expert stack and bias, the
    shared expert and its gate, sinks, q/k/v/o and their biases."""
    jcfg, tcfg = _configs(family)
    tree, head = _trees(family)
    packed = _packed()
    assert packed["ids"].shape[1] > 8  # past gpt_oss's window
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda ph: jl.loss_and_metrics(ph[0], ph[1], _jbatch(packed), jcfg, remat=False,
                                       **LOSS_KW), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, (tree, head)))
    tp, th = loader.params_from_numpy(tree), loader.params_from_numpy(head)
    leaves = tl._trainable(tp, th)
    tloss, tm = tl.loss_and_metrics(tp, th, tl.batch_to_device(packed, "cpu"), tcfg,
                                    remat="full", logits_chunk=8, **LOSS_KW)
    tg = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **GRAD_TOL)
    for key in ("policy_loss", "value_loss", "v_pred_mean", "completion_tokens"):
        np.testing.assert_allclose(float(torch.as_tensor(tm[key]).detach()), float(jm[key]),
                                   err_msg=key, **GRAD_TOL)
    names = [p for p, _ in tl.tree_paths((tp, th))]
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(names) == len(jleaves)
    for name, a, b in zip(names, tg, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)
    grads = dict(zip(names, tg))
    moe = [n for n in names if ".moe." in n]
    assert any("router" in n for n in moe)
    for name in moe:  # the router and every expert leaf get a gradient
        assert grads[name].abs().max() > 0, name
    if family == "gpt_oss":
        assert grads["0.layers.attn.sinks"].abs().max() > 0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_moe_update_step_matches_jax(family):
    """One make_update_fn step (clip, Adam with f32 mu, lr 1e-3) of each side
    on the same weights and batch: params after the step and Adam's mu.
    Adam's first step moves an element by lr·g/(|g| + 1e-8), so an element
    whose gradient is near 1e-8 moves by an amount that f32 noise in g sets
    (qwen2_moe's o_proj has one at 4e-8 on both sides: 0.535 vs 0.563 of
    lr); at lr 1e-3 that stays under the 1e-4 the params are held to."""
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
    after = jax.tree_util.tree_leaves((jp, jh))
    mu = jax.tree_util.tree_leaves(jstate[1].mu)
    assert len(names) == len(after) == len(mu) == len(tstate["mu"])
    moved = 0.0
    for name, t, j, tmu, jmu in zip(names, tl.tree_leaves((tp, th)), after, tstate["mu"], mu):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), err_msg=f"mu {name}",
                                   **GRAD_TOL)
        moved = max(moved, float(np.abs(np.asarray(j) - np.asarray(
            jax.tree_util.tree_leaves((tree, head))[names.index(name)])).max()))
    assert moved > 5e-4  # the step moved the weights


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_optimizer_in_slices_equals_whole_leaves(monkeypatch, dtype):
    """The optimizer walks each leaf in flat slices (an MoE expert stack is
    too large for whole-leaf f32 temporaries on the card): with slices of 16
    elements, two clipped steps give the whole-leaf step's params and
    moments; only the global norm's f32 sum runs in another order."""
    rng = np.random.default_rng(9)
    shapes = [(3, 50, 7), (11,), (4, 5)]
    params = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype) for s in shapes]
    grads = [[torch.from_numpy((rng.normal(size=s) * 3.0).astype(np.float32)).to(dtype)
              for s in shapes] for _ in range(2)]
    out = []
    for slice_len in (topt.SLICE, 16):
        monkeypatch.setattr(topt, "SLICE", slice_len)
        leaves = [p.clone() for p in params]
        opt = topt.AdamChain(topt.constant_schedule(1e-2), max_grad_norm=1.0, weight_decay=0.1)
        state = opt.init(leaves)
        for g in grads:
            opt.apply(leaves, g, state)
        norm = topt.global_norm(grads[0])
        out.append((leaves, state, norm))
    (a, sa, na), (b, sb, nb) = out
    whole = torch.cat([g.float().reshape(-1) for g in grads[0]]).norm()
    np.testing.assert_allclose(float(na), float(whole), rtol=1e-6)
    np.testing.assert_allclose(float(nb), float(whole), rtol=1e-6)
    for x, y in zip(a + sa["mu"] + sa["nu"], b + sb["mu"] + sb["nu"]):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(), rtol=1e-5, atol=1e-7)
    assert max(float((x.float() - p.float()).abs().max()) for x, p in zip(a, params)) > 1e-3
