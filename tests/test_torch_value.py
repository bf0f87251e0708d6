"""lapha_tpu_torch value path against lapha_tpu (CPU, f32, tiny config):
value_forward, ValueFunction (bucketed __call__ and from_pooled) and the
potential V over the scored states. Tolerance atol 1e-5 on ball points and
values, 1e-4 on pooled hidden states (f32 summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import qwen2 as jq
from lapha_tpu.models import value_model as jvm
from lapha_tpu.ops import potential_v as j_potential_v
from lapha_tpu.search.value_fn import ValueFunction as JValueFunction
from lapha_tpu_torch.models import loader, qwen2, value_model
from lapha_tpu_torch.ops import potential_v
from lapha_tpu_torch.search import ValueFunction


@pytest.fixture(scope="module")
def setup():
    jcfg = JCfg.tiny(vocab_size=300)
    jp = jq.init_params(jcfg, jax.random.key(2))
    jhead = jvm.init_value_head(jcfg.hidden_size, jax.random.key(3))
    np_tree = jax.tree_util.tree_map(np.asarray, {"p": jp, "h": jhead})
    tp = loader.params_from_numpy(np_tree["p"])
    thead = loader.params_from_numpy(np_tree["h"])
    kw = dict(pad_multiple=32, batch_bucket=4)
    return (JValueFunction(jp, jhead, jcfg, **kw),
            ValueFunction(tp, thead, qwen2.Qwen2Config.tiny(vocab_size=300), **kw))


def _batch(rng, B, L):
    ids = rng.integers(0, 300, (B, L))
    attn = np.ones((B, L), np.int32)
    attn[1, 30:] = 0
    resp = np.zeros((B, L), np.int32)
    resp[:, 20:] = 1
    return ids, attn, resp


def test_value_forward_matches_jax(setup):
    jvf, tvf = setup
    rng = np.random.default_rng(0)
    ids, attn, resp = _batch(rng, 3, 40)
    root = rng.normal(size=(64,)).astype(np.float32)
    jy, jv, jh = jvm.value_forward(jvf.params, jvf.head, jvf.cfg, jnp.asarray(ids),
                                   jnp.asarray(attn), jnp.asarray(resp), None, jnp.asarray(root))
    ty, tv, th = value_model.value_forward(tvf.params, tvf.head, tvf.cfg, torch.from_numpy(ids),
                                           torch.from_numpy(attn), torch.from_numpy(resp), None,
                                           torch.from_numpy(root))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def test_value_function_and_from_pooled_match_jax(setup):
    """Root scored by a value forward, children by from_pooled with the
    root's h0 as centre, then V over the children against a goal anchor."""
    jvf, tvf = setup
    rng = np.random.default_rng(1)
    ids, attn, resp = _batch(rng, 3, 45)  # B=3 pads to the bucket of 4, L to 64
    jy, jv, jh0 = jvf(ids, attn, response_mask=resp, return_h0=True)
    ty, tv, th0 = tvf(ids, attn, response_mask=resp, return_h0=True)
    np.testing.assert_allclose(th0, jh0, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ty, jy, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
    assert ty.shape == (3, 64) and tv.shape == (3,)

    root_h0 = jh0[0]
    pooled = rng.normal(size=(6, 64)).astype(np.float32) + root_h0
    jyc, jvc = jvf.from_pooled(pooled, root_h0=root_h0)
    tyc, tvc = tvf.from_pooled(pooled, root_h0=root_h0)
    np.testing.assert_allclose(tyc, jyc, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tvc, jvc, atol=1e-5, rtol=0)

    # a goal anchor away from every child: at a coincident point d_goal is
    # arccosh(1 + ulps), where last-ulp differences are amplified
    anchor = 0.5 * (tyc[:1] + tyc[1:2])
    zero = np.zeros(64, np.float32)
    V = potential_v(torch.from_numpy(tyc), torch.from_numpy(zero), torch.from_numpy(anchor))
    jV = j_potential_v(jnp.asarray(jyc), jnp.asarray(zero), jnp.asarray(anchor))
    np.testing.assert_allclose(V.numpy(), np.asarray(jV), atol=1e-5, rtol=0)
    assert float(V.min()) >= 0.0 and float(V.max()) <= 1.0
