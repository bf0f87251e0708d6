"""The port's MCTS and latent clustering against lapha_tpu.search (CPU).

Both agents get the same scripted engine (the JAX package's ``FakeEngine``,
plain Python), the same hash-based value function and a ``random.Random(0)``;
the port's tree differs only in its pruning geometry, the port's float32
``poincare_dist_matrix``. The pruned trees get a fresh text for every
sample, hence distinct ball points: coincident points (a node expanded
twice by a fixed script) would leave the merge order to rounding ties.
Tolerance: the chains are equal — the same texts,
token ids, flags, cluster ids and visit counts — with floats (Q, P, values,
ball points) within 1e-6.

Both agents break ties of the frontier score by ``id(node)``, a memory
address, so the allocations of earlier tests in the same process could
order tied nodes differently on the two sides. The tests replace ``id`` in
both search modules by the order in which each module first sees a node:
deterministic, and the same rule on both sides.
"""

import builtins
import itertools
import random

import numpy as np
import pytest

import lapha_tpu.search.mcts as jmcts_module
import lapha_tpu_torch.search.mcts as tmcts_module
from lapha_tpu.engine import FakeEngine, SamplingParams
from lapha_tpu.search import LatentBank as JBank
from lapha_tpu.search import MCTSAgent as JMCTS
from lapha_tpu.search import cluster_and_select_disabled as j_cluster
from lapha_tpu.search import make_fake_value_fn
from lapha_tpu_torch.search import LatentBank as TBank
from lapha_tpu_torch.search import MCTSAgent as TMCTS
from lapha_tpu_torch.search import cluster_and_select_disabled as t_cluster

from test_search import ChatTok, _tool


@pytest.fixture(autouse=True)
def _first_seen_order(monkeypatch):
    for module in (jmcts_module, tmcts_module):
        order = {}
        monkeypatch.setattr(module, "id", lambda o, order=order: order.setdefault(
            builtins.id(o), len(order)), raising=False)


def _agent_classes(base):
    class Poor(base):
        TOOLS = {}
        TOOLS_DESCRIPTION = ""
        SYSTEM_TEMPLATE = "Solve step by step. Limit {step_limit} steps."
        USER_TEMPLATE = "{support_material_str}\nQ: {question}"

    class Tool(base):
        TOOLS = {"execute_python_code": _tool}
        TOOLS_DESCRIPTION = [{"type": "function", "function": {"name": "execute_python_code"}}]
        SYSTEM_TEMPLATE = "Use tools. Limit {step_limit}."
        USER_TEMPLATE = "{support_material_str}\nQ: {question}"

    return {"poor": Poor, "tool": Tool}


CLASSES = {"jax": (_agent_classes(JMCTS), JBank), "torch": (_agent_classes(TMCTS), TBank)}

SCRIPTS = {
    "basic": (dict(depth=3, num_sim=4), [
        (r"STEP-2", ["deep think </think> <answer>4</answer>", "other deep </think> <answer>5</answer>"]),
        (r".", ["step one thought </think> continue", "alt step one </think> hmm"]),
    ]),
    "prune": (dict(depth=4, num_sim=6, prune_per=2), "unique"),
    "prune_wide": (dict(depth=5, num_sim=8, prune_per=3, breadth=3), [
        (r"STEP-3", ["x </think> <answer>4</answer>", "y </think> more", "z </think> <answer>9</answer>"]),
        (r".", ["alpha </think> go", "beta gamma </think> go", "delta </think> on"]),
    ]),
    "tools": (dict(depth=3, num_sim=2, agent="tool"), [
        (r".", ["compute </think>\n```python\nx=1\n```",
                'use </think> <tool_call>{"name": "nope", "arguments": {}}</tool_call>']),
    ]),
}


def _search(side, name):
    kw, script = SCRIPTS[name]
    kw = dict(kw)
    classes, bank_cls = CLASSES[side]
    cls = classes[kw.pop("agent", "poor")]
    tok = ChatTok()
    if script == "unique":
        count = itertools.count()
        eng = FakeEngine(tok, default=lambda prompt, n: [
            f"w{next(count)} </think> go" for _ in range(n)])
    else:
        eng = FakeEngine(tok, script=script)
    agent = cls(tokenizer=tok, depth=kw["depth"], breadth=kw.get("breadth", 2),
                output_dir="/tmp/mcts-torch-test", llm=eng,
                max_model_len=512, sampling_params=SamplingParams(max_tokens=64),
                value_fn=make_fake_value_fn(hidden_size=8),
                reward_fns=[lambda c, gt: 1.0 if f"<answer>{gt}</answer>" in c else 0.0],
                c_puct=1.0, v_prior=0.0, value_trust=0.5, num_sim=kw["num_sim"],
                prune_per=kw.get("prune_per", 100), num_pos_sim=99,
                hid_bank=bank_cls(), rng=random.Random(0))
    return agent.search("what is 2+2?", ground_truth="4"), agent


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_search_chains_match_jax(name):
    jc, ja = _search("jax", name)
    tc, ta = _search("torch", name)
    assert len(tc) == len(jc) and len(jc) > 1
    for jchain, tchain in zip(jc, tc):
        assert len(tchain) == len(jchain)
        for js, ts in zip(jchain, tchain):
            assert ts.keys() == js.keys()
            for key, jv in js.items():
                tv = ts[key]
                if key == "hid":
                    np.testing.assert_allclose(tv, jv, atol=1e-3)  # float16 lists
                elif isinstance(jv, float):
                    assert tv == pytest.approx(jv, abs=1e-6), key
                elif key != "_pooled_hidden":
                    assert tv == jv, key
    if "prune" in name:
        assert any(n.cluster_id is not None for n in ta._all_nodes)
    assert len(ta.hid_bank) == len(ja.hid_bank)


def _blob(rng, center, n, spread=0.01):
    return np.clip(center + rng.normal(scale=spread, size=(n, len(center))), -0.95, 0.95)


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_and_select_disabled_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([_blob(rng, [0.5, 0.0, 0.1], 6), _blob(rng, [-0.5, 0.0, 0.0], 5),
                          rng.uniform(-0.4, 0.4, size=(7, 3))]).astype(np.float32)
    jl, jcen, jdis = j_cluster(pts, random.Random(seed))
    tl, tcen, tdis = t_cluster(pts, random.Random(seed))
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tdis, jdis)
    assert tcen.keys() == jcen.keys()
    for key in jcen:
        np.testing.assert_allclose(tcen[key], jcen[key], atol=1e-6)
