"""The port's graders, best-leaf selection and Python tool against
lapha_tpu's, on the same inputs (CPU).

Host code on both sides, so outputs must be equal: grader scores and
extracted strings, the picked leaves (compared by their place in the input),
and the tool's printed output, results, errors and returned context.
"""

import json
import os
import re

import numpy as np
import pytest

from lapha_tpu.evalsuite import rewards as jrw
from lapha_tpu.search import pick_best_leaf as j_best
from lapha_tpu.search import pick_top_leaves as j_top
from lapha_tpu import tools as jtools
from lapha_tpu_torch.evalsuite import rewards as trw
from lapha_tpu_torch.search import pick_best_leaf as t_best
from lapha_tpu_torch.search import pick_top_leaves as t_top
from lapha_tpu_torch import tools as ttools

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

# ---------------------------------------------------------------- graders

EXTRACTORS = ("normalize_final_answer", "strip_string", "last_boxed_only_string",
              "remove_boxed", "extract_from_completion", "extract_aime_int", "_aime_gt_int",
              "_gt_raw", "_extract_choice_letter", "_extract_final_answer",
              "_normalize_basic", "_parse_binary_score")


def _completions(answer: str, other: str) -> list[str]:
    """Completions built from one gold answer (and a wrong one): each
    extraction path, right and wrong, with and without dollars."""
    bare = answer.strip().strip("$")
    return [f"<answer>{answer}</answer>", f"<think>work</think> <answer>{bare}</answer>",
            f"so the result is \\boxed{{{bare}}}.", f"Final Answer: {answer}\nmore text",
            f"Answer: ${bare}$", f"the answer is {bare}", f"<answer>{other}</answer>",
            f"I pick: {bare[:1]}", f"<answer> {bare} </answer> <answer>{other}</answer>",
            "no answer at all", "", f"<answer>1</answer> verdict {bare}"]


def _call(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # the same inputs must fail the same way
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name", sorted(os.listdir(DATA)))
def test_graders_match_jax(name):
    with open(os.path.join(DATA, name), encoding="utf-8") as f:
        gold = [str(json.loads(l)["answer"]) for l in f if l.strip()]
    assert gold
    n = 0
    for i, answer in enumerate(gold):
        other = gold[(i + 1) % len(gold)]
        for comp in _completions(answer, other):
            for ds, fns in jrw.RULE_REWARD_FUNCS.items():
                tfns = trw.RULE_REWARD_FUNCS[ds]
                assert [f.__name__ for f in tfns] == [f.__name__ for f in fns]
                for jf, tf in zip(fns, tfns):
                    assert _call(tf, comp, answer) == _call(jf, comp, answer), (jf.__name__, comp)
                    n += 1
                assert _call(trw.REWARD_FUNCS[ds], comp, answer) == \
                    _call(jrw.REWARD_FUNCS[ds], comp, answer), (ds, comp)
            for ex in EXTRACTORS:
                for arg in (comp, answer):
                    assert _call(getattr(trw, ex), arg) == _call(getattr(jrw, ex), arg), (ex, arg)
    assert sorted(trw.REWARD_FUNCS) == sorted(jrw.REWARD_FUNCS)
    assert n > 0


# ---------------------------------------------------------------- best leaf

def _chains(seed: int):
    """Seeded synthetic MCTS chains: answers drawn from a few values (so
    groups form), v_pred on some steps, ball points (``hid``) on most
    leaves, cum_logprob or p_prior on the steps, and disabled leaves."""
    rng = np.random.default_rng(seed)
    chains = []
    for c in range(int(rng.integers(6, 14))):
        steps = []
        for d in range(int(rng.integers(1, 4))):
            st = {"completion": f"step {d} of chain {c}"}
            if rng.random() < 0.8:
                st["v_pred"] = float(rng.random())
            if rng.random() < 0.6:
                st["cum_logprob"] = float(-rng.random() * 20)
            elif rng.random() < 0.5:
                st["p_prior"] = float(rng.random())
            steps.append(st)
        leaf = steps[-1]
        kind = rng.random()
        if kind < 0.6:
            leaf["completion"] += f" <answer>{int(rng.integers(0, 3))}</answer>"
        elif kind < 0.7:
            leaf["completion"] += " <answer></answer>"
        leaf["completion_ids"] = list(range(int(rng.integers(3, 60))))
        leaf["_Q"] = float(rng.normal())
        leaf["_N"] = int(rng.integers(0, 9))
        if rng.random() < 0.8:
            v = rng.normal(size=6)
            leaf["hid"] = (v / np.linalg.norm(v) * rng.random() * 0.9).tolist()
        if rng.random() < 0.15:
            leaf["disabled" if rng.random() < 0.5 else "_disabled"] = True
        chains.append(steps)
    return chains


def _index(chains, leaf):
    return next(i for i, ch in enumerate(chains) if ch[-1] is leaf)


@pytest.mark.parametrize("seed", range(6))
def test_best_leaf_matches_jax(seed):
    chains = _chains(seed)
    for prefer in (True, False):
        for kw in ({}, {"tau_group": 0.3, "k_nn": 2},
                   {"weights": dict(zQ=0.5, zlogN=0.1, zlogp=1.0, zv=0.7, zmono=0.0,
                                    zdens=0.9, zlen=0.4)}):
            jb = j_best(chains, prefer_answer=prefer, **kw)
            tb = t_best(chains, prefer_answer=prefer, **kw)
            assert (tb is None) == (jb is None)
            if jb is not None:
                assert _index(chains, tb) == _index(chains, jb)
            for k in (1, 3, 20):
                jt = j_top(chains, k, prefer_answer=prefer, **kw)
                tt = t_top(chains, k, prefer_answer=prefer, **kw)
                assert [_index(chains, x) for x in tt] == [_index(chains, x) for x in jt]
                if jb is not None:
                    assert tt[0] is tb
    assert t_best([]) is None and t_top([[]], 3) == []


# ---------------------------------------------------------------- tools

# the snippets of tests/test_tools.py, plus its failing cases
SNIPPETS = {
    "arithmetic": "x = 2 + 3\nx * 4",
    "print": "print('hello', 42)\nprint('bye')",
    "control_flow": "total = 0\nfor i in range(10):\n    if i % 2 == 0:\n        total += i\n"
                    "    else:\n        continue\ntotal",
    "while_break": "i = 0\nwhile True:\n    i += 1\n    if i >= 5:\n        break\ni",
    "recursion": "def fib(n):\n    if n < 2:\n        return n\n    return fib(n-1) + fib(n-2)\n"
                 "fib(10)",
    "comprehensions": "sorted([x*x for x in range(5) if x != 2], key=lambda v: -v)",
    "dict_comp": "{k: v for k, v in [('a', 1), ('b', 2)]}",
    "classes": "class Point:\n    def __init__(self, x, y):\n        self.x = x\n        self.y = y\n"
               "    def norm2(self):\n        return self.x**2 + self.y**2\nPoint(3, 4).norm2()",
    "fstrings": "a, b, *rest = [1, 2, 3, 4]\nf'{a}-{b}-{rest!r}'",
    "try_except": "try:\n    x = 1 / 0\nexcept ZeroDivisionError as e:\n    x = 'caught'\nx",
    "import_math": "import math\nmath.sqrt(16)",
    "import_os": "import os",
    "from_subprocess": "from subprocess import run",
    "dunder": "(1).__class__",
    "dunder_chain": "x = []\nx.__class__.__bases__",
    "eval": "eval('1+1')",
    "open": "open('/etc/passwd')",
    "power": "10 ** 100000",
    "numpy": "import numpy as np\nfloat(np.mean([1, 2, 3]))",
    "zero_div": "1/0",
    "undefined": "nope_undefined",
    "long_print": "print('z' * 10000)",
    "context": "y = x * 2\nprint(y)",
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_tool_snippets_match_jax(name):
    code = SNIPPETS[name]
    assert _call(ttools.evaluate_python_code, code) == _call(jtools.evaluate_python_code, code)
    budget = _call(lambda m: m.Interpreter(max_operations=1000).run(code), ttools)
    assert budget == _call(lambda m: m.Interpreter(max_operations=1000).run(code), jtools)
    ctx = {"x": 21}
    t_out, t_ctx = ttools.execute_python_code(code, context=dict(ctx))
    j_out, j_ctx = jtools.execute_python_code(code, context=dict(ctx))
    assert t_out == j_out
    assert {k: _canon(v) for k, v in t_ctx.items()} == {k: _canon(v) for k, v in j_ctx.items()}


def _canon(v) -> str:
    """repr without the object's address and its package's name (functions
    defined by a snippet are sandbox objects of each package)."""
    return re.sub(r"lapha_tpu(_torch)?\.|(?<= object) at 0x[0-9a-f]+", "", repr(v))


def test_tool_session_and_final_answer_match_jax():
    outs = []
    for mod in (jtools, ttools):
        tool = mod.IPythonInterpreter()
        first = tool.execute(code="a = 6 * 7\nprint(a)")
        second = tool.execute(code="a + 1")
        final = mod.LocalPythonExecutor()("final_answer(42)")
        outs.append((first[0], first[1]["a"], second[0], final))
    assert outs[1] == outs[0]
    assert "43" in outs[1][2] and outs[1][3] == (42, "", True)
    assert ttools.description == jtools.description


@pytest.fixture(scope="module")
def port_tool_server():
    from lapha_tpu_torch.tools import server as srv

    httpd = srv.serve(port=0, background=True)
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()


def test_port_tool_server_execute_and_health(port_tool_server):
    import requests

    base = port_tool_server
    assert requests.get(base + "/health", timeout=10).json()["status"] == "ok"
    r1 = requests.post(base + "/execute", json={"code": "q = 10\nprint(q)"}, timeout=10).json()
    assert r1["status"] == "success" and "10" in r1["output"]
    r2 = requests.post(base + "/execute", json={"code": "print(q * 2)",
                                                "session_id": r1["session_id"]},
                       timeout=10).json()
    assert "20" in r2["output"] and r2["session_id"] == r1["session_id"]
    bad = requests.post(base + "/execute", json={"code": "nope_undefined"}, timeout=10).json()
    assert bad["status"] == "error" and "Error" in bad["output"]
    # the port's client through the port's server
    out, ctx = ttools.execute_python_code("w = 5\nprint(w + 1)", server_url=base)
    assert "6" in out and ctx.get("w") == 5
