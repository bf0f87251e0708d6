"""The port's rollout CLI and scorer against lapha_tpu's, in process (CPU).

- With fakes: ``rollout_jsonl.main`` in single, react (a scripted tool call
  through the sandbox) and value modes, each side with its own package's
  ``FakeEngine`` and ``make_fake_value_fn`` on the same script, writes
  byte-equal JSONL; ``eval_math.main`` on it writes equal summaries but for
  ``timestamp``.
- With a real model: on ``model_fixtures.build_tiny_model_dir`` both CLIs
  load the checkpoint themselves (the port with ``--device cpu``) and decode
  greedily (``--temperature 0``); the rows are byte-equal in single, react
  and value modes (value mode with the same value-head ``.npz``). Both
  loaders are held to float32 here: the CLI loads bf16, where XLA's and
  torch's roundings differ and a greedy argmax between near-equal logits of
  a random model may flip.
- ``--engine jet --device cpu`` builds the block-diffusion engine and runs
  single mode on the tiny checkpoint; in value mode it raises JAX's
  refusal (the diffusion engine collects no h0). The refusals:
  ``--tensor-parallel-size 2`` (A11), a value device other than the
  engine's, and the default ``--device`` without a card.
  (``--spec-decode pld`` runs: its rows are held to JAX's in
  ``tests/test_torch_spec.py``.)

The search breaks score ties by ``id(node)`` on both sides; as in
``tests/test_torch_search.py`` the tests replace it by first-seen order.
"""

import builtins
import functools
import json
import os
import re

os.environ.setdefault("USE_TF", "0")  # transformers' TensorFlow import costs ~10 s

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lapha_tpu.models.loader as jloader  # noqa: E402
import lapha_tpu.search.mcts as jmcts_module  # noqa: E402
import lapha_tpu_torch.models.loader as tloader  # noqa: E402
import lapha_tpu_torch.search.mcts as tmcts_module  # noqa: E402
from lapha_tpu.engine import FakeEngine as JFake  # noqa: E402
from lapha_tpu.evalsuite import eval_math as jem  # noqa: E402
from lapha_tpu.evalsuite import rollout_jsonl as jro  # noqa: E402
from lapha_tpu.search import make_fake_value_fn as j_fake_value_fn  # noqa: E402
from lapha_tpu_torch.engine import FakeEngine as TFake  # noqa: E402
from lapha_tpu_torch.evalsuite import eval_math as tem  # noqa: E402
from lapha_tpu_torch.evalsuite import rollout_jsonl as tro  # noqa: E402
from lapha_tpu_torch.search import make_fake_value_fn as t_fake_value_fn  # noqa: E402

from model_fixtures import build_tiny_model_dir  # noqa: E402
from test_search import ChatTok  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
SIDES = {"jax": (jro, jem, JFake, j_fake_value_fn, []),
         "torch": (tro, tem, TFake, t_fake_value_fn, ["--device", "cpu", "--value-device", "cpu"])}


@pytest.fixture(autouse=True)
def _first_seen_order(monkeypatch):
    for module in (jmcts_module, tmcts_module):
        order = {}
        monkeypatch.setattr(module, "id", lambda o, order=order: order.setdefault(
            builtins.id(o), len(order)), raising=False)


@pytest.fixture()
def gold_file(tmp_path):
    """The first three MATH-500 rows."""
    with open(os.path.join(DATA, "math-500.jsonl"), encoding="utf-8") as f:
        rows = [json.loads(next(f)) for _ in range(3)]
    p = tmp_path / "math-500.jsonl"
    with open(p, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return p


# ---------------------------------------------------------------- with fakes

FAKE_MODES = {
    "single": (["--mode", "single"], [
        (r"intersect", ["<think>solve</think> <answer>\\frac{1}{2}</answer>"]),
        (r".", ["<think>hmm</think> <answer>(3, \\frac{\\pi}{2})</answer>"])]),
    # one question: each ReAct level runs gc.collect(), ~0.1-0.2 s with jax and torch loaded
    "react": (["--mode", "react", "--depth", "3", "--k", "2", "--limit", "1"], [
        # after the sandboxed tool ran, a tool message is in the chat
        (r"<\|tool\|>.*<\|tool\|>", ["<think>done</think> <answer>4</answer>"]),
        (r"<\|tool\|>", ['<think>json call</think> <tool_call>{"name": "execute_python_code", '
                         '"arguments": {"code": "print(x * 7)"}}</tool_call>']),
        (r".", ["<think>calc</think>\n```python\nx = 2 + 4\nprint(x)\n```"])]),
    "value": (["--mode", "value", "--depth", "3", "--breadth", "2", "--mcts-num-sim", "4",
               "--mcts-num-pos-sim", "1", "--k", "3", "--max-model-len", "2048"], [
        (r"STEP-2", ["deep </think> <answer>4</answer>", "deep2 </think> <answer>5</answer>"]),
        (r".", ["start </think> go", "start2 </think> go"])]),
}


def _fake_rollout(side, mode, gold, tmp_path):
    ro, em, fake, fake_value_fn, extra = SIDES[side]
    argv, script = FAKE_MODES[mode]
    tok = ChatTok()
    eng = fake(tok, script=script)
    out = tmp_path / side / "eval" / "rollouts" / "math.pred.jsonl"
    n = ro.main(["--data", str(gold), "--out", str(out), "--dataset-name", "math",
                 "--tokenizer-path", "unused", "--engine", "fake", "--max-new-tokens", "64",
                 *argv, *extra],
                engine_override=eng, tokenizer_override=tok,
                value_fn_override=fake_value_fn(hidden_size=8))
    return out, n, eng


@pytest.mark.parametrize("mode", sorted(FAKE_MODES))
def test_fake_cli_rows_and_scores_match_jax(mode, gold_file, tmp_path, monkeypatch):
    (jout, jn, jeng), (tout, tn, teng) = (_fake_rollout(s, mode, gold_file, tmp_path)
                                          for s in ("jax", "torch"))
    assert tn == jn == (1 if mode == "react" else 3)
    assert tout.read_bytes() == jout.read_bytes()
    assert [c["prompts"] for c in teng.calls] == [c["prompts"] for c in jeng.calls]
    if mode == "react":  # both tool calls ran: the second saw the first's x
        assert "42" in "".join(p for c in teng.calls for p in c["prompts"])
    monkeypatch.setenv("DATA_DIR_MATH", str(gold_file))
    summaries = {}
    for side, out in (("jax", jout), ("torch", tout)):
        em = SIDES[side][1]
        monkeypatch.setattr(em, "EVAL_DIR", out.parent.parent)
        em.main(["--dataset", "math", "--k", "3"])
        results = out.parent.parent / "results"
        summary = json.loads((results / "math.summary.json").read_text())
        assert summary.pop("timestamp")
        with open(results / "summary.csv") as f:
            rows = [r.split(",")[1:] for r in f.read().splitlines()]  # time column dropped
        summaries[side] = (summary, rows)
    assert summaries["torch"] == summaries["jax"]
    assert summaries["torch"][0]["num"] == 3


# ---------------------------------------------------------------- a real model

@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    return build_tiny_model_dir(str(tmp_path_factory.mktemp("tinymodel")))


@pytest.fixture()
def f32_loaders(monkeypatch):
    import jax.numpy as jnp

    monkeypatch.setattr(jloader, "load_params",
                        functools.partial(jloader.load_params, dtype=jnp.float32))
    monkeypatch.setattr(tloader, "load_params",
                        functools.partial(tloader.load_params, dtype=torch.float32))


REAL_MODES = {
    "single": ["--mode", "single"],
    "react": ["--mode", "react", "--depth", "2"],
    "value": ["--mode", "value", "--depth", "2", "--breadth", "2", "--mcts-num-sim", "2",
              "--mcts-num-pos-sim", "99", "--k", "4"],
}


@pytest.mark.parametrize("mode", sorted(REAL_MODES))
def test_tiny_model_cli_rows_match_jax(mode, tiny_model_dir, f32_loaders, tmp_path):
    data = tmp_path / "data.jsonl"
    with open(data, "w") as f:
        for q, a in [("What is 2+2?", "4"), ("What is 1+1?", "2")]:
            f.write(json.dumps({"question": q, "answer": a}) + "\n")
    head = tmp_path / "value_head.npz"
    np.savez(head, weight=np.random.default_rng(0).normal(size=(1, 64)).astype(np.float32),
             bias=np.zeros(1, np.float32))
    rows = {}
    for side, (ro, _, _, _, extra) in SIDES.items():
        out = tmp_path / f"{side}.jsonl"
        n = ro.main(["--data", str(data), "--out", str(out), "--dataset-name", "math",
                     "--tokenizer-path", tiny_model_dir, "--engine", "tpu",
                     "--max-new-tokens", "12", "--temperature", "0", "--max-model-len", "512",
                     "--max-batch", "4", "--value-base", tiny_model_dir, "--value-head",
                     str(head), *REAL_MODES[mode], *extra])
        assert n == 2
        rows[side] = out.read_bytes()
    assert rows["torch"] == rows["jax"]
    got = [json.loads(l) for l in rows["torch"].decode().splitlines()]
    # the prompts reached the engine (no context-length stub) and it generated
    assert all("Context length exceeded" not in r["completion"] for r in got)
    assert any(r["completion"] for r in got)
    if mode == "value":
        assert all(1 <= r["k"] <= 4 and r["completions"][0] == r["completion"] for r in got)


# ---------------------------------------------------------------- refusals

def _argv(tmp_path, *extra):
    data = tmp_path / "data.jsonl"
    data.write_text(json.dumps({"question": "What is 2+2?", "answer": "4"}) + "\n")
    return ["--data", str(data), "--out", str(tmp_path / "out.jsonl"), "--dataset-name", "math",
            "--tokenizer-path", "unused", *extra]


def test_refusals_name_their_cause(tmp_path, monkeypatch, tiny_model_dir):
    from lapha_tpu_torch.engine import DiffusionEngine
    from lapha_tpu_torch.evalsuite.adapters import build_engine_adapter

    tok = ChatTok()
    built = []
    monkeypatch.setattr(tro, "build_engine_adapter",
                        lambda *a, **kw: built.append(build_engine_adapter(*a, **kw)) or built[-1])
    monkeypatch.setenv("SDAR_MASK_TOKEN_ID", "7")
    jet = ["--engine", "jet", "--device", "cpu", "--tokenizer-path", tiny_model_dir,
           "--max-new-tokens", "8", "--max-model-len", "512"]
    assert tro.main(_argv(tmp_path, "--mode", "single", *jet)) == 1
    assert isinstance(built[-1], DiffusionEngine) and built[-1].device.type == "cpu"
    assert built[-1].last_diffusion_stats["forwards"] >= 2
    with pytest.raises(ValueError, match="does not collect h0"):
        tro.main(_argv(tmp_path, "--mode", "value", "--value-device", "cpu", *jet))
    (tmp_path / "out.jsonl").unlink()
    with pytest.raises(ValueError, match="A11"):
        tro.main(_argv(tmp_path, "--device", "cpu", "--tensor-parallel-size", "2"),
                 tokenizer_override=tok, engine_override=TFake(tok))
    with pytest.raises(ValueError, match="--value-device tpu is not the engine's device cpu"):
        tro.main(_argv(tmp_path, "--device", "cpu", "--mode", "value"), tokenizer_override=tok,
                 engine_override=TFake(tok), value_fn_override=t_fake_value_fn())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=re.escape("no CUDA device; pass device='cpu'")):
        tro.main(_argv(tmp_path, "--engine", "fake"), tokenizer_override=tok,
                 engine_override=TFake(tok))
    assert not (tmp_path / "out.jsonl").exists()


def test_build_value_fn_default_head(tiny_model_dir):
    """Without a head file the head comes from torch.Generator(device)
    seeded 0 (a stream other than JAX's jax.random.key(0), ROADMAP's
    deliberate deviations), on the requested device."""
    from lapha_tpu_torch.models import value_model

    vf, params, cfg = tro.build_value_fn(tiny_model_dir, None, max_model_len=256, device="cpu")
    ref = value_model.init_value_head(cfg.hidden_size, torch.Generator("cpu").manual_seed(0))
    assert vf.device.type == "cpu" and vf.params is params and vf.max_model_len == 256
    torch.testing.assert_close(vf.head["w"], ref["w"], rtol=0, atol=0)
    torch.testing.assert_close(vf.head["b"], ref["b"], rtol=0, atol=0)
