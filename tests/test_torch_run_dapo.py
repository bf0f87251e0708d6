"""The port's training entry (``lapha_tpu_torch.run_dapo``) against the repo's
JAX entry (``run_dapo.py``, imported by path), in process on the CPU.

- Entry parity: both ``main``s on ``model_fixtures.build_tiny_model_dir``,
  a DAPO parquet written here and a yaml of tiny search knobs (f32,
  ``--max-steps 1``; the JAX entry takes no typed override, ROADMAP C2 f).
  Each trainer's ``Engine`` is its package's ``FakeEngine`` on one script
  and the port's value head starts as JAX's. Tolerance 1e-4: the
  ``metrics.jsonl`` names, steps and values, the exported arrays and both
  value-head files. The output directories hold the same files, but inside
  ``checkpoints/step_1`` (orbax there, ``torch.save`` here); tree PNGs are
  written on both sides.
- Typed overrides: int, float, bool and ``None`` values; an unknown flag or
  a value that does not parse raises naming it; the JAX entry given
  ``--breadth 4`` raises TypeError (C2 f, pinned).
- Resume: a second ``main`` with ``--max-steps 2`` on the same output
  directory resumes from step 1 (``get_checkpoint``) and ends at step 2.
- The exported checkpoint feeds the evaluation entry: the port's
  ``rollout_jsonl.main`` on the port's export and JAX's CLI on JAX's, in
  single and value modes (``value_head.npz``), greedy with f32 loaders,
  write byte-equal rows. ``--device cuda`` without a card raises.
- viz: ``_to_disk_2d`` equals JAX's within 1e-5 where no t-SNE runs (a 2-D
  ball; too few points for t-SNE, the SVD projection; scikit-learn absent,
  PCA's slice then the SVD projection); on the t-SNE path (random) only
  tests/test_viz.py's invariants are held.

The search breaks score ties by ``id(node)``; as in
tests/test_torch_rollout_cli.py, both sides use first-seen order here.
"""

import builtins
import functools
import importlib.util
import json
import os
import shutil
import sys

os.environ.setdefault("USE_TF", "0")  # transformers' TensorFlow import costs ~10 s

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lapha_tpu.models.loader as jloader  # noqa: E402
import lapha_tpu.search.mcts as jmcts_module  # noqa: E402
import lapha_tpu.train.trainer as jtrainer_module  # noqa: E402
import lapha_tpu_torch.models.loader as tloader  # noqa: E402
import lapha_tpu_torch.search.mcts as tmcts_module  # noqa: E402
import lapha_tpu_torch.train.trainer as ttrainer_module  # noqa: E402
from lapha_tpu.engine import FakeEngine as JFake  # noqa: E402
from lapha_tpu_torch import run_dapo  # noqa: E402
from lapha_tpu_torch.engine import FakeEngine as TFake  # noqa: E402
from lapha_tpu_torch.models import value_model as tvalue_model  # noqa: E402
from lapha_tpu_torch.train import MTPOConfig  # noqa: E402

from model_fixtures import build_tiny_model_dir  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)
SCRIPT = [(r"STEP-2", ["done </think> <answer>4</answer>", "done2 </think> <answer>7</answer>"]),
          (r".", ["go </think> on", "go2 </think> on"])]
YAML = """\
seed: 42
bf16: false
gradient_checkpointing: false
attn_implementation: dense
learning_rate: 1.0e-3
warmup_ratio: 0.0
per_device_train_batch_size: 1
depth: 2
breadth: 2
num_sim: 4
leaves_per_sim: 1
num_pos_sim: 99
prune_per: 100
num_groups: 4
max_model_len: 512
max_prompt_length: 256
max_completion_length: 32
num_generations: 2
save_steps: 0
beta: 1.0e-8
debug_print: false
mesh_data: 1
"""


def _jax_entry():
    spec = importlib.util.spec_from_file_location("run_dapo_jax", os.path.join(ROOT, "run_dapo.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_fakes(mp):
    """JAX's trainer on the fake engine and one CPU device (the tests run on
    eight virtual ones; the yaml's mesh_data is 1)."""
    import jax

    from lapha_tpu.parallel import make_mesh

    mp.setattr(jtrainer_module, "Engine", lambda params, cfg, tok, **kw: JFake(
        tok, script=SCRIPT))
    mp.setattr(jtrainer_module, "make_mesh", functools.partial(make_mesh,
                                                               devices=jax.devices()[:1]))


def _first_seen_order(mp):
    for module in (jmcts_module, tmcts_module):
        order = {}
        mp.setattr(module, "id", lambda o, order=order: order.setdefault(
            builtins.id(o), len(order)), raising=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread_pools():
    """This module's OpenMP and BLAS pools run one thread each: both trainers
    plot their trees, and scikit-learn's t-SNE spinning on 8 threads against
    the other test workers' made the module ~10x slower in the full suite."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The tiny model, a DAPO parquet of four rows and the yaml."""
    root = tmp_path_factory.mktemp("dapo")
    model = build_tiny_model_dir(str(root / "model"))
    parquet = str(root / "dapo.parquet")
    rows = [("What is 2+2?", "4"), ("What is 1+3?", "4"), ("What is 3+4?", "7"),
            ("What is 5-1?", "4")]
    pd.DataFrame({
        "prompt": [[{"content": q + '\n\nRemember to put your answer on its own line after '
                     '"Answer:".', "role": "user"}] for q, _ in rows],
        "reward_model": [{"ground_truth": a, "style": "rule"} for _, a in rows],
    }).to_parquet(parquet)
    config = str(root / "tiny.yaml")
    with open(config, "w") as f:
        f.write(YAML)
    return dict(model=model, parquet=parquet, config=config, root=root)


def _argv(inputs, out: str, steps: int) -> list[str]:
    return ["--config", inputs["config"], "--dataset", inputs["parquet"], "--max-steps",
            str(steps), "--model-name-or-path", inputs["model"], "--output-dir", out]


def _run_port(inputs, out: str, steps: int, head=None):
    """The port's main on the CPU with the fake engine (and the value head
    ``head`` at the start, where given)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # pulls TensorFlow
        _first_seen_order(mp)
        mp.setattr(ttrainer_module, "Engine", lambda params, cfg, tok, **kw: TFake(
            tok, script=SCRIPT))
        if head is not None:
            mp.setattr(tvalue_model, "make_value_head", lambda *a, **kw: {
                k: torch.from_numpy(np.array(v)) for k, v in head.items()})
        return run_dapo.main(_argv(inputs, out, steps) + ["--device", "cpu"])


@pytest.fixture(scope="module")
def runs(inputs):
    """JAX's entry, then the port's, one step each (module docstring)."""
    import jax

    from lapha_tpu.models import value_model as jvm

    jentry = _jax_entry()
    jout, tout = str(inputs["root"] / "out_jax"), str(inputs["root"] / "out_port")
    captured = {}
    inner = jtrainer_module.MTPOTrainer.train

    def train(self, *a, **kw):  # keep JAX's trainer: its main returns None
        captured["trainer"] = self
        return inner(self, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        _first_seen_order(mp)
        _jax_fakes(mp)
        mp.setattr(jtrainer_module.MTPOTrainer, "train", train)
        mp.setattr(sys, "argv", ["run_dapo.py", *_argv(inputs, jout, 1)])
        assert jentry.main() is None
    head0 = jvm.make_value_head("linear", 64, jax.random.key(42))
    trainer = _run_port(inputs, tout, 1, head=jax.tree.map(np.asarray, head0))
    return dict(jax=(captured["trainer"], jout), port=(trainer, tout))


def _tree_files(d: str) -> set:
    out = set()
    for base, dirs, files in os.walk(d):
        rel = os.path.relpath(base, d)
        if rel.startswith(os.path.join("checkpoints", "step_")):
            continue  # the checkpoint formats differ: orbax vs torch.save
        out.update(os.path.normpath(os.path.join(rel, f)) for f in files)
        out.update(os.path.normpath(os.path.join(rel, x)) + "/" for x in dirs)
    return out


def _metrics(d: str) -> list:
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_entry_matches_jax(runs):
    from safetensors.numpy import load_file

    (jt, jout), (tt, tout) = runs["jax"], runs["port"]
    assert isinstance(tt, ttrainer_module.MTPOTrainer)
    assert tt.global_step == jt.global_step == 1
    jm, tm = _metrics(jout), _metrics(tout)
    assert [(m["step"], m["name"]) for m in tm] == [(m["step"], m["name"]) for m in jm]
    assert {"avgAcc", "pass@1", "Loss/Loss", "Loss/PolicyLoss", "Loss/ValueLoss"} <= {
        m["name"] for m in tm}
    np.testing.assert_allclose([m["value"] for m in tm], [m["value"] for m in jm], **TOL)

    files = _tree_files(tout)
    assert files == _tree_files(jout)
    assert {"model.safetensors", "config.json", "tokenizer.json", "value_head.npz",
            "value_head.pt", "checkpoints/latest", "checkpoints/step_1/"} <= files
    pngs = sorted(f for f in files if f.endswith("_disk.png"))
    assert pngs and all(f.startswith("viz/step-0/tree") for f in pngs)
    assert any(f.startswith("train/step-0/group-") for f in files)  # a trainable group

    jsd = load_file(os.path.join(jout, "model.safetensors"))
    tsd = load_file(os.path.join(tout, "model.safetensors"))
    assert list(tsd) == list(jsd)
    for k in jsd:
        assert tsd[k].dtype == np.float32 and tsd[k].shape == jsd[k].shape
        np.testing.assert_allclose(tsd[k], jsd[k], err_msg=k, **TOL)
    jz, tz = np.load(os.path.join(jout, "value_head.npz")), np.load(
        os.path.join(tout, "value_head.npz"))
    jpt, tpt = (torch.load(os.path.join(d, "value_head.pt")) for d in (jout, tout))
    for k in ("weight", "bias"):
        assert tz[k].shape == jz[k].shape and tpt[k].shape == jpt[k].shape
        np.testing.assert_allclose(tz[k], jz[k], **TOL)
        np.testing.assert_allclose(tpt[k].numpy(), jpt[k].numpy(), **TOL)
    back = tloader.load_value_head(os.path.join(tout, "value_head.pt"), 64, device="cpu")
    assert torch.equal(back["w"], tt.head["w"].detach())


def test_typed_overrides():
    got = run_dapo.parse_overrides(
        ["--breadth", "4", "--learning-rate", "1e-6", "--debug-print", "false",
         "--bf16=1", "--epsilon-high", "none", "--generation-batch-size", "null",
         "--max-expands", "decay", "--save-steps", "0", "--output-dir", "x/y",
         "--scale-rewards", "false", "--warmup-ratio", "0"])
    assert got == dict(breadth=4, learning_rate=1e-6, debug_print=False, bf16=True,
                       epsilon_high=None, generation_batch_size=None, max_expands="decay",
                       save_steps=0, output_dir="x/y", scale_rewards=False, warmup_ratio=0.0)
    assert type(got["breadth"]) is int and type(got["warmup_ratio"]) is float
    assert run_dapo.parse_overrides(["--max-expands", "3", "--epsilon-high", "0.3"]) == dict(
        max_expands=3, epsilon_high=0.3)
    cfg = MTPOConfig(**got)
    assert cfg.breadth * max(1, cfg.leaves_per_sim) == 16
    for argv, match in ((["--no-such-knob", "1"], "--no-such-knob"),
                        (["--breadth", "four"], "--breadth"),
                        (["--bf16", "yes please"], "--bf16"),
                        (["--learning-rate", "fast"], "--learning-rate"),
                        (["--depth"], "--depth"),
                        (["stray"], "stray")):
        with pytest.raises(ValueError, match=match):
            run_dapo.parse_overrides(argv)


def test_jax_entry_breaks_on_a_typed_override(inputs, tmp_path, monkeypatch):
    """ROADMAP C2 f: the JAX entry passes --breadth on as the string '4'."""
    from lapha_tpu.train.config import MTPOConfig as JConfig

    assert JConfig.from_yaml(inputs["config"], breadth="4").breadth == "4"
    with pytest.raises(TypeError):
        JConfig.from_yaml(inputs["config"], num_generations="4")
    jentry = _jax_entry()
    monkeypatch.setattr(sys, "argv", ["run_dapo.py", *_argv(inputs, str(tmp_path), 1),
                                      "--breadth", "4"])
    _jax_fakes(monkeypatch)
    with pytest.raises(TypeError):
        jentry.main()


def test_resume_from_the_entrys_checkpoint(runs, inputs, tmp_path):
    out = str(tmp_path / "out")
    shutil.copytree(runs["port"][1], out)
    assert run_dapo.get_checkpoint(MTPOConfig(output_dir=out)) is True
    assert run_dapo.get_checkpoint(MTPOConfig(output_dir=str(tmp_path / "none"))) is None
    trainer = _run_port(inputs, out, 2)
    assert trainer.global_step == 2 and trainer.opt_state["count"] == 2
    assert [m["step"] for m in _metrics(out)] == sorted(m["step"] for m in _metrics(out))
    assert {m["step"] for m in _metrics(out)} == {0, 1}
    assert os.path.isdir(os.path.join(out, "checkpoints", "step_2"))
    with open(os.path.join(out, "checkpoints", "latest")) as f:
        assert f.read().strip() == "2"


def test_default_device_without_a_card_raises(inputs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_dapo.main(_argv(inputs, str(tmp_path), 1))


@pytest.mark.parametrize("mode", ["single", "value"])
def test_exported_checkpoint_feeds_the_eval_cli(runs, inputs, mode, tmp_path, monkeypatch):
    import jax.numpy as jnp

    from lapha_tpu.evalsuite import rollout_jsonl as jro
    from lapha_tpu_torch.evalsuite import rollout_jsonl as tro

    monkeypatch.setattr(jloader, "load_params",
                        functools.partial(jloader.load_params, dtype=jnp.float32))
    monkeypatch.setattr(tloader, "load_params",
                        functools.partial(tloader.load_params, dtype=torch.float32))
    _first_seen_order(monkeypatch)
    data = tmp_path / "data.jsonl"
    with open(data, "w") as f:
        for q, a in [("What is 2+2?", "4"), ("What is 1+1?", "2")]:
            f.write(json.dumps({"question": q, "answer": a}) + "\n")
    modes = {"single": ["--mode", "single"],
             "value": ["--mode", "value", "--depth", "2", "--breadth", "2", "--mcts-num-sim",
                       "2", "--mcts-num-pos-sim", "99", "--k", "4"]}
    rows = {}
    for side, ro, extra in (("jax", jro, []),
                            ("port", tro, ["--device", "cpu", "--value-device", "cpu"])):
        model = runs[side][1]
        # the engine loads the export; the chat template stays with the
        # source tokenizer (chat_template.jinja is not among the copied files)
        monkeypatch.setenv("JET_MODEL_PATH", model)
        out = tmp_path / f"{side}.jsonl"
        n = ro.main(["--data", str(data), "--out", str(out), "--dataset-name", "math",
                     "--tokenizer-path", inputs["model"], "--engine", "tpu",
                     "--max-new-tokens", "12",
                     "--temperature", "0", "--max-model-len", "512", "--max-batch", "4",
                     "--value-base", model, "--value-head",
                     os.path.join(model, "value_head.npz"), *modes[mode], *extra])
        assert n == 2
        rows[side] = out.read_bytes()
    assert rows["port"] == rows["jax"]
    assert any(json.loads(line)["completion"] for line in rows["port"].decode().splitlines())


def _ball_points(n, d, seed=0, radius=0.6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x = x / np.linalg.norm(x, axis=1, keepdims=True)
    return (x * rng.uniform(0.05, radius, size=(n, 1))).astype(np.float32)


@pytest.mark.parametrize("n,d,sklearn", [(10, 2, True), (4, 8, True), (30, 16, False)],
                         ids=["2d", "few_points_svd", "no_sklearn"])
def test_to_disk_2d_matches_jax(n, d, sklearn, monkeypatch):
    from lapha_tpu.train import viz as jviz
    from lapha_tpu_torch.train import viz as tviz

    if not sklearn:  # PCA falls back to a slice, t-SNE to the SVD projection
        for name in ("sklearn", "sklearn.decomposition", "sklearn.manifold"):
            monkeypatch.setitem(sys.modules, name, None)
    Y = _ball_points(n, d, seed=n + d)
    Y[1] = 0.0
    for root in (1, None):
        got, want = tviz._to_disk_2d(Y, root_idx=root), jviz._to_disk_2d(Y, root_idx=root)
        assert got.shape == want.shape == (n, 2) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    p, q = _to_disk_pair(tviz)
    np.testing.assert_allclose(tviz._geodesic_arc(p, q), jviz._geodesic_arc(p, q), atol=1e-6,
                               rtol=0)


def _to_disk_pair(viz):
    return np.asarray([0.3, -0.2], np.float32), np.asarray([-0.5, 0.4], np.float32)


def test_to_disk_2d_tsne_invariants_and_plot(tmp_path):
    from lapha_tpu_torch.train import viz as tviz

    Y = _ball_points(40, 16, seed=1)
    Y[3] = 0.0
    P2 = tviz._to_disk_2d(Y, root_idx=3)
    assert P2.shape == (40, 2)
    np.testing.assert_allclose(P2[3], 0.0, atol=1e-7)
    r = np.linalg.norm(P2, axis=1)
    assert 0.9 < r.max() < 1.0
    rng = np.random.default_rng(4)

    def step(v):
        return {"hid": (rng.normal(size=8) * 0.1).tolist(), "v_target": v, "v_pred": v * 0.9}

    out = tviz.plot_tree_disk([[step(0.3), step(0.6)], [step(0.2), step(0.9)]], step(0.0),
                              str(tmp_path / "tree0_disk.png"), title="tree0")
    assert out is not None and (tmp_path / "tree0_disk.png").stat().st_size > 1000
    assert tviz.plot_tree_disk([[step(0.3)]], None, str(tmp_path / "none.png")) is None
