"""Speculative decoding in lapha_tpu_torch against lapha_tpu (CPU, f32): the
entries. The rollout CLI with ``--spec-decode pld --spec-k 2`` writes JAX's
rows byte for byte (both CLIs in process on one tiny checkpoint, greedy,
f32 loaders, as ``tests/test_torch_rollout_cli.py`` compares them); the
server CLI with ``--spec-decode pld`` (the sync path) answers one greedy
request with JAX's server's ids, finish reasons and texts, logprobs within
1e-4 (as ``tests/test_torch_engine_server.py`` compares them).
"""

import json
import os

os.environ.setdefault("USE_TF", "0")  # transformers' TensorFlow import costs ~10 s

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lapha_tpu.engine import Engine as JEngine  # noqa: E402
from lapha_tpu.engine import EngineClient as JClient  # noqa: E402
from lapha_tpu.engine import server as jserver  # noqa: E402
from lapha_tpu_torch.engine import EngineClient  # noqa: E402
from lapha_tpu_torch.engine import server as engine_server  # noqa: E402
from lapha_tpu_torch.models import loader  # noqa: E402

from test_torch_engine_server import ByteTok, _url, _write_checkpoint  # noqa: E402
from test_torch_rollout_cli import SIDES, f32_loaders, tiny_model_dir  # noqa: E402,F401
from test_torch_spec import _qwen_pair  # noqa: E402


def test_rollout_cli_spec_rows_match_jax(tiny_model_dir, f32_loaders, tmp_path):
    data = tmp_path / "data.jsonl"
    with open(data, "w") as f:
        for q, a in [("What is 2+2?", "4"), ("What is 1+1?", "2")]:
            f.write(json.dumps({"question": q, "answer": a}) + "\n")
    rows = {}
    for side, (ro, _, _, _, extra) in SIDES.items():
        out = tmp_path / f"{side}.jsonl"
        n = ro.main(["--data", str(data), "--out", str(out), "--dataset-name", "math",
                     "--tokenizer-path", tiny_model_dir, "--engine", "tpu", "--mode", "single",
                     "--max-new-tokens", "12", "--temperature", "0", "--max-model-len", "512",
                     "--max-batch", "4", "--spec-decode", "pld", "--spec-k", "2", *extra])
        assert n == 2
        rows[side] = out.read_bytes()
    assert rows["torch"] == rows["jax"]
    assert any(json.loads(r)["completion"] for r in rows["torch"].decode().splitlines())


def test_server_spec_matches_jax(tmp_path, monkeypatch):
    """The port's server CLI with --spec-decode pld (the sync path) and
    JAX's server over a spec engine on the same weights: one greedy request
    gets the same ids, finish reasons and texts, logprobs within 1e-4."""
    jcfg, jp, tcfg, tp = _qwen_pair(8)
    d = str(tmp_path / "ckpt")
    _write_checkpoint(tcfg, tp, d)
    load = loader.load_params
    monkeypatch.setattr(loader, "load_params",
                        lambda *a, **k: load(*a, **{**k, "dtype": torch.float32}))
    thttpd = engine_server.main(["--model", d, "--port", "0", "--host", "127.0.0.1",
                                 "--device", "cpu", "--max-model-len", "128", "--max-batch", "8",
                                 "--spec-decode", "pld"],
                                tokenizer_override=ByteTok(), background=True)
    jeng = JEngine(jp, jcfg, ByteTok(), approx_top_k=False, max_model_len=128, max_batch=8,
                   spec_decode="pld")
    jhttpd = jserver.serve(jeng, port=0, background=True)
    try:
        assert thttpd.engine_server.scheduler is None
        payload = dict(n=2, temperature=0.0, max_tokens=10)
        prompts = ["spec wire check, spec wire check", "second prompt"]
        got = EngineClient(_url(thttpd)).generate(prompts, **payload)
        want = JClient(_url(jhttpd)).generate(prompts, **payload)
        assert got["completion_ids"] == want["completion_ids"]
        assert got["finish_reasons"] == want["finish_reasons"]
        assert got["texts"] == want["texts"]
        for x, y in zip(got["logprobs"], want["logprobs"]):
            np.testing.assert_allclose(x, y, atol=1e-4, rtol=0)
        assert thttpd.engine_server.engine.last_spec_stats == jeng.last_spec_stats
    finally:
        thttpd.shutdown()
        jhttpd.shutdown()
