"""lapha_tpu_torch.engine.server and .client: tests/test_engine_server.py on the
port (CPU, f32), the CLI's ``main`` with a weight reload, and the wire
between the port and JAX's server and client in both directions (the same
greedy payload gives the same token ids and finish reasons, logprobs within
1e-4). Every server binds port 0 and is shut down by its test or fixture.
"""

import glob
import http.client
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from lapha_tpu.engine import Engine as JEngine
from lapha_tpu.engine import EngineClient as JClient
from lapha_tpu.engine import server as jserver
from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import qwen2 as jq
from lapha_tpu_torch.engine import Engine, EngineClient, RemoteEngineAdapter, SamplingParams
from lapha_tpu_torch.engine import server as engine_server
from lapha_tpu_torch.engine.client import EngineHTTPError
from lapha_tpu_torch.models import loader, qwen2

V = 300
_jit_init = jax.jit(jq.init_params, static_argnums=0)


class ByteTok:
    eos_token_id = 0
    pad_token_id = 0

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [min(b, 255) + 1 for b in text.encode()]}

    def decode(self, ids, **kw):
        return bytes((i - 1) % 256 for i in ids if i > 0).decode(errors="replace")


SYNC = dict(max_model_len=128, max_batch=8, decode_chunk=8, pad_multiple=16, batch_bucket=1,
            eos_token_ids=[0])
CONT = dict(max_model_len=128, max_batch=8, decode_chunk=4, pad_multiple=16, batch_bucket=1,
            eos_token_ids=[], prefix_cache_bytes=0)


def _weights(seed: int):
    jcfg = JCfg.tiny(vocab_size=V)
    jp = _jit_init(jcfg, jax.random.key(seed))
    return (jcfg, jp, qwen2.Qwen2Config.tiny(vocab_size=V),
            loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))


def _url(httpd) -> str:
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _raw(url, method, path, body=None):
    """(status, parsed JSON) of one plain request."""
    host, port = url.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    out = r.status, json.loads(r.read())
    conn.close()
    return out


@pytest.fixture(scope="module")
def served_engine():
    _, _, tcfg, tp = _weights(3)
    eng = Engine(tp, tcfg, ByteTok(), **SYNC)
    httpd = engine_server.serve(eng, port=0, background=True)
    yield eng, _url(httpd)
    httpd.shutdown()


def _continuous(seed, **kw):
    _, _, tcfg, tp = _weights(seed)
    eng = Engine(tp, tcfg, ByteTok(), **{**CONT, **kw})
    httpd = engine_server.serve(eng, port=0, background=True, continuous=True, prompt_slab=64)
    client = EngineClient(_url(httpd))
    assert client.check_server(total_timeout=10)
    return eng, httpd, client


def test_health_and_world_size(served_engine):
    _, url = served_engine
    client = EngineClient(url)
    assert client.check_server(total_timeout=10)
    assert client.get_world_size() == 1


def test_remote_generate_matches_local(served_engine):
    eng, url = served_engine
    sp = SamplingParams(n=2, temperature=0.0, max_tokens=6)
    local = eng.generate(["hello remote"], sp)[0]
    remote = RemoteEngineAdapter(EngineClient(url)).generate(["hello remote"], sp)[0]
    assert [o.token_ids for o in remote.outputs] == [o.token_ids for o in local.outputs]
    for lo, ro in zip(local.outputs, remote.outputs):
        assert ro.cumulative_logprob == pytest.approx(lo.cumulative_logprob, abs=1e-4)


def test_reset_prefix_cache_endpoint(served_engine):
    eng, url = served_engine
    client = EngineClient(url)
    eng.generate(["a prompt long enough to be cached by the prefix store: 64 tokens or more"],
                 SamplingParams(n=1, temperature=0.0, max_tokens=2))
    assert len(eng.prefix_cache) > 0
    assert _raw(url, "GET", "/prefix_cache_stats")[1]["entries"] == len(eng.prefix_cache)
    assert client.reset_prefix_cache()
    assert len(eng.prefix_cache) == 0


def test_unknown_route_404(served_engine):
    _, url = served_engine
    assert _raw(url, "GET", "/nope")[0] == 404
    assert _raw(url, "POST", "/nope", {})[0] == 404
    with pytest.raises(EngineHTTPError) as e:
        EngineClient(url)._json("GET", "/nope")
    assert e.value.status == 404


def test_continuous_server_concurrent_requests():
    """Concurrent /generate requests batch on one scheduler and both
    complete."""
    eng, httpd, client = _continuous(4)
    try:
        results = {}

        def call(name, max_tokens):
            results[name] = client.generate([f"request {name}"], n=1, temperature=0.5,
                                            max_tokens=max_tokens)

        ts = [threading.Thread(target=call, args=a) for a in (("A", 24), ("B", 5))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert len(results["A"]["completion_ids"][0][0]) == 24
        assert len(results["B"]["completion_ids"][0][0]) == 5
        assert httpd.engine_server.scheduler.waves >= 1
    finally:
        httpd.shutdown()
    assert httpd.engine_server.scheduler._thread is None  # shutdown stops the scheduler


def test_streaming_generate_continuous():
    """Deltas at chunk granularity concatenate to each finish event, and the
    stream ends with done."""
    _, httpd, client = _continuous(5)
    try:
        events = list(client.generate_stream(["stream me", "and me too"], n=1,
                                             temperature=0.0, max_tokens=12))
        assert events[-1]["type"] == "done"
        for tag in (0, 1):
            deltas = [e for e in events if e["type"] == "delta" and e["tag"] == tag]
            finish = [e for e in events if e["type"] == "finish" and e["tag"] == tag]
            assert len(finish) == 1 and finish[0]["sample"] == 0
            assert len(deltas) >= 2
            assert [t for e in deltas for t in e["token_ids"]] == finish[0]["token_ids"]
            assert [x for e in deltas for x in e["logprobs"]] == pytest.approx(
                finish[0]["logprobs"], abs=1e-6)
        assert sum(e["type"] == "request_done" for e in events) == 2
    finally:
        httpd.shutdown()


def test_streaming_generate_sync_fallback(served_engine):
    eng, url = served_engine
    events = list(EngineClient(url).generate_stream(["fallback"], n=2, temperature=0.0,
                                                    max_tokens=5))
    assert events[-1]["type"] == "done"
    finishes = [e for e in events if e["type"] == "finish"]
    assert len(finishes) == 2
    local = eng.generate(["fallback"], SamplingParams(n=2, temperature=0.0, max_tokens=5))[0]
    assert finishes[0]["token_ids"] == local.outputs[0].token_ids


def test_streaming_submit_failure_yields_error_event():
    """n > max_batch on a streamed request: a valid NDJSON stream ending in
    error + done, nothing left decoding, and the next request streams."""
    _, httpd, client = _continuous(6, max_batch=4)
    try:
        events = list(client.generate_stream(["too wide"], n=99, temperature=0.0,
                                             max_tokens=4))
        assert events[-1]["type"] == "done"
        errs = [e for e in events if e["type"] == "error"]
        assert len(errs) == 1 and "max_batch" in errs[0]["error"]
        assert not any(e["type"] in ("delta", "finish") for e in events)
        ok = list(client.generate_stream(["fine"], n=2, temperature=0.0, max_tokens=4))
        assert ok[-1]["type"] == "done"
        assert sorted(e["sample"] for e in ok if e["type"] == "finish") == [0, 1]
    finally:
        httpd.shutdown()


def test_streaming_sync_fallback_failure_is_clean(served_engine):
    eng, url = served_engine
    client = EngineClient(url)

    def boom(*a, **k):
        raise RuntimeError("injected-engine-failure")

    eng.generate = boom
    try:
        events = list(client.generate_stream(["x"], n=1, temperature=0.0, max_tokens=4))
    finally:
        del eng.generate
    assert [e["type"] for e in events] == ["error", "done"]
    assert "injected-engine-failure" in events[0]["error"]
    ok = list(client.generate_stream(["y"], n=1, temperature=0.0, max_tokens=4))
    assert ok[-1]["type"] == "done"


def test_profile_endpoints(tmp_path):
    """/start_profile + /stop_profile bracket a torch.profiler trace of the
    requests in between, written under the log dir; errors are clean JSON."""
    _, _, tcfg, tp = _weights(3)
    eng = Engine(tp, tcfg, ByteTok(), **SYNC)
    httpd = engine_server.serve(eng, port=0, background=True,
                                profile_dir=str(tmp_path / "trace"))
    url = _url(httpd)
    try:
        status, body = _raw(url, "POST", "/stop_profile", {})
        assert status == 500 and "no profile" in body["error"]
        status, body = _raw(url, "POST", "/start_profile", {})
        assert status == 200 and body["ok"]
        status, body = _raw(url, "POST", "/start_profile", {})
        assert status == 500 and "already" in body["error"]
        status, _ = _raw(url, "POST", "/generate",
                         {"prompts": ["ab"], "max_tokens": 4, "temperature": 0.0})
        assert status == 200
        status, body = _raw(url, "POST", "/stop_profile", {})
        assert status == 200 and body["ok"]
        traces = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
        assert len(traces) == 1
        with open(traces[0]) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        # the handler thread's engine ops are in the trace
        assert "aten::mm" in names or "aten::addmm" in names
    finally:
        httpd.shutdown()


def _write_checkpoint(tcfg, tp, d):
    loader.export_hf(tp, tcfg, d)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
                   "vocab_size": V, "hidden_size": tcfg.hidden_size,
                   "intermediate_size": tcfg.intermediate_size,
                   "num_hidden_layers": tcfg.num_hidden_layers,
                   "num_attention_heads": tcfg.num_attention_heads,
                   "num_key_value_heads": tcfg.num_key_value_heads,
                   "max_position_embeddings": tcfg.max_position_embeddings,
                   "rope_theta": tcfg.rope_theta, "rms_norm_eps": tcfg.rms_norm_eps,
                   "tie_word_embeddings": True, "torch_dtype": "float32"}, f)


def test_main_serves_and_reloads_weights(tmp_path, monkeypatch):
    """The CLI on the CPU (f32 loads): continuous by default, then
    /reload_weights from the same directory gives the same greedy answer
    and clears the prefix store; without a card --device cuda raises;
    --spec-decode pld serves through the sync path; --sequence-parallel 2
    (not ported) raises."""
    _, _, tcfg, tp = _weights(7)
    d = str(tmp_path / "ckpt")
    _write_checkpoint(tcfg, tp, d)
    load = loader.load_params
    monkeypatch.setattr(loader, "load_params",
                        lambda *a, **k: load(*a, **{**k, "dtype": torch.float32}))
    args = ["--model", d, "--port", "0", "--host", "127.0.0.1", "--device", "cpu",
            "--max-model-len", "128", "--max-batch", "4", "--prompt-slab", "64"]
    httpd = engine_server.main(args, tokenizer_override=ByteTok(), background=True)
    try:
        srv = httpd.engine_server
        assert srv.scheduler is not None and srv.engine.device == torch.device("cpu")
        client = EngineClient(_url(httpd))
        payload = dict(n=1, temperature=0.0, max_tokens=6)
        prompt = ["reload me please: a prompt long enough for the prefix store to keep it"]
        before = client.generate(prompt, **payload)
        assert len(srv.engine.prefix_cache) == 1
        old = srv.engine.params["embed"]["weight"]
        assert client.update_named_param(path=d) == {"ok": True, "path": d}
        assert srv.engine.params["embed"]["weight"] is not old
        assert len(srv.engine.prefix_cache) == 0
        assert client.generate(prompt, **payload) == before
    finally:
        httpd.shutdown()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine_server.main(["--model", d, "--port", "0"], tokenizer_override=ByteTok(),
                               background=True)
    httpd = engine_server.main(["--model", d, "--device", "cpu", "--port", "0", "--host",
                                "127.0.0.1", "--spec-decode", "pld"],
                               tokenizer_override=ByteTok(), background=True)
    try:
        srv = httpd.engine_server
        assert srv.scheduler is None and srv.engine.spec_decode == "pld"
    finally:
        httpd.shutdown()
    with pytest.raises(ValueError, match="not yet ported"):
        engine_server.main(["--model", d, "--device", "cpu", "--sequence-parallel", "2"],
                           tokenizer_override=ByteTok(), background=True)


@pytest.fixture(scope="module")
def both_servers():
    """JAX's server and the port's, sync, over the same weights."""
    jcfg, jp, tcfg, tp = _weights(8)
    jeng = JEngine(jp, jcfg, ByteTok(), approx_top_k=False, **SYNC)
    teng = Engine(tp, tcfg, ByteTok(), **SYNC)
    jhttpd = jserver.serve(jeng, port=0, background=True)
    thttpd = engine_server.serve(teng, port=0, background=True)
    yield _url(jhttpd), _url(thttpd)
    jhttpd.shutdown()
    thttpd.shutdown()


WIRE = dict(n=2, temperature=0.0, max_tokens=8)
PROMPTS = ["wire format check", "second prompt here"]


def _same_answers(a, b):
    assert a["completion_ids"] == b["completion_ids"]
    assert a["finish_reasons"] == b["finish_reasons"]
    assert a["texts"] == b["texts"]
    for x, y in zip(a["logprobs"], b["logprobs"]):
        for u, w in zip(x, y):
            np.testing.assert_allclose(u, w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("direction", ["port_client_to_jax_server",
                                       "jax_client_to_port_server"])
def test_wire_between_port_and_jax(both_servers, direction):
    """Each client against the other side's server: the greedy payload's
    answer equals the one the server's own client gets (byte for byte) and
    the other side's server's (ids, finish reasons, texts; logprobs within
    1e-4), streamed too; health and world size answer."""
    jurl, turl = both_servers
    if direction == "port_client_to_jax_server":
        client, own, url, other = EngineClient(jurl), JClient(jurl), jurl, JClient(turl)
    else:
        client, own, url, other = JClient(turl), EngineClient(turl), turl, EngineClient(jurl)
    assert client.check_server(total_timeout=10) and client.get_world_size() >= 1
    got = client.generate(PROMPTS, **WIRE)
    assert json.dumps(got) == json.dumps(own.generate(PROMPTS, **WIRE))
    _same_answers(got, other.generate(PROMPTS, **WIRE))
    events = list(client.generate_stream(PROMPTS, **WIRE))
    assert events[-1] == {"type": "done"}
    finish = sorted((e["tag"], e["sample"], e["token_ids"]) for e in events
                    if e["type"] == "finish")
    assert [f[2] for f in finish] == [ids for p in got["completion_ids"] for ids in p]
    assert client.reset_prefix_cache()
