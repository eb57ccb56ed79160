"""The port's stdlib HTTP server on the CPU at ``tiny`` (float32), against the
JAX engine's greedy tokens for the same prompt and weights."""

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models.transformer import init_params as jax_init_params
from llmd_tpu_torch.engine import EngineConfig
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.engine.tokenizer import ByteTokenizer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models.transformer import params_from_numpy

# top-level keys of the reference server's non-streaming completion
# (llmd_tpu/engine/server.py `_generate`, payload dict)
REFERENCE_KEYS = {"id", "object", "created", "model", "usage", "choices"}
KW = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
          prefill_chunk=32, decode_steps=4)
PROMPT = "The quick brown fox jumps"


@pytest.fixture(scope="module")
def served():
    jcfg = dataclasses.replace(jax_model_config("tiny"), dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    ref = JaxEngine(jcfg, JaxEngineConfig(**KW, attn_impl="reference"), params=jp)
    ids = ByteTokenizer().encode(PROMPT)
    # the server adds the tokenizer's EOS as a stop token, so the reference does too
    want = ref.generate([ids], JaxSamplingParams(
        max_tokens=12, temperature=0.0, stop_token_ids=(ByteTokenizer.eos_id,)))["req-0"]
    tcfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    params = params_from_numpy(tcfg, {k: np.asarray(v) for k, v in jp.items()})
    server = EngineServer(tcfg, EngineConfig(**KW), host="127.0.0.1", port=0,
                          params=params, device="cpu")
    server.start()
    try:
        yield f"http://{server.address}", server, want
    finally:
        server.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, body, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health_and_models(served):
    base, server, _ = served
    assert _get(base + "/health") == (200, {"status": "ok"})
    status, body = _get(base + "/v1/models")
    assert status == 200 and body["data"][0]["id"] == server.model_name == "llmd-tpu/tiny"


def test_greedy_completion_matches_reference(served):
    base, server, want = served
    status, body = _post(base + "/v1/completions",
                         {"prompt": PROMPT, "max_tokens": 12, "temperature": 0})
    assert status == 200
    assert set(body) == REFERENCE_KEYS
    assert body["object"] == "text_completion"
    assert body["choices"][0]["text"] == ByteTokenizer().decode(want)
    assert body["usage"]["prompt_tokens"] == len(PROMPT)
    assert body["usage"]["completion_tokens"] == len(want)
    # token-id prompt (``prompt_token_ids``: a list ``prompt`` is text, as the
    # reference reads it), same request: same text, and the prompt's full
    # pages now come from the prefix cache
    status, again = _post(base + "/v1/completions", {
        "prompt_token_ids": ByteTokenizer().encode(PROMPT), "max_tokens": 12,
        "temperature": 0})
    assert status == 200
    assert again["choices"][0]["text"] == body["choices"][0]["text"]
    assert again["usage"]["cached_tokens"] == len(PROMPT) // 8 * 8


def test_stop_string_cuts_text(served):
    base, _, want = served
    text = ByteTokenizer().decode(want)
    stop = text[3:5]
    status, body = _post(base + "/v1/completions", {
        "prompt": PROMPT, "max_tokens": 12, "temperature": 0, "stop": [stop]})
    assert status == 200
    assert body["choices"][0]["text"] == text[: text.find(stop)]
    assert body["choices"][0]["finish_reason"] == "stop"


def test_serve_cli_starts_on_cpu():
    """``python -m llmd_tpu_torch.engine.serve --cpu`` binds and answers /health."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "llmd_tpu_torch.engine.serve", "--model", "tiny",
         "--cpu", "--host", "127.0.0.1", "--port", "0", "--num-pages", "32"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving llmd-tpu/tiny on http://" in line, proc.stderr.read()
        addr = line.split("http://")[1].split()[0]
        assert _get(f"http://{addr}/health") == (200, {"status": "ok"})
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_serve_cli_fp8_pool_on_cpu():
    """``--kv-cache-dtype fp8`` (the reference CLI's flag) serves over a
    float8_e4m3fn pool, says so on its first line, and completes."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "llmd_tpu_torch.engine.serve", "--model", "tiny",
         "--cpu", "--host", "127.0.0.1", "--port", "0", "--num-pages", "32",
         "--kv-cache-dtype", "fp8"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "KV pool fp8" in line, proc.stderr.read()
        addr = line.split("http://")[1].split()[0]
        status, body = _post(f"http://{addr}/v1/completions",
                             {"prompt": "hi", "max_tokens": 4, "temperature": 0})
        assert status == 200 and body["usage"]["completion_tokens"] == 4
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_bad_requests_are_400(served):
    base, _, _ = served
    assert _post(base + "/v1/completions", None, raw=b"{not json")[0] == 400
    # a stream is served, but its request is checked before the stream starts
    assert _post(base + "/v1/completions", {"prompt": "x", "stream": True,
                                            "guided_regex": "(ab"})[0] == 400
    assert _post(base + "/v1/completions", {"prompt": "x", "logit_bias": {"1": 300}})[0] == 400
    assert _post(base + "/v1/completions", {"prompt": ""})[0] == 400
    assert _post(base + "/v1/chat/completions", {"messages": []})[0] == 400  # empty prompt
    assert _post(base + "/v1/embeddings", {"input": [[]]})[0] == 400  # an empty item
    assert _post(base + "/v1/embeddings", {})[0] == 400  # no input


def test_stream_disconnect_aborts_the_request(served):
    """A client that goes away mid-stream: the next write fails, and the
    request is aborted rather than generated to its end."""
    import http.client
    import time

    base, server, _ = served
    decoded = server.engine.metrics.decode_tokens
    before = decoded.value
    host, port = server.address.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    conn.request("POST", "/v1/completions", json.dumps({
        "prompt": "x", "max_tokens": 240, "temperature": 0, "ignore_eos": True,
        "stream": True}), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.readline().startswith(b"data: ")  # the first event
    conn.sock.shutdown(2)
    conn.close()
    t0 = time.monotonic()
    while server.engine.seqs and time.monotonic() - t0 < 30:
        time.sleep(0.01)
    assert not server.engine.seqs
    time.sleep(0.2)  # a decode call in flight lands
    assert decoded.value - before < 200  # aborted well before its 240 tokens
