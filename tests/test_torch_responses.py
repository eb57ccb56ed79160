"""``/v1/responses`` and ``/v1/conversations`` on the port server against the
reference ``EngineServer`` (the scenarios of ``tests/test_responses_api.py``),
on the CPU with the same float32 weights: every answer's code, the
conversation's items and the greedy text equal the reference's for the same
bodies, and a response's text equals ``/v1/chat/completions``' for the same
messages. Ids and timestamps (minted per call) are left out.
"""

import dataclasses
import functools

import aiohttp
import jax
import numpy as np
import pytest
import torch

from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine.server import EngineServer as JaxEngineServer
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.engine import EngineConfig
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from tests.conftest import run_async

KW = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4, prefill_chunk=32)
_MINTED = {"id", "created_at", "created"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _weights():
    jcfg = dataclasses.replace(jax_model_config("tiny"), dtype="float32")
    tcfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _stable(obj, cid=None):
    """``obj`` without minted ids and timestamps; the conversation id ``cid``
    (minted by each server) read as "<cid>"."""
    if isinstance(obj, dict):
        return {k: _stable(v, cid) for k, v in obj.items() if k not in _MINTED}
    if isinstance(obj, list):
        return [_stable(v, cid) for v in obj]
    return "<cid>" if cid is not None and obj == cid else obj


async def _call(sess, method, url, body=None, cid=None):
    async with sess.request(method, url, json=body) as r:
        return r.status, _stable(await r.json(), cid)


async def _responses_scenario(base: str) -> list:
    out = []
    async with aiohttp.ClientSession() as s:
        for body in ({"model": "m", "input": "Hello", "max_output_tokens": 5,
                      "temperature": 0.0, "ignore_eos": True},
                     {"model": "m", "max_output_tokens": 4, "temperature": 0.0,
                      "ignore_eos": True,
                      "input": [{"role": "user", "content": "first"},
                                {"role": "user", "content": "second"}]},
                     {"model": "m", "input": "x", "max_output_tokens": 3,
                      "temperature": 0.0, "guided_regex": "("}):
            out.append(await _call(s, "POST", f"{base}/v1/responses", body))
        async with s.post(f"{base}/v1/responses", data=b"{not json") as r:
            out.append(r.status)
    return out


async def _conversations_scenario(base: str) -> list:
    out = []
    async with aiohttp.ClientSession() as s:
        async with s.post(f"{base}/v1/conversations", json={}) as r:
            conv = await r.json()
        cid = conv["id"]
        out.append((r.status, _stable(conv)))
        out.append(await _call(s, "POST", f"{base}/v1/responses", {
            "model": "m", "input": "remember the number 7", "max_output_tokens": 4,
            "temperature": 0.0, "ignore_eos": True, "conversation": cid}, cid))
        out.append(await _call(s, "GET", f"{base}/v1/conversations/{cid}/items"))
        out.append(await _call(s, "POST", f"{base}/v1/responses", {
            "model": "m", "input": "and now?", "max_output_tokens": 4,
            "temperature": 0.0, "ignore_eos": True, "conversation": cid}, cid))
        out.append(await _call(s, "POST", f"{base}/v1/conversations/{cid}/items",
                               {"items": [{"role": "user", "content": "more"}]}))
        out.append(await _call(s, "GET", f"{base}/v1/conversations/{cid}/items"))
        out.append(await _call(s, "GET", f"{base}/v1/conversations/{cid}"))
        out.append(await _call(s, "POST", f"{base}/v1/responses",
                               {"model": "m", "input": "x", "conversation": "conv_nope"}))
        out.append(await _call(s, "GET", f"{base}/v1/conversations/conv_nope/items"))
        out.append(await _call(s, "POST", f"{base}/v1/conversations/conv_nope/items",
                               {"items": []}))
        out.append(await _call(s, "DELETE", f"{base}/v1/conversations/{cid}"))
        out.append(await _call(s, "GET", f"{base}/v1/conversations/{cid}"))
        out.append(await _call(s, "DELETE", f"{base}/v1/conversations/{cid}"))
        # a router-chosen id is kept
        out.append(await _call(s, "POST", f"{base}/v1/conversations",
                               {"id": "conv_router_1", "items": [{"role": "user",
                                                                  "content": "hi"}]}))
        out.append(await _call(s, "GET", f"{base}/v1/conversations/conv_router_1/items"))
    return out


async def _chat_vs_response(base: str) -> tuple:
    messages = [{"role": "user", "content": "first"}, {"role": "user", "content": "second"}]
    async with aiohttp.ClientSession() as s:
        _, chat = await _call(s, "POST", f"{base}/v1/chat/completions", {
            "model": "m", "messages": messages, "max_tokens": 6, "temperature": 0.0,
            "ignore_eos": True})
        _, resp = await _call(s, "POST", f"{base}/v1/responses", {
            "model": "m", "input": messages, "max_output_tokens": 6, "temperature": 0.0,
            "ignore_eos": True})
    return chat["choices"][0]["message"]["content"], resp["output"][0]["content"][0]["text"]


async def _both(scenario):
    jcfg, tcfg, jp, npp = _weights()
    ref = JaxEngineServer(jcfg, JaxEngineConfig(**KW, attn_impl="reference"), model_name="m",
                          host="127.0.0.1", port=0, params=jp)
    port = EngineServer(tcfg, EngineConfig(**KW), model_name="m", host="127.0.0.1", port=0,
                        params=tt.params_from_numpy(tcfg, npp), device="cpu")
    await ref.start()
    port.start()
    try:
        return (await scenario(f"http://{port.address}"),
                await scenario(f"http://{ref.address}"))
    finally:
        port.stop()
        await ref.stop()


@pytest.fixture(autouse=True)
def no_probe(monkeypatch):
    monkeypatch.setenv("LLMD_FABRIC_PROBE_INTERVAL_S", "0")


def test_responses_match_reference():
    port, ref = run_async(_both(_responses_scenario))
    assert port == ref
    code, first = port[0]
    assert code == 200 and first["status"] == "incomplete"
    assert first["incomplete_details"] == {"reason": "max_output_tokens"}
    assert first["usage"]["output_tokens"] == 5
    assert port[2][0] == 400 and port[3] == 400


def test_conversations_match_reference():
    port, ref = run_async(_both(_conversations_scenario))
    assert port == ref
    items = port[2][1]["data"]
    assert [i["role"] for i in items] == ["user", "assistant"]
    assert [c for c, _ in port[7:10]] == [404, 404, 404]
    assert port[10][1]["deleted"] is True and port[11][0] == 404 and port[12][0] == 404


def test_response_text_equals_chat():
    (port_chat, port_resp), (ref_chat, ref_resp) = run_async(_both(_chat_vs_response))
    assert port_resp == port_chat == ref_chat == ref_resp
