"""The embed program and ``/v1/embeddings`` in the port against the JAX
package, on the CPU in float32.

- ``LLMEngine.embed`` (mean-pooled, L2-normalised final hidden states over
  chunks of ``prefill_chunk``) equals the JAX engine's on ``tiny`` and
  ``tiny-moe`` (sorted and einsum dispatch) for inputs of one chunk, several
  chunks and past ``max_model_len`` (truncated), with and without an adapter
  loaded from the same arrays: max abs <= 1e-5 per element. The borrowed
  pages all go back, and a pool too small answers ``RuntimeError``.
- The port server's ``/v1/embeddings`` against the reference
  ``EngineServer``: a string, a list of strings, a token list and a list of
  token lists, under ``model`` = an adapter and ``lora_adapter``; 400 on a
  missing or empty input, 404 on an unknown adapter, 503 while draining;
  the same status codes, keys and usage, vectors within 1e-5. A token id
  past the vocabulary is a 400 in the port (the reference's XLA gather
  clamps it; on the card the lookup would fault).
"""

import dataclasses
import functools
import json

import aiohttp
import jax
import numpy as np
import pytest
import torch

from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.server import EngineServer as JaxEngineServer
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import lora as jl
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import lora as tl
from llmd_tpu_torch.models import transformer as tt
from tests.conftest import run_async

ATOL = 1e-5
LCFG = dict(max_adapters=2, rank=4)
KW = dict(page_size=8, num_pages=64, max_model_len=160, max_batch_size=4, prefill_chunk=32)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _weights(model: str):
    jcfg = dataclasses.replace(jax_model_config(model), dtype="float32")
    tcfg = dataclasses.replace(get_model_config(model), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    ad = jl.make_adapter_weights(jcfg, jl.LoRAConfig(**LCFG), jax.random.PRNGKey(5))
    return (jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()},
            {k: np.asarray(v, np.float32) for k, v in ad.items()})


def _pair(model: str, **over):
    jcfg, tcfg, jp, npp, ad = _weights(model)
    kw = {**KW, **over}
    je = JaxEngine(jcfg, JaxEngineConfig(**kw, attn_impl="reference",
                                         lora=jl.LoRAConfig(**LCFG)), params=jp)
    te = LLMEngine(tcfg, EngineConfig(**kw, lora=tl.LoRAConfig(**LCFG)),
                   params=tt.params_from_numpy(tcfg, npp), device="cpu")
    for eng in (je, te):
        eng.load_lora_adapter("ad", ad)
    return je, te


CASES = {"tiny": ("tiny", {}), "tiny-moe-sorted": ("tiny-moe", {"moe_dispatch": "sorted"}),
         "tiny-moe-einsum": ("tiny-moe", {"moe_dispatch": "einsum"})}


@pytest.mark.parametrize("case", list(CASES))
def test_embed_matches_reference(case):
    model, over = CASES[case]
    je, te = _pair(model, **over)
    free = te.alloc.num_free
    rng = np.random.default_rng(1)
    vocab = te.model_cfg.vocab_size
    inputs = [rng.integers(1, vocab, n).tolist() for n in (5, 32, 97, 200)]  # 200: truncated
    for ids in inputs:
        for lora in (None, "ad"):
            want = np.asarray(je.embed(ids, lora))
            got = np.asarray(te.embed(ids, lora))
            assert got.shape == (te.model_cfg.hidden_size,)
            assert np.abs(got - want).max() <= ATOL, (len(ids), lora)
            assert abs(np.linalg.norm(got) - 1.0) < 1e-6
    base, tuned = te.embed(inputs[2]), te.embed(inputs[2], "ad")
    assert np.abs(np.asarray(base) - np.asarray(tuned)).max() > 1e-3
    assert te.alloc.num_free == free  # every borrowed page went back
    assert te.programs.quiesced()


def test_embed_refusals():
    _, te = _pair("tiny", num_pages=4, max_model_len=64)
    with pytest.raises(ValueError, match="empty"):
        te.embed([])
    with pytest.raises(ValueError, match="vocab"):
        te.embed([1, te.model_cfg.vocab_size])  # would fault the card's lookup
    with pytest.raises(RuntimeError, match="no free KV pages"):
        te.embed(list(range(1, 60)))  # 8 pages needed, 4 in the pool
    assert te.alloc.num_free == 4


async def _call(sess, url, body, headers=None):
    async with sess.post(url, json=body, headers=headers) as r:
        return r.status, json.loads(await r.read())


SCRIPT = [
    {"input": "hello embeddings"},
    {"input": ["first text", "second, longer text for two chunks " * 2]},
    {"input": [5, 6, 7, 8, 9, 10, 11]},
    {"input": [[5, 6, 7], list(range(20, 90))]},
    {"input": "tuned text", "model": "ad"},
    {"input": "tuned text"},
    {"input": [[3, 4, 5, 6]], "lora_adapter": "ad"},
    {"input": "x", "lora_adapter": "nope"},
    {"input": ["fine", ""]},
    {"input": [[]]},
    {},
]


async def _script(base: str, npz: str) -> list:
    out = []
    async with aiohttp.ClientSession() as s:
        await _call(s, base + "/v1/load_lora_adapter", {"lora_name": "ad", "lora_path": npz})
        for body in SCRIPT:
            out.append(await _call(s, base + "/v1/embeddings", body))
        async with s.post(base + "/drain?timeout_s=5", json={}) as r:
            assert r.status == 200
        out.append(await _call(s, base + "/v1/embeddings", {"input": "late"}))
    return out


def test_server_embeddings_match_reference(tmp_path):
    jcfg, tcfg, jp, npp, ad = _weights("tiny")
    npz = str(tmp_path / "ad.npz")
    np.savez(npz, **ad)

    async def scenario():
        ref = JaxEngineServer(jcfg, JaxEngineConfig(**KW, attn_impl="reference",
                                                    lora=jl.LoRAConfig(**LCFG)),
                              model_name="m", host="127.0.0.1", port=0, params=jp)
        ours = EngineServer(tcfg, EngineConfig(**KW, lora=tl.LoRAConfig(**LCFG)),
                            model_name="m", host="127.0.0.1", port=0,
                            params=tt.params_from_numpy(tcfg, npp), device="cpu")
        await ref.start()
        ours.start()
        try:
            return (await _script(f"http://{ref.address}", npz),
                    await _script(f"http://{ours.address}", npz))
        finally:
            await ref.stop()
            ours.stop()

    want, got = run_async(scenario())
    assert [s for s, _ in got] == [s for s, _ in want] == [
        200, 200, 200, 200, 200, 200, 200, 404, 400, 400, 400, 503]
    for (_, w), (_, g) in zip(want, got):
        if "data" not in w:
            assert g == w
            continue
        assert {k: v for k, v in g.items() if k != "data"} == {
            k: v for k, v in w.items() if k != "data"}
        assert [(d["object"], d["index"]) for d in g["data"]] == [
            (d["object"], d["index"]) for d in w["data"]]
        for dg, dw in zip(g["data"], w["data"]):
            assert np.abs(np.asarray(dg["embedding"]) - np.asarray(dw["embedding"])).max() <= ATOL
    # the adapter's vector differs from the base model's on the same text
    assert got[4][1]["model"] == "ad"
    assert np.abs(np.asarray(got[4][1]["data"][0]["embedding"])
                  - np.asarray(got[5][1]["data"][0]["embedding"])).max() > 1e-3
