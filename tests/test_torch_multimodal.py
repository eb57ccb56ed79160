"""Multimodal serving in the port against the JAX package, on the CPU at
``tiny-vl`` in float32: the reference's ``tests/test_multimodal.py``, case for
case, against port engines, port encode workers and port servers (the E/PD,
E/P/D, degrade and partial-failure cases through the reference's
``RoutingSidecar`` in front of them, and again through the port's, which
must answer and count as the reference's), then the cross-package checks.

Both packages load the same numpy weights: the language model's from the
reference's ``init_params`` and the tower's from its ``init_vision_params``
(the port's default tower is a test double drawn from a ``torch.Generator``).
Where a JAX server answers, the chat body carries the E stage's wire items,
so neither side runs its own tower. Tolerances: greedy tokens, texts, block
keys and KV-event keys identical.
"""

import base64
import dataclasses
import functools
import inspect
import json

import aiohttp
import jax
import numpy as np
import pytest
import torch

from llmd_tpu.core import request as jr
from llmd_tpu.core.kv_events import block_keys_for_tokens as ref_block_keys
from llmd_tpu.core.request import HDR_PREFILLER_HOST_PORT
from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.disagg.sidecar import RoutingSidecar
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.server import EngineServer as JaxEngineServer
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu.models import vision as jv
from llmd_tpu_torch.core.kv_events import BlockStored, block_keys_for_tokens
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.disagg.sidecar import RoutingSidecar as PortSidecar
from llmd_tpu_torch.disagg.encode import (
    EncodeServer,
    VisionRunner,
    media_bytes_from_part,
    mm_item_from_wire,
    mm_item_to_wire,
    part_identity,
)
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from tests.conftest import run_async

KW = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4, prefill_chunk=32)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _weights(head_dim: "int | None" = None):
    """(jax cfg, port cfg, jax params, numpy params, numpy tower params) of
    float32 tiny-vl."""
    over = {"dtype": "float32"} | ({"head_dim": head_dim} if head_dim else {})
    jcfg = dataclasses.replace(jax_model_config("tiny-vl"), **over)
    tcfg = dataclasses.replace(get_model_config("tiny-vl"), **over)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    vp = jv.init_vision_params(jcfg, jax.random.PRNGKey(1))
    return (jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()},
            {k: np.asarray(v) for k, v in vp.items()})


CFG = _weights()[1]


@functools.cache
def _runner() -> VisionRunner:
    return VisionRunner(CFG, device="cpu", params=_weights()[4])


def _data_uri(payload: bytes) -> dict:
    return {"type": "image_url",
            "image_url": {"url": "data:image/x-raw;base64,"
                          + base64.b64encode(payload).decode()}}


def _port_engine(head_dim=None, sink=None, **over) -> LLMEngine:
    _, tcfg, _, npp, _ = _weights(head_dim)
    return LLMEngine(tcfg, EngineConfig(**{**KW, **over}), params=tt.params_from_numpy(tcfg, npp),
                     device="cpu", event_sink=sink)


def _jax_engine(sink=None, **over) -> JaxEngine:
    jcfg, _, jp, _, _ = _weights()
    return JaxEngine(jcfg, JaxEngineConfig(**{**KW, **over}, attn_impl="reference"), params=jp,
                     event_sink=sink)


def _port_server(cfg=None, head_dim=None, **kw) -> EngineServer:
    """A port server of the reference's weights; a server with a tower gets
    the reference's tower leaves as its in-process tower."""
    _, tcfg, _, npp, vp = _weights(head_dim)
    cfg = cfg or tcfg
    srv = EngineServer(cfg, EngineConfig(**KW), model_name="vl", host="127.0.0.1", port=0,
                       params=tt.params_from_numpy(cfg, npp), device="cpu", **kw)
    if cfg.has_vision:
        srv._vision = VisionRunner(cfg, device="cpu", params=vp)
    return srv


def _jax_server(head_dim=None, **kw) -> JaxEngineServer:
    jcfg, _, jp, _, _ = _weights(head_dim)
    return JaxEngineServer(jcfg, JaxEngineConfig(**KW, attn_impl="reference"), model_name="vl",
                           host="127.0.0.1", port=0, params=jp, **kw)


def _encoder() -> EncodeServer:
    """A port encode worker whose tower holds the reference's leaves."""
    enc = EncodeServer(CFG, device="cpu")
    enc.runner_ = VisionRunner(CFG, device="cpu", params=_weights()[4])
    return enc


async def _start(*servers):
    """Start each (the reference's servers are coroutines, the port's not)."""
    for s in servers:
        if inspect.isawaitable(r := s.start()):
            await r


async def _stop(*servers):
    for s in servers:
        if inspect.isawaitable(r := s.stop()):
            await r


def _generate(eng, rid, prompt, mm_items, max_tokens=6):
    sp = (JaxSamplingParams if isinstance(eng, JaxEngine) else SamplingParams)(
        max_tokens=max_tokens, temperature=0.0, ignore_eos=True)
    eng.add_request(rid, list(prompt), sp, mm_items=mm_items)
    out = []
    while eng.has_work():
        for o in eng.step():
            out.extend(o.new_token_ids)
    return out


def _vl_prompt():
    k = CFG.mm_tokens
    return list(range(10, 20)) + [CFG.mm_placeholder_id] * k + list(range(30, 40))


def _wire(parts: list[dict]) -> list[dict]:
    """The E stage's wire items for ``parts`` (the port's runner)."""
    payloads = [media_bytes_from_part(p) for p in parts]
    return [mm_item_to_wire(part_identity(p), e)
            for p, (_, e) in zip(parts, _runner().encode(payloads))]


async def _post(sess, url, body, headers=None):
    async with sess.post(url, json=body, headers=headers or {}) as r:
        return r.status, await r.json()


# ---------------------------------------------------------------- vision tower


def test_vision_runner_deterministic_and_cached():
    r1, r2 = VisionRunner(CFG, device="cpu"), VisionRunner(CFG, device="cpu")
    [(h1, e1)] = r1.encode([b"same-image-bytes"])
    [(h2, e2)] = r2.encode([b"same-image-bytes"])
    assert h1 == h2
    np.testing.assert_array_equal(e1, e2)  # workers are interchangeable
    assert e1.shape == (CFG.mm_tokens, CFG.hidden_size)
    [(h3, e3)] = r1.encode([b"different-bytes"])
    assert h3 != h1 and not np.array_equal(e3, e1)
    r1.encode([b"same-image-bytes"])
    assert r1.stats["cache_hits"] == 1


def test_media_part_parsing():
    assert media_bytes_from_part(_data_uri(b"xyz")) == b"xyz"
    assert media_bytes_from_part({"type": "text", "text": "hi"}) is None
    assert media_bytes_from_part({"type": "image_url",
                                  "image_url": {"url": "http://x/y.png"}}) is None
    h, emb = VisionRunner(CFG, device="cpu").encode([b"abc"])[0]
    rt_h, rt_emb = mm_item_from_wire(mm_item_to_wire(h, emb), CFG.hidden_size)
    assert rt_h == h
    np.testing.assert_array_equal(rt_emb, emb)


# ------------------------------------------------------------ engine injection


def test_engine_injects_media_embeddings():
    runner = _runner()
    prompt = _vl_prompt()
    out_a = _generate(_port_engine(), "a", prompt, runner.encode([b"image-A"]))
    out_b = _generate(_port_engine(), "b", prompt, runner.encode([b"image-B"]))
    out_a2 = _generate(_port_engine(), "a2", prompt, runner.encode([b"image-A"]))
    assert out_a == out_a2  # deterministic given the same media
    assert out_a != out_b  # the injected rows reach the forward pass
    assert out_a == _generate(_jax_engine(), "a", prompt, runner.encode([b"image-A"]))


def test_engine_validates_mm_request():
    emb = np.zeros((CFG.mm_tokens, CFG.hidden_size), np.float32)
    cases = [(CFG, [1, 2, 3], [(b"h", emb)]),  # no placeholders for the item
             (CFG, _vl_prompt(), [(b"h", np.zeros((1, 7), np.float32))]),  # wrong width
             (get_model_config("tiny"), [1, 2, 3], [(b"h", emb)])]  # text-only model
    for cfg, prompt, items in cases:
        eng = LLMEngine(cfg, EngineConfig(**KW), device="cpu")
        ref = JaxEngine(jax_model_config(cfg.name), JaxEngineConfig(**KW, attn_impl="reference"))
        with pytest.raises(ValueError) as got:
            eng.add_request("x", prompt, SamplingParams(max_tokens=2), mm_items=items)
        with pytest.raises(ValueError) as want:
            ref.add_request("x", prompt, JaxSamplingParams(max_tokens=2), mm_items=items)
        assert str(got.value) == str(want.value)
        assert not eng.seqs and not eng.waiting


def test_media_identity_in_block_keys():
    prompt = _vl_prompt()
    plain = block_keys_for_tokens(prompt, 8)
    with_a = block_keys_for_tokens(prompt, 8, None, [b"hash-A"])
    with_b = block_keys_for_tokens(prompt, 8, None, [b"hash-B"])
    assert plain != with_a != with_b
    runner = _runner()
    eng = _port_engine()
    _generate(eng, "a", prompt, runner.encode([b"image-A"]))
    keys_a = set(eng.alloc.cached)
    _generate(eng, "b", prompt, runner.encode([b"image-B"]))
    keys_ab = set(eng.alloc.cached)
    assert keys_ab > keys_a  # B committed fresh blocks, no aliasing with A


# ----------------------------------------------------------- E worker + sidecar


async def _encode_server_scenario(srv):
    """The reference's script; returns what the worker answered and exposed."""
    await _start(srv)
    try:
        async with aiohttp.ClientSession() as sess:
            base = f"http://{srv.address}"
            st, got = await _post(sess, f"{base}/v1/encode",
                                  {"items": [_data_uri(b"img-1"), _data_uri(b"img-2")]})
            assert st == 200 and len(got["items"]) == 2
            h, emb = mm_item_from_wire(got["items"][0], CFG.hidden_size)
            assert emb.shape == (CFG.mm_tokens, CFG.hidden_size)
            assert h == part_identity(_data_uri(b"img-1"))
            remote = await _post(sess, f"{base}/v1/encode", {"items": [
                {"type": "image_url", "image_url": {"url": "http://remote"}}]})
            async with sess.post(f"{base}/v1/encode", data=b"{not json") as r:
                bad_json = r.status, await r.json()
            await _post(sess, f"{base}/v1/encode", {"items": [_data_uri(b"img-1")]})  # a hit
            async with sess.get(f"{base}/health") as r:
                health = r.status, await r.json()
            async with sess.get(f"{base}/metrics") as r:
                metrics = r.status, r.content_type, await r.read()
            return {"remote": remote, "bad_json": bad_json, "health": health,
                    "metrics": metrics, "keys": sorted(got["items"][0])}
    finally:
        await _stop(srv)


def test_encode_server():
    """The port worker: 200 with the wire items, 400 for a remote URL (no
    egress) and for a body that is not JSON, ``/health`` and ``/metrics``
    (bytes) equal to the reference's worker after the same script."""
    from llmd_tpu.disagg.encode import EncodeServer as JaxEncodeServer

    ours = run_async(_encode_server_scenario(_encoder()))
    ref = run_async(_encode_server_scenario(JaxEncodeServer(_weights()[0])))
    assert ours["remote"][0] == 400
    assert ours == ref


async def _epd_scenario(sidecar_cls=RoutingSidecar):
    """E/PD: the sidecar fans media across two port encode workers, the port
    PD engine consumes."""
    enc1, enc2 = _encoder(), _encoder()
    pd = _port_server()
    await _start(enc1, enc2, pd)
    sidecar = sidecar_cls(decode_addr=pd.address, encode_hosts=[enc1.address, enc2.address])
    await sidecar.start()
    try:
        body = {"messages": [{"role": "user", "content": [
            {"type": "text", "text": "describe"}, _data_uri(b"photo-one"),
            _data_uri(b"photo-two")]}],
            "max_tokens": 4, "temperature": 0.0, "ignore_eos": True}
        async with aiohttp.ClientSession() as sess:
            st, got = await _post(sess, f"http://{sidecar.address}/v1/chat/completions", body)
            assert st == 200 and got["choices"][0]["message"]["content"] is not None
            assert sidecar.stats["encoded_items"] == 2
            # parallel across entries: one item per worker (round-robin pool)
            assert enc1.runner_.stats["encoded_items"] == 1
            assert enc2.runner_.stats["encoded_items"] == 1
            # the same request again: E results attach again, PD prefix-cache hits
            st, again = await _post(sess, f"http://{sidecar.address}/v1/chat/completions",
                                    body)
            assert again["usage"]["cached_tokens"] > 0
            assert again["choices"] == got["choices"]
        assert pd._vision.stats["encoded_items"] == 0  # every item came over the wire
        # the rows the engine consumed are the workers' rows: combined PD with
        # the same tower answers the same text
        combined = _port_server()
        await _start(combined)
        try:
            async with aiohttp.ClientSession() as sess:
                _, local = await _post(
                    sess, f"http://{combined.address}/v1/chat/completions", body)
            assert local["choices"] == got["choices"]
        finally:
            await _stop(combined)
        return {"choices": got["choices"], "usage": again["usage"],
                "stats": dict(sidecar.stats)}
    finally:
        await _stop(sidecar, pd, enc1, enc2)


# each E/PD scenario's outcome behind the reference's sidecar, for the port's
_REFERENCE_SIDECAR: dict = {}


def test_encode_disaggregation_epd():
    _REFERENCE_SIDECAR["epd"] = run_async(_epd_scenario())


async def _combined_pd_scenario():
    """No encode pool: the PD server encodes in-process."""
    pd = _port_server()
    await _start(pd)
    try:
        async with aiohttp.ClientSession() as sess:
            texts = []
            for pic in (b"pic", b"other-pic"):
                st, r = await _post(sess, f"http://{pd.address}/v1/chat/completions", {
                    "messages": [{"role": "user", "content": [
                        {"type": "text", "text": "what is this"}, _data_uri(pic)]}],
                    "max_tokens": 4, "temperature": 0.0, "ignore_eos": True})
                assert st == 200
                texts.append(r["choices"][0]["message"]["content"])
        assert texts[0] != texts[1]  # media reaches the model through HTTP too
        assert pd._vision is not None and pd._vision.stats["encoded_items"] == 2
    finally:
        await _stop(pd)


def test_combined_pd_in_process_encode():
    run_async(_combined_pd_scenario())


async def _epd_with_kv_transfer_scenario(sidecar_cls=RoutingSidecar):
    """E + P -> D: the media request prefills on P and its blocks (keyed with
    the media hashes) move to D."""
    enc = _encoder()
    prefill, decode = _port_server(kv_transfer_port=0), _port_server(kv_transfer_port=0)
    await _start(enc, prefill, decode)
    sidecar = sidecar_cls(decode_addr=decode.address, encode_hosts=[enc.address])
    await sidecar.start()
    try:
        async with aiohttp.ClientSession() as sess:
            st, got = await _post(
                sess, f"http://{sidecar.address}/v1/chat/completions",
                {"messages": [{"role": "user", "content": [
                    {"type": "text", "text": "look at this " * 8},
                    _data_uri(b"transferred-photo")]}],
                 "max_tokens": 4, "temperature": 0.0, "ignore_eos": True},
                {HDR_PREFILLER_HOST_PORT: prefill.address})
            assert st == 200
        assert sidecar.stats["pd_requests"] == 1
        assert decode.transfer_stats["injected_blocks"] > 0, (
            "the media request's KV must move P->D (media hashes in the block keys)")
        assert got["usage"]["cached_tokens"] > 0
        assert len(prefill.transfer_source) == 0  # D notified P
        return {"choices": got["choices"], "usage": got["usage"],
                "stats": dict(sidecar.stats),
                "injected": decode.transfer_stats["injected_blocks"]}
    finally:
        await _stop(sidecar, prefill, decode, enc)


def test_multimodal_pd_kv_transfer():
    _REFERENCE_SIDECAR["pd_kv"] = run_async(_epd_with_kv_transfer_scenario())


async def _degraded_text_only_scenario(sidecar_cls=RoutingSidecar):
    """Encode pool down and a PD server without a tower: the media request
    degrades to the text-only flattening (200), never a 400 or 500."""
    towerless = dataclasses.replace(CFG, name="tiny-vl-pd", vision_layers=0)
    assert towerless.mm_tokens > 0 and not towerless.has_vision
    pd = _port_server(cfg=towerless)
    await _start(pd)
    sidecar = sidecar_cls(decode_addr=pd.address, encode_hosts=["127.0.0.1:9"],
                             encode_timeout_s=0.3)
    await sidecar.start()
    try:
        body = {"messages": [{"role": "user", "content": [
            {"type": "text", "text": "hello"}, _data_uri(b"pic")]}],
            "max_tokens": 3, "temperature": 0.0, "ignore_eos": True}
        async with aiohttp.ClientSession() as sess:
            st, got = await _post(sess, f"http://{sidecar.address}/v1/chat/completions", body)
            assert st == 200 and got["choices"][0]["message"]["content"] is not None
            # the text-only rendering: flatten's tokens, no placeholder
            assert got["usage"]["prompt_tokens"] == len(
                pd.tokenizer.encode(jr.flatten_messages(body["messages"])))
        assert sidecar.stats["encode_failures"] == 1
        return {"choices": got["choices"], "usage": got["usage"],
                "stats": dict(sidecar.stats)}
    finally:
        await _stop(sidecar, pd)


def test_encode_failure_degrades_to_text_only():
    _REFERENCE_SIDECAR["degraded"] = run_async(_degraded_text_only_scenario())


async def _partial_encode_scenario(sidecar_cls=RoutingSidecar):
    """One of two items fails at the E stage: the success still attaches and
    the PD server (with a tower) encodes only the missing one."""
    enc = _encoder()
    pd = _port_server()
    await _start(enc, pd)
    # one live worker and one dead: items alternate, the retry covers the dead
    sidecar = sidecar_cls(decode_addr=pd.address, encode_hosts=[enc.address, "127.0.0.1:9"],
                             encode_timeout_s=30.0)
    await sidecar.start()
    try:
        async with aiohttp.ClientSession() as sess:
            await _post(sess, f"http://{enc.address}/v1/encode",
                        {"items": [_data_uri(b"warmup")]})
            st, got = await _post(sess, f"http://{sidecar.address}/v1/chat/completions", {
                "messages": [{"role": "user", "content": [
                    _data_uri(b"img-A"), _data_uri(b"img-B")]}],
                "max_tokens": 3, "temperature": 0.0, "ignore_eos": True})
            assert st == 200
        # retry-on-next-worker: both items encode at the pool
        assert sidecar.stats["encoded_items"] == 2
        return {"choices": got["choices"], "usage": got["usage"],
                "stats": dict(sidecar.stats)}
    finally:
        await _stop(sidecar, pd, enc)


def test_partial_encode_failure_recovers():
    _REFERENCE_SIDECAR["partial"] = run_async(_partial_encode_scenario())


SIDECAR_SCENARIOS = {"epd": _epd_scenario, "pd_kv": _epd_with_kv_transfer_scenario,
                     "degraded": _degraded_text_only_scenario,
                     "partial": _partial_encode_scenario}


@pytest.mark.parametrize("scenario", list(SIDECAR_SCENARIOS))
def test_epd_scenarios_through_the_port_sidecar(scenario):
    """The E/PD, E/P/D, degrade and partial-failure scenarios with the port's
    ``RoutingSidecar`` in front of the same port engines and encode workers:
    each scenario's own checks hold, and the answers, usage and sidecar
    ``stats`` equal the reference sidecar's."""
    run = SIDECAR_SCENARIOS[scenario]
    want = _REFERENCE_SIDECAR.get(scenario) or run_async(run())
    assert run_async(run(PortSidecar)) == want


def test_render_matches_generate_tokenization():
    """``/render`` (what the router hashes) equals the stream the engine
    hashes at generation, placeholders included, and the reference server's
    rendering of the same body."""

    async def main():
        pd, ref = _port_server(), _jax_server()
        await _start(pd, ref)
        try:
            body = {"messages": [{"role": "user", "content": [
                {"type": "text", "text": "see"}, _data_uri(b"render-check")]}],
                "max_tokens": 2, "temperature": 0.0, "ignore_eos": True}
            async with aiohttp.ClientSession() as sess:
                _, r = await _post(sess, f"http://{pd.address}/v1/chat/completions/render",
                                   body)
                toks = r["prompt_token_ids"]
                assert toks.count(CFG.mm_placeholder_id) == CFG.mm_tokens
                _, r = await _post(sess, f"http://{ref.address}/v1/chat/completions/render",
                                   body)
                assert r["prompt_token_ids"] == toks
                _, r = await _post(sess, f"http://{pd.address}/v1/chat/completions", body)
                assert r["usage"]["prompt_tokens"] == len(toks)
        finally:
            await _stop(pd, ref)

    run_async(main())


# ------------------------------------------------------------- across packages


@pytest.mark.parametrize("case", ["whole_chunks", "chunk_inside_image", "preemption"])
def test_greedy_tokens_equal_jax_engine(case):
    """float32: the port engine and the JAX engine, given the same media
    rows, emit the same greedy tokens and commit the same block keys: two
    images in one prompt beside a text-only request; with ``prefill_chunk``
    3, chunk boundaries fall inside both images' spans; with a preemption
    once decode outgrows a pool of 9 pages, the media request (the newest
    arrival) is preempted and its media rows recomputed (prefix caching off,
    so nothing is reused)."""
    k, ph = CFG.mm_tokens, CFG.mm_placeholder_id
    media = list(range(10, 16)) + [ph] * k + list(range(30, 37)) + [ph] * k + [5, 6]
    items = _runner().encode([b"image-A", b"image-B"])
    over = {"chunk_inside_image": {"prefill_chunk": 3},
            "preemption": {"enable_prefix_caching": False, "num_pages": 9}}.get(case, {})
    outs, keys, preempted = [], [], []
    for eng in (_port_engine(**over), _jax_engine(**over)):
        sp = (JaxSamplingParams if isinstance(eng, JaxEngine) else SamplingParams)(
            max_tokens=16, temperature=0.0, ignore_eos=True)
        eng.add_request("text", list(range(50, 71)), sp)
        eng.add_request("media", media, sp, mm_items=items)
        out: dict = {"media": [], "text": []}
        while eng.has_work():
            for o in eng.step():
                out[o.request_id].extend(o.new_token_ids)
        outs.append(out)
        keys.append(sorted(eng.alloc.cached))
        preempted.append(eng.stats.total_preemptions)
    assert outs[0] == outs[1]
    assert keys[0] == keys[1] and preempted[0] == preempted[1]
    assert (preempted[0] > 0) == (case == "preemption")
    assert outs[0]["media"] != _generate(_port_engine(), "x", media, None, 16)


def test_block_and_event_keys_equal_router_keys():
    """A two-image chat through the port server: its BlockStored keys and the
    engine's committed blocks are the router's keys, ``block_keys_for_tokens``
    (the reference's) of the rendered tokens under
    ``mm_hashes_from_messages`` (the reference's); the events equal the JAX
    engine's for the same tokens and media."""
    messages = [{"role": "user", "content": [
        {"type": "text", "text": "compare these two pictures"}, _data_uri(b"left"),
        {"type": "text", "text": "and"}, _data_uri(b"right")]}]
    body = {"messages": messages, "max_tokens": 5, "temperature": 0.0, "ignore_eos": True}
    events: list = []
    _, tcfg, _, npp, vp = _weights()
    eng = LLMEngine(tcfg, EngineConfig(**KW), params=tt.params_from_numpy(tcfg, npp),
                    device="cpu", event_sink=events.extend)
    srv = EngineServer(tcfg, EngineConfig(**KW), host="127.0.0.1", port=0, engine=eng)
    srv._vision = _runner()
    srv.start()
    try:
        tokens = srv.render(body)[1]["prompt_token_ids"]
        status, got = srv.generate(body, chat=True)
        assert status == 200
    finally:
        srv.stop()
    mm = jr.mm_hashes_from_messages(messages)
    want = ref_block_keys(tokens, KW["page_size"], None, mm)
    stored = [h for e in events if isinstance(e, BlockStored) for h in e.block_hashes]
    assert len(want) >= 4 and stored[: len(want)] == want
    assert set(want) <= set(eng.alloc.cached)
    assert want != ref_block_keys(tokens, KW["page_size"])  # the media fold keys them
    # the JAX engine on the same tokens and rows stores the same events
    ref_events: list = []
    parts = [p for p in messages[0]["content"] if p["type"] == "image_url"]
    items = [(part_identity(p), e) for p, (_, e) in
             zip(parts, _runner().encode([media_bytes_from_part(p) for p in parts]))]
    out = _generate(_jax_engine(sink=ref_events.extend), "r", tokens, items, 5)
    assert got["usage"]["completion_tokens"] == len(out)

    def rows(evs):
        return [(e.block_hashes, e.parent_block_hash, e.token_ids, e.lora_id, e.medium)
                for e in evs if type(e).__name__ == "BlockStored"]

    assert rows(events) == rows(ref_events)


@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
def test_chat_with_wire_items_equals_reference_server(stream):
    """The same E/PD chat body (two images, the E stage's wire items) through
    the port server and the reference ``EngineServer``: the same text and
    usage; a body whose media cannot be read is a 400 ``multimodal content``
    on both."""
    parts = [_data_uri(b"wire-1"), _data_uri(b"wire-2")]
    body = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "two"}, *parts]}], "mm_items": _wire(parts),
        "max_tokens": 6, "temperature": 0.0, "ignore_eos": True, "stream": stream}

    async def one(server):
        await _start(server)
        try:
            async with aiohttp.ClientSession() as sess:
                url = f"http://{server.address}/v1/chat/completions"
                async with sess.post(url, json=body) as r:
                    if stream:
                        lines = [ln for ln in (await r.text()).splitlines()
                                 if ln.startswith("data: {")]
                        events = [json.loads(ln[6:]) for ln in lines]
                        text = "".join(e["choices"][0]["delta"]["content"] for e in events)
                        usage = events[-1]["usage"]
                    else:
                        got = await r.json()
                        text, usage = got["choices"][0]["message"]["content"], got["usage"]
                st, bad = await _post(sess, url, {"messages": ["not a message"],
                                                  "mm_items": [{}], "max_tokens": 2})
            return text, usage, st, bad["error"]["message"].startswith("multimodal content")
        finally:
            await _stop(server)

    ours = run_async(one(_port_server()))
    assert ours == run_async(one(_jax_server()))
    assert ours[2] == 400 and ours[3]


@functools.cache
def _cross(p_make, d_make):
    """A media chat prefilled on P (``do_remote_decode``) and decoded on D
    (``do_remote_prefill``) at tiny-vl with head_dim 128, the rows riding the
    body as wire items: (text, cached tokens, D's injected blocks, pulls failed)."""
    parts = [_data_uri(b"pd-photo")]
    body = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "look at this closely " * 3}, *parts]}],
        "mm_items": _wire(parts), "max_tokens": 6, "temperature": 0.0, "ignore_eos": True}

    async def scenario():
        prefill, decode = p_make(head_dim=128, kv_transfer_port=0), \
            d_make(head_dim=128, kv_transfer_port=0)
        await _start(prefill, decode)
        try:
            async with aiohttp.ClientSession() as sess:
                _, r = await _post(sess, f"http://{prefill.address}/v1/chat/completions", {
                    **body, "max_tokens": 1, "kv_transfer_params": {"do_remote_decode": True}})
                ktp = r["kv_transfer_params"]
                _, r = await _post(sess, f"http://{decode.address}/v1/chat/completions", {
                    **body, "kv_transfer_params": {"do_remote_prefill": True, **ktp}})
                return (r["choices"][0]["message"]["content"], r["usage"]["cached_tokens"],
                        decode.transfer_stats["injected_blocks"],
                        decode.transfer_stats["pull_failures"])
        finally:
            await _stop(prefill, decode)

    return run_async(scenario())


@pytest.mark.parametrize("pair", ["jax_to_port", "port_to_jax"])
def test_cross_package_pd_under_media_head_dim_128(pair):
    """A JAX prefill server to a port decode server and back, under media:
    the media-keyed blocks verify on the other side and are injected; the
    text equals the JAX pair's."""
    got = _cross(*((_jax_server, _port_server) if pair == "jax_to_port"
                   else (_port_server, _jax_server)))
    assert got == _cross(_jax_server, _jax_server)
    assert got[1] > 0 and got[2] > 0 and got[3] == 0


def test_serve_and_encode_clis_on_cpu():
    """``python -m llmd_tpu_torch.disagg.encode --cpu`` and ``python -m
    llmd_tpu_torch.engine.serve --model tiny-vl --cpu``: the worker answers
    ``/health`` and encodes; the server serves a media chat with the worker's
    wire items and, the same request without them, with its own tower."""
    import subprocess
    import sys
    import urllib.request
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    common = ["--model", "tiny-vl", "--cpu", "--host", "127.0.0.1", "--port", "0"]
    procs = [subprocess.Popen([sys.executable, "-m", mod, *common, *extra], cwd=repo,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for mod, extra in (("llmd_tpu_torch.disagg.encode", []),
                                ("llmd_tpu_torch.engine.serve", ["--num-pages", "32"]))]

    def call(url, body=None):
        req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        lines = [p.stdout.readline() for p in procs]
        assert "encode worker (tiny-vl)" in lines[0] and "(device cpu)" in lines[0], lines
        assert "vision tower in-process" in lines[1], lines
        enc, srv = (ln.split("http://")[1].split()[0] for ln in lines)
        assert call(f"http://{enc}/health") == {"status": "ok", "role": "encode"}
        part = _data_uri(b"cli-photo")
        items = call(f"http://{enc}/v1/encode", {"items": [part]})["items"]
        content = [{"type": "text", "text": "hi " * 12}, part]
        body = {"messages": [{"role": "user", "content": content}], "max_tokens": 4,
                "temperature": 0.0, "ignore_eos": True}
        e_pd = call(f"http://{srv}/v1/chat/completions", {**body, "mm_items": items})
        combined = call(f"http://{srv}/v1/chat/completions", body)
        # both processes draw the same seeded tower: the rows agree
        assert e_pd["choices"] == combined["choices"]
        assert combined["usage"]["cached_tokens"] > 0  # the same media keys the same blocks
    finally:
        for p in procs:
            p.terminate()
            p.wait(timeout=30)


def test_profile_unified_packs_media_rows():
    """``profile_engine.profile_unified`` on the CPU: one unified step a
    window, carrying ``batch x images x mm_tokens`` media rows, beside the
    same batch of text prompts (no device kernels to count here)."""
    from llmd_tpu_torch.tools.profile_engine import profile_unified

    _, tcfg, _, npp, _ = _weights()
    params = tt.params_from_numpy(tcfg, npp)
    rows = {images: profile_unified(tcfg, params, 2, 24, images, 0, device="cpu")
            for images in (2, 0)}
    assert rows[2]["media_rows_per_step"] == 2 * 2 * tcfg.mm_tokens
    assert rows[0]["media_rows_per_step"] == 0
    assert rows[2]["unified_steps"] == rows[0]["unified_steps"] == 1
    assert rows[2]["prompt_tokens"] == rows[0]["prompt_tokens"] == 24
