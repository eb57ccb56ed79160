"""Multi-adapter LoRA in the port (``models/lora.py``, the engine's adapter
bank and lifecycle, the server's routes) against the JAX package, on the
CPU at ``tiny`` in float32, mirroring ``tests/test_lora.py``.

Both sides load the same numpy adapter weights (a port engine's default test
double is drawn from a ``torch.Generator`` and differs from the JAX
engine's). Tolerances: logits max abs <= 1e-4 with the same argmax; greedy
tokens identical; the null adapter bitwise the base model.

- the registry (its lifecycle against the reference's under hypothesis);
  ``apply_lora``'s dense products against the per-token gather and the
  reference's ``apply_lora``; the bank layout bridge;
- ``forward_core`` with mixed slots against the JAX forward; the null slot
  bitwise the base model's;
- engine lifecycle, busy unload, preemption counters, prefix-cache
  isolation (the reference's cases), the bank written in place;
- port engine = JAX engine under two adapters plus base rows through the
  pipelined decode program, in float32 and with int8 base weights: tokens,
  registry counts, BlockStored ``lora_id`` and block hashes; the ``verify``
  and masked programs (speculation on = off = the JAX engine);
- the adapter digest of a bfloat16 tensor equals the reference's of the
  same ``ml_dtypes`` array; an npz the card cannot read without
  ``ml_dtypes`` is refused;
- the server's LoRA API and ``/metrics`` against the reference
  ``EngineServer``; a JAX<->port P/D pull under an adapter at head_dim 128.
"""

import dataclasses
import functools
import json

import aiohttp
import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.server import EngineServer as JaxEngineServer
from llmd_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import lora as jl
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.engine.tokenizer import ByteTokenizer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import lora as tl
from llmd_tpu_torch.models import transformer as tt
from tests.conftest import run_async

LCFG = dict(max_adapters=2, rank=4)
BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4, prefill_chunk=32,
            decode_steps=4)
GREEDY = dict(max_tokens=12, temperature=0.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _weights(head_dim: "int | None" = None):
    over = {"dtype": "float32"} | ({"head_dim": head_dim} if head_dim else {})
    jcfg = dataclasses.replace(jax_model_config("tiny"), **over)
    tcfg = dataclasses.replace(get_model_config("tiny"), **over)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


@functools.cache
def _adapter(seed: int, head_dim: "int | None" = None) -> dict:
    """One adapter's weights as float32 numpy arrays (the reference's draw)."""
    jcfg = _weights(head_dim)[0]
    w = jl.make_adapter_weights(jcfg, jl.LoRAConfig(**LCFG), jax.random.PRNGKey(seed))
    return {k: np.asarray(v, np.float32) for k, v in w.items()}


def _port(lora=True, head_dim=None, sink=None, **over) -> LLMEngine:
    _, tcfg, _, npp = _weights(head_dim)
    return LLMEngine(tcfg, EngineConfig(**{**BASE, **over},
                                        lora=tl.LoRAConfig(**LCFG) if lora else None),
                     params=tt.params_from_numpy(tcfg, npp), device="cpu", event_sink=sink,
                     tokenizer=ByteTokenizer())


def _jax(lora=True, sink=None, **over) -> JaxEngine:
    jcfg, _, jp, _ = _weights()
    return JaxEngine(jcfg, JaxEngineConfig(**{**BASE, **over}, attn_impl="reference",
                                           lora=jl.LoRAConfig(**LCFG) if lora else None),
                     params=jp, event_sink=sink, tokenizer=JaxByteTokenizer())


def _drain(eng, requests, audit=None) -> dict[str, list[int]]:
    """``requests``: (rid, prompt, lora_id, sampling kwargs); greedy tokens."""
    jax_side = isinstance(eng, JaxEngine)
    for rid, prompt, lora, kw in requests:
        sp = (JaxSamplingParams if jax_side else SamplingParams)(**{**GREEDY, **kw})
        eng.add_request(rid, prompt, sp, lora_id=lora)
    out: dict[str, list[int]] = {r[0]: [] for r in requests}
    steps = 0
    while eng.has_work():
        for o in eng.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
        if audit is not None:
            audit.append((dict(eng.lora_registry.running), dict(eng.lora_registry.waiting)))
        steps += 1
        assert steps < 2000, "no forward progress"
    return out


def _echo(salt: int, n: int = 40, period: int = 3) -> list[int]:
    return [(salt * 7919 + j % period) % 200 + 3 for j in range(n)]


# ------------------------------------------------------------------- registry


def test_registry_slots_and_eviction():
    reg = tl.LoRARegistry(max_adapters=2)
    s1, s2 = reg.assign("a"), reg.assign("b")
    assert {s1, s2} == {1, 2} and reg.assign("a") == s1
    evicted = []
    reg.on_evict = evicted.append
    s3 = reg.assign("c")  # full, both idle: one is displaced
    assert s3 in (1, 2) and len(evicted) == 1 and not reg.has(evicted[0])
    reg.on_waiting("c")
    reg.on_running("c")
    survivor = next(n for n in reg.slots if n != "c")
    reg.on_waiting(survivor)
    reg.on_running(survivor)
    with pytest.raises(RuntimeError):
        reg.assign("d")  # busy adapters are never evicted
    info = reg.metrics_info()
    assert info["max_lora"] == 2 and "c" in info["running_lora_adapters"]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["assign", "remove", "wait", "run", "finish"]),
                          st.sampled_from(["a", "b", "c", "d"])), max_size=40))
def test_registry_matches_reference(ops):
    """Any sequence of lifecycle calls: the same slots, counts, evictions,
    refusals and metrics fields as the reference's registry."""
    ours, ref = tl.LoRARegistry(3), jl.LoRARegistry(3)
    ev_ours, ev_ref = [], []
    ours.on_evict, ref.on_evict = ev_ours.append, ev_ref.append
    call = {"assign": "assign", "remove": "remove", "wait": "on_waiting", "run": "on_running",
            "finish": "on_finished"}
    for op, name in ops:
        got = []
        for reg in (ours, ref):
            try:
                got.append(getattr(reg, call[op])(name))
            except RuntimeError as e:
                got.append(("raised", str(e)))
        assert got[0] == got[1]
        assert (ours.slots, ours.running, ours.waiting) == (ref.slots, ref.running, ref.waiting)
    assert ev_ours == ev_ref and ours.metrics_info() == ref.metrics_info()


# ----------------------------------------------------------------- model math


def test_apply_lora_dense_equals_gather_and_reference():
    """The dense shrink/expand over the whole bank = the per-token gather
    (the plain version) = the reference's ``apply_lora``, float32, mixed
    slots; slot-0 rows are exactly zero."""
    rng = np.random.default_rng(0)
    N, Din, Dout, S, r = 37, 48, 40, 5, 4
    h = rng.standard_normal((N, Din)).astype(np.float32)
    A = (rng.standard_normal((S, Din, r)) * Din ** -0.5).astype(np.float32)  # adapter scales
    B = (rng.standard_normal((S, r, Dout)) * 0.1).astype(np.float32)
    B[0] = 0.0  # the null adapter
    idx = rng.integers(0, S, N).astype(np.int32)
    idx[:5] = 0
    th, tA, tB, ti = (torch.from_numpy(a) for a in (h, A, B, idx))
    dense = tl.apply_lora(th, tA.permute(1, 0, 2).contiguous(), tB,
                          tl.slot_mask(ti, S, torch.float32), 2.0)
    gather = tl.apply_lora_ref(th, tA, tB, ti, 2.0)
    ref = np.asarray(jl.apply_lora(h, A, B, idx, 2.0))
    np.testing.assert_allclose(dense.numpy(), gather.numpy(), atol=1e-5)
    np.testing.assert_allclose(dense.numpy(), ref, atol=1e-5)
    assert torch.equal(dense[idx == 0], torch.zeros((int((idx == 0).sum()), Dout)))


def test_bank_layout_bridge():
    """``params_from_numpy`` takes the reference's bank and lays A out as
    [L, Din, S, r]; B keeps [L, S, r, Dout]; every slot's weights survive."""
    jcfg, tcfg, _, npp = _weights()
    bank = {k: np.asarray(v) for k, v in jl.init_lora_params(jcfg, jl.LoRAConfig(**LCFG)).items()}
    for k in bank:
        bank[k] = np.random.default_rng(len(k)).standard_normal(bank[k].shape).astype(np.float32)
    p = tt.params_from_numpy(tcfg, {**npp, **bank})
    for k, v in bank.items():
        got = p[k].numpy()
        want = v.transpose(0, 2, 1, 3) if k.startswith("lora_A_") else v
        np.testing.assert_array_equal(got, want)
    assert set(tl.init_lora_params(tcfg, tl.LoRAConfig(**LCFG))) == set(bank)
    for k, v in tl.init_lora_params(tcfg, tl.LoRAConfig(**LCFG)).items():
        assert v.shape == p[k].shape


def _bank(adapters: list[dict]) -> dict:
    """The reference's bank with ``adapters`` in slots 1.. (numpy)."""
    jcfg = _weights()[0]
    bank = {k: np.array(v) for k, v in jl.init_lora_params(jcfg, jl.LoRAConfig(**LCFG)).items()}
    for s, w in enumerate(adapters, start=1):
        for k, v in w.items():
            bank[k][:, s] = v
    return bank


def _forward_pair(lora_rows, bank):
    """Port and JAX ``forward`` logits of two rows of the same tokens at the
    adapter slots ``lora_rows``."""
    jcfg, tcfg, jp, npp = _weights()
    B, T = 3, 11
    toks = np.tile(np.arange(1, T + 1, dtype=np.int32)[None], (B, 1))
    pos = np.tile(np.arange(T, dtype=np.int32)[None], (B, 1))
    pt = np.arange(B * 2, dtype=np.int32).reshape(B, 2)
    lens = np.full((B,), T, np.int32)
    idx = np.asarray(lora_rows, np.int32)
    full = {**jp, **bank} if bank is not None else jp
    j = jax.numpy.asarray
    lj, _, _ = jt.forward(jcfg, full, jt.init_cache(jcfg, 8, 8), j(toks), j(pos), j(pt), j(lens),
                          lora_indices=j(idx) if bank is not None else None,
                          lora_scale=jl.LoRAConfig(**LCFG).scale)
    t = torch.from_numpy
    tp = tt.params_from_numpy(tcfg, {**npp, **bank} if bank is not None else npp)
    lt, _ = tt.forward(tcfg, tp, tt.init_cache(tcfg, 8, 8), t(toks), t(pos), t(pt), t(lens),
                       lora_indices=t(idx) if bank is not None else None,
                       lora_scale=tl.LoRAConfig(**LCFG).scale)
    return np.asarray(lj), lt.numpy()


def test_forward_core_mixed_slots_matches_reference():
    """Rows at slots 0, 1 and 2 over the same tokens: the port's logits =
    the JAX forward's (<= 1e-4, same argmax); the adapters visibly change
    their rows."""
    lj, lt = _forward_pair([0, 1, 2], _bank([_adapter(1), _adapter(2)]))
    assert np.abs(lj - lt).max() <= 1e-4
    assert (lj.argmax(-1) == lt.argmax(-1)).all()
    assert np.abs(lt[0] - lt[1]).max() > 1e-2 and np.abs(lt[1] - lt[2]).max() > 1e-2


def test_null_adapter_is_bitwise_base():
    """Slot-0 rows under a bank that holds adapters in the other slots are
    bitwise the model without a bank (exact zeros added)."""
    _, tcfg, _, npp = _weights()
    bank = _bank([_adapter(1), _adapter(2)])
    _, with_bank = _forward_pair([0, 0, 1], bank)
    _, base = _forward_pair([0, 0, 0], None)
    assert np.array_equal(with_bank[:2], base[:2])
    assert not np.array_equal(with_bank[2], base[2])


# -------------------------------------------------------------------- engine


def test_engine_lifecycle_and_divergence():
    eng = _port()
    eng.load_lora_adapter("sql-adapter", _adapter(1))
    prompt = list(range(3, 30))
    done = _drain(eng, [("base", prompt, None, {"max_tokens": 6}),
                        ("tuned", prompt, "sql-adapter", {"max_tokens": 6})])
    assert len(done["base"]) == len(done["tuned"]) == 6
    assert done["base"] != done["tuned"]
    assert eng.unload_lora_adapter("sql-adapter")
    assert not eng.unload_lora_adapter("sql-adapter")
    with pytest.raises(ValueError, match="unknown LoRA adapter"):
        eng.add_request("after", prompt, SamplingParams(**GREEDY), lora_id="sql-adapter")


def test_engine_unload_busy_adapter_refused():
    eng = _port()
    eng.load_lora_adapter("busy", _adapter(1))
    eng.add_request("r", list(range(3, 30)), SamplingParams(max_tokens=4), lora_id="busy")
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.unload_lora_adapter("busy")
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.load_lora_adapter("busy", _adapter(2))  # no swap under live rows
    while eng.has_work():
        eng.step()
    assert eng.unload_lora_adapter("busy")


def test_engine_preemption_keeps_lora_counters_true():
    """The reference's case, and every step's running / waiting counts equal
    the JAX engine's through an abort, a preemption and retirement."""
    audits = []
    for eng in (_port(), _jax()):
        eng.load_lora_adapter("x", _adapter(1))
        reg = eng.lora_registry
        sp = (JaxSamplingParams if isinstance(eng, JaxEngine) else SamplingParams)(max_tokens=2)
        eng.add_request("r", list(range(3, 20)), sp, lora_id="x")
        eng.add_request("gone", list(range(3, 9)), sp, lora_id="x")
        eng.abort("gone")  # aborted while queued: the waiting count rewinds
        eng.step()
        assert reg.running.get("x") == 1 and reg.waiting.get("x", 0) == 0
        assert eng._preempt_one()
        assert reg.running.get("x", 0) == 0 and reg.waiting.get("x") == 1
        audit = []
        _drain(eng, [("s", list(range(5, 25)), "x", {"max_tokens": 3})], audit)
        assert reg.running.get("x", 0) == 0 and reg.waiting.get("x", 0) == 0
        audits.append(audit)
    assert audits[0] == audits[1]


def test_engine_lora_prefix_cache_isolated():
    """Same prompt, another adapter: other block keys, no reuse."""
    eng = _port()
    eng.load_lora_adapter("a1", _adapter(1))
    prompt = list(range(3, 40))
    cached: dict[str, int] = {}
    for rid, lora in (("r1", None), ("r2", None), ("r3", "a1"), ("r4", "a1")):
        eng.add_request(rid, prompt, SamplingParams(max_tokens=2, temperature=0.0),
                        lora_id=lora)
        while eng.has_work():
            for out in eng.step():
                cached[out.request_id] = out.num_cached_prompt_tokens
    assert cached["r2"] > 0 and cached["r3"] == 0 and cached["r4"] > 0
    # unloading purges the adapter's blocks; a reload never matches the old KV
    n_cached = len(eng.alloc.cached)
    assert eng.unload_lora_adapter("a1")
    assert len(eng.alloc.cached) < n_cached
    eng.load_lora_adapter("a1", _adapter(1))
    eng.add_request("r5", prompt, SamplingParams(max_tokens=2, temperature=0.0), lora_id="a1")
    outs = [o for _ in range(50) if eng.has_work() for o in eng.step()]
    assert outs[-1].num_cached_prompt_tokens == 0


def test_bank_written_in_place_and_mla_refused():
    """Load and unload write the bank's slot in place (the captured decode
    graph holds its address); LoRA on MLA is refused, as the reference's."""
    eng = _port()
    ptrs = {k: v.data_ptr() for k, v in eng._lora_params.items()}
    eng.generate([list(range(3, 20))], SamplingParams(**GREEDY))
    slot = eng.load_lora_adapter("a", _adapter(1))
    A = eng._lora_params["lora_A_wq"]
    np.testing.assert_array_equal(A[:, :, slot].numpy(), _adapter(1)["lora_A_wq"])
    assert not A[:, :, [s for s in range(A.shape[2]) if s != slot]].any()
    eng.unload_lora_adapter("a")
    assert not any(v.any() for v in eng._lora_params.values())
    assert {k: v.data_ptr() for k, v in eng._lora_params.items()} == ptrs
    mla = dataclasses.replace(get_model_config("tiny-mla"), dtype="float32")
    with pytest.raises(ValueError, match="MLA"):
        LLMEngine(mla, EngineConfig(**BASE, lora=tl.LoRAConfig(**LCFG)), device="cpu")


REQUESTS = [("base0", list(range(3, 40)), None, {}), ("a0", list(range(3, 40)), "a", {}),
            ("b0", list(range(5, 33)), "b", {"max_tokens": 17}),
            ("base1", list(range(9, 60)), None, {"max_tokens": 9}),
            ("b1", list(range(3, 40)), "b", {}), ("a1", list(range(20, 50)), "a", {})]


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_engine_matches_reference(quant):
    """Two adapters plus base rows through the unified program and the
    pipelined decode program (``decode_steps`` 4, depth 2): the port's
    greedy tokens, per-step registry counts and BlockStored events (block
    hashes, parents and ``lora_id``, the generation-scoped keys) equal the
    JAX engine's; then a second round hits the prefix cache per adapter."""
    runs = []
    for make in (_port, _jax):
        events: list = []
        eng = make(sink=events.extend, quantize_weights=quant)
        for name, seed in (("a", 1), ("b", 2)):
            eng.load_lora_adapter(name, _adapter(seed))
        audit: list = []
        toks = _drain(eng, REQUESTS, audit)
        toks2 = _drain(eng, [("hit", list(range(3, 40)) + [7], "a", {})], audit)
        stored = [(ev.block_hashes, ev.parent_block_hash, ev.lora_id) for ev in events
                  if type(ev).__name__ == "BlockStored"]
        runs.append((toks, toks2, audit, stored))
        if make is _port:
            assert eng.stats.n_chained_dispatches > 0  # the pipelined decode program ran
    assert runs[0] == runs[1]
    toks, _, _, stored = runs[0]
    assert toks["base0"] != toks["a0"] != toks["b1"]
    assert {k for _, _, k in stored} >= {None, f"a@{tl.adapter_digest(_adapter(1))}",
                                         f"b@{tl.adapter_digest(_adapter(2))}"}


@pytest.mark.parametrize("spec", [False, True], ids=["masked", "verify_masked"])
def test_verify_and_masked_programs_under_adapters(spec):
    """The reference's spec-decode LoRA case (``test_spec_decode.py:143``)
    and the masked programs: echo prompts with and without an adapter, and
    grammar-constrained rows under adapters, through ``decode_masked`` (and
    with speculation ``verify`` / ``verify_masked``): port = JAX engine;
    speculation on = off."""
    eos = (ByteTokenizer().eos_id,)
    choice = {"guided_choice": ["red", "green", "blue"], "stop_token_ids": eos}
    # a forced, repetitive pattern: the constrained row drafts from its own output
    regex = {"guided_regex": r"(abc){6}", "stop_token_ids": eos, "max_tokens": 24}
    rounds = [[("base", _echo(3), None, {"max_tokens": 16}),
               ("tuned", _echo(3), "a", {"max_tokens": 16})],
              [("echo", [7, 8, 9] * 8, "b", {"max_tokens": 24}),
               ("choice", list(range(40, 52)), "a", choice),
               ("regex", list(range(60, 72)), "b", regex)]]
    kw = dict(spec_mode="ngram", spec_tokens=4) if spec else {}
    outs = []
    for eng in (_port(**kw), _jax(**kw), _port()):
        for name, seed in (("a", 1), ("b", 2)):
            eng.load_lora_adapter(name, _adapter(seed))
        outs.append([_drain(eng, reqs) for reqs in rounds])
        if isinstance(eng, JaxEngine):
            continue
        counts = eng.programs.counters()
        progs = ("verify", "verify_masked") if eng.cfg.spec_mode == "ngram" else (
            "decode", "decode_masked")
        assert all(counts[p][0] > 0 for p in progs), counts
    assert outs[0] == outs[1] == outs[2]
    assert outs[0][0]["base"] != outs[0][0]["tuned"]


def test_digest_of_bf16_tensor_equals_reference_bytes():
    """A bf16 tensor hashes as its 16-bit view: the bytes of the same values
    as an ``ml_dtypes`` bfloat16 array, which is what the reference hashes."""
    w = _adapter(1)
    tensors = {k: torch.tensor(v).to(torch.bfloat16) for k, v in w.items()}
    arrays = {k: t.float().numpy().astype(ml_dtypes.bfloat16) for k, t in tensors.items()}
    assert tl.adapter_digest(tensors) == tl.adapter_digest(arrays)
    assert tl.adapter_digest(w) != tl.adapter_digest(arrays)


def test_void_typed_adapter_refused(tmp_path):
    """An npz whose arrays read as void (bfloat16 saved by ``ml_dtypes``)
    is refused, not reinterpreted; nothing is installed."""
    w = {k: v.astype(ml_dtypes.bfloat16) for k, v in _adapter(1).items()}
    path = tmp_path / "bf16.npz"
    np.savez(path, **w)
    with np.load(path) as z:
        loaded = {k: z[k] for k in z.files}
    assert loaded["lora_A_wq"].dtype.kind == "V"
    eng = _port()
    with pytest.raises(ValueError, match="void"):
        eng.load_lora_adapter("v", loaded)
    assert not eng.lora_registry.has("v")
    with pytest.raises(ValueError, match="shape"):
        eng.load_lora_adapter("s", {"lora_A_wq": np.zeros((2, 3, 4), np.float32)})
    with pytest.raises(KeyError):
        eng.load_lora_adapter("k", {"lora_A_wz": np.zeros((2, 3, 4), np.float32)})


# -------------------------------------------------------------------- server


async def _req(sess, method, url, body=None):
    async with sess.request(method, url, json=body) as r:
        raw = await r.read()
        try:
            return r.status, json.loads(raw)
        except ValueError:
            return r.status, raw.decode()


async def _lora_script(base: str, npz: str) -> list:
    """One script of LoRA calls; what is comparable of each answer."""
    out = []
    async with aiohttp.ClientSession() as s:
        async def call(method, path, body=None, keep=lambda b: b):
            status, body_ = await _req(s, method, base + path, body)
            out.append((path, status, keep(body_)))
            return body_

        text = lambda b: b["choices"][0]["text"] if "choices" in b else b  # noqa: E731
        await call("POST", "/v1/load_lora_adapter", {"lora_name": "my-adapter",
                                                     "lora_path": npz})
        await call("POST", "/v1/load_lora_adapter", {"lora_name": "bad name\""},
                   keep=lambda b: None)
        await call("POST", "/v1/load_lora_adapter", {}, keep=lambda b: None)
        await call("POST", "/v1/load_lora_adapter", {"lora_name": "x", "lora_path": "/no/file"},
                   keep=lambda b: None)
        await call("GET", "/v1/models")
        gen = {"prompt": "hello there", "max_tokens": 4, "temperature": 0.0}
        await call("POST", "/v1/completions", {**gen, "model": "my-adapter"}, keep=text)
        await call("POST", "/v1/completions", {**gen, "lora_adapter": "my-adapter"}, keep=text)
        await call("POST", "/v1/completions", gen, keep=text)
        await call("POST", "/v1/chat/completions",
                   {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
                    "temperature": 0.0, "model": "my-adapter"},
                   keep=lambda b: b["choices"][0]["message"]["content"])
        await call("POST", "/v1/completions", {**gen, "lora_adapter": "nope"})
        metrics = await call("GET", "/metrics", keep=lambda b: None)
        out.append(("lora_info", [ln for ln in metrics.splitlines()
                                  if ln.startswith("vllm:lora_requests_info")]))
        await call("POST", "/v1/unload_lora_adapter", {"lora_name": "my-adapter"})
        await call("POST", "/v1/unload_lora_adapter", {"lora_name": "my-adapter"})
        await call("POST", "/v1/completions", {**gen, "model": "my-adapter"}, keep=text)
        await call("GET", "/v1/models")
    return out


def test_server_lora_api_matches_reference(tmp_path):
    """The port server's load / unload routes and codes, ``/v1/models``,
    adapter resolution (``model`` and ``lora_adapter``), the 404s and the
    ``vllm:lora_requests_info`` line equal the reference server's on one
    script, adapter weights loaded from the same npz."""
    jcfg, tcfg, jp, npp = _weights()
    npz = str(tmp_path / "adapter.npz")
    np.savez(npz, **_adapter(1))
    kw = dict(page_size=8, num_pages=32, max_model_len=64, max_batch_size=2, prefill_chunk=16)

    async def scenario():
        ref = JaxEngineServer(jcfg, JaxEngineConfig(**kw, attn_impl="reference",
                                                    lora=jl.LoRAConfig(**LCFG)),
                              model_name="m", host="127.0.0.1", port=0, params=jp)
        ours = EngineServer(tcfg, EngineConfig(**kw, lora=tl.LoRAConfig(**LCFG)),
                            model_name="m", host="127.0.0.1", port=0,
                            params=tt.params_from_numpy(tcfg, npp), device="cpu")
        await ref.start()
        ours.start()
        try:
            want = await _lora_script(f"http://{ref.address}", npz)
            got = await _lora_script(f"http://{ours.address}", npz)
        finally:
            await ref.stop()
            ours.stop()
        return want, got

    want, got = run_async(scenario())
    assert got == want
    codes = [c for _, c, _ in got[:4]]
    assert codes == [200, 400, 400, 400]
    assert got[5][2] != got[7][2]  # the adapter visibly applied
    assert got[11][0] == "lora_info" and 'max_lora="2"' in got[11][1][0]
    assert got[14][2] == got[7][2]  # unloaded: the name is the base model's again


def test_server_lora_off_answers_404_and_400():
    _, tcfg, _, npp = _weights()
    srv = EngineServer(tcfg, EngineConfig(**BASE), model_name="m", host="127.0.0.1", port=0,
                       params=tt.params_from_numpy(tcfg, npp), device="cpu")
    assert srv.resolve_lora({"lora_adapter": "a"})[1][0] == 404
    assert srv.load_lora({"lora_name": "a"})[0] == 400
    assert srv.unload_lora({"lora_name": "a"})[0] == 400
    assert srv.models()[1]["data"] == [{"id": "m", "object": "model"}]
    assert srv.embeddings({"input": [[1, 10 ** 6]]})[0] == 400  # past the vocabulary
    assert srv.embeddings({"input": [1, 2, 3], "model": "a"})[0] == 200  # "a" is no adapter


PD_PROMPT = "the quick brown fox jumps over the lazy dog and keeps on running far"


@pytest.mark.parametrize("pair", ["jax_to_port", "port_to_jax"])
def test_cross_package_pd_under_adapter(pair, tmp_path):
    """P/D across packages at head_dim 128 with the request under an
    adapter loaded from one npz on both servers: the decode server pulls
    every reusable block (keys agree across packages, the adapter's digest
    included) and answers the adapter's text, which differs from the base
    model's."""
    jcfg, tcfg, jp, npp = _weights(128)
    npz = str(tmp_path / "adapter.npz")
    np.savez(npz, **_adapter(1, 128))
    kw = dict(BASE)

    def jax_server():
        return JaxEngineServer(jcfg, JaxEngineConfig(**kw, attn_impl="reference",
                                                     lora=jl.LoRAConfig(**LCFG)),
                               model_name="m", host="127.0.0.1", port=0, params=jp,
                               kv_transfer_port=0)

    def port_server():
        return EngineServer(tcfg, EngineConfig(**kw, lora=tl.LoRAConfig(**LCFG)),
                            model_name="m", host="127.0.0.1", port=0,
                            params=tt.params_from_numpy(tcfg, npp), device="cpu",
                            kv_transfer_port=0)

    async def scenario():
        p, d = (jax_server(), port_server()) if pair == "jax_to_port" else (
            port_server(), jax_server())
        for srv in (p, d):
            await srv.start() if isinstance(srv, JaxEngineServer) else srv.start()
        try:
            async with aiohttp.ClientSession() as s:
                for srv in (p, d):
                    status, _ = await _req(s, "POST", f"http://{srv.address}/v1/load_lora_adapter",
                                           {"lora_name": "ad", "lora_path": npz})
                    assert status == 200
                body = {"prompt": PD_PROMPT, "max_tokens": 8, "temperature": 0.0,
                        "ignore_eos": True, "model": "ad"}
                _, r = await _req(s, "POST", f"http://{p.address}/v1/completions", {
                    **body, "max_tokens": 1, "kv_transfer_params": {"do_remote_decode": True}})
                ktp = r["kv_transfer_params"]
                _, r = await _req(s, "POST", f"http://{d.address}/v1/completions", {
                    **body, "kv_transfer_params": {"do_remote_prefill": True, **ktp}})
                _, base = await _req(s, "POST", f"http://{d.address}/v1/completions",
                                     {**body, "model": "m"})
                return (r["choices"][0]["text"], r["usage"]["cached_tokens"],
                        d.transfer_stats["injected_blocks"], base["choices"][0]["text"])
        finally:
            for srv in (p, d):
                await srv.stop() if isinstance(srv, JaxEngineServer) else srv.stop()

    text, cached, injected, base_text = run_async(scenario())
    n_reusable = (len(PD_PROMPT.encode()) - 1) // 8
    assert cached == n_reusable * 8 and injected == 8
    assert text != base_text
