"""Structured outputs in the port (``llmd_tpu_torch/structured``, the engine's
admission and biased sampling, the server's 400s) against the JAX package.

- Each copied module against its original under hypothesis: regex DFAs,
  ``regex_for_schema``, ``validate_instance``, ``dense_tables``,
  ``legal_prefix_len``, ``parse_logit_bias``, ``validate_structured_body``
  (same accept / reject, same exception class) and the grammar cache's hits
  and evictions.
- The reference's corpus (``tests/test_structured.py``: choice, regex and a
  bounded JSON schema, greedy and sampled, and with preemption) through the
  port engine: 100% of generations conform, no violation; the greedy ones are
  the JAX engine's tokens on the same float32 weights.
- ``structured_mode="off"``: unconstrained tokens bitwise unchanged, nothing
  masked built or captured, structured requests refused.
- The HTTP round trip against the reference's ``EngineServer``: the same
  status codes and greedy texts for constrained completions and chat,
  streamed and not, malformed bodies (400), and the sampling fields the
  reference accepts and does not act on (``min_p``, ``logprobs``, the
  penalties, ``n``): the same status, the same greedy text, one choice.
"""

import dataclasses
import functools
import json
import re

import aiohttp
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import llmd_tpu.structured as ref_s
from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.server import EngineServer as JaxEngineServer
from llmd_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
import llmd_tpu_torch.structured as port_s
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.engine.tokenizer import ByteTokenizer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from tests.conftest import run_async

TOK = ByteTokenizer()
EOS = TOK.eos_id
SCHEMA = {
    "type": "object",
    "properties": {"name": {"type": "string", "maxLength": 8},
                   "count": {"enum": [0, 1, 2, 3]}, "ok": {"type": "boolean"}},
    "required": ["name", "count", "ok"],
}
CHOICES = ["red", "green", "blue"]
REGEX = r"[a-c]{3}-[0-9]{2}"
CORPUS = [("choice", dict(guided_choice=CHOICES)), ("regex", dict(guided_regex=REGEX)),
          ("schema", dict(response_format={"type": "json_schema",
                                           "json_schema": {"schema": SCHEMA}}))]
PATTERNS = [r"ab|cd", r"a[0-9]{2}z?", r"(foo)+(bar)*", r"[^x]", r"\d+\.\d+", REGEX,
            r"[ab]{24}", r"(?:x|yz){1,3}w*", r"\w+@\w+\.(com|org)",
            ref_s.escape_literal("a.b{2}"), ref_s.json_object_regex()]
BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4, prefill_chunk=32)


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of small ops: one intra-op thread keeps them from contending
    with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(fn, *args):
    """(result, None) or (None, exception class name)."""
    try:
        return fn(*args), None
    except ValueError as e:
        return None, type(e).__name__


# ------------------------------------------------------------ the copies


@functools.cache
def _dfas(pattern):
    return ref_s.compile_regex(pattern), port_s.compile_regex(pattern)


@settings(max_examples=50, deadline=None)
@given(st.sampled_from(PATTERNS), st.text(alphabet="abcdxyzfo0123.-@wr_", max_size=12))
def test_compile_regex_matches_reference(pattern, s):
    ref, port = _dfas(pattern)
    assert (port.start, port.accept, port.trans) == (ref.start, ref.accept, ref.trans)

    def accepts(dfa):
        state = dfa.start
        for ch in s:
            state = dfa.trans[state].get(ch)
            if state is None:
                return False
        return state in dfa.accept

    assert accepts(port) == accepts(ref)


def test_compile_regex_refusals_match_reference():
    for pat in (r"(?=a)b", r"a{999999}", r"a[", r"(ab", r"*a", "a\\", r"a[^\s\S]"):
        assert _outcome(port_s.compile_regex, pat)[1] == _outcome(ref_s.compile_regex, pat)[1]
        assert _outcome(port_s.compile_regex, pat)[1] == "RegexError"


_scalar = st.one_of(st.none(), st.booleans(), st.integers(-5, 5), st.text("ab ", max_size=3))
_schemas = st.recursive(
    st.one_of(
        st.fixed_dictionaries({"type": st.just("string")},
                              optional={"maxLength": st.integers(0, 4),
                                        "minLength": st.integers(0, 2)}),
        st.fixed_dictionaries({"type": st.sampled_from(
            ["integer", "boolean", "null", "number", "wat"])}),
        st.fixed_dictionaries({"enum": st.lists(_scalar, min_size=1, max_size=3)}),
        st.fixed_dictionaries({"const": _scalar})),
    lambda inner: st.one_of(
        st.fixed_dictionaries({"type": st.just("array"), "items": inner},
                              optional={"maxItems": st.integers(0, 2),
                                        "minItems": st.integers(0, 1)}),
        st.builds(lambda props: {"type": "object", "properties": props,
                                 "required": sorted(props)},
                  st.dictionaries(st.sampled_from(["a", "b", "c"]), inner, max_size=2))),
    max_leaves=4)
_values = st.recursive(_scalar, lambda inner: st.one_of(
    st.lists(inner, max_size=3), st.dictionaries(st.sampled_from(["a", "b", "c"]), inner,
                                                 max_size=3)), max_leaves=6)


@settings(max_examples=50, deadline=None)
@given(_schemas, _values)
def test_json_schema_matches_reference(schema, value):
    assert _outcome(port_s.regex_for_schema, schema) == _outcome(ref_s.regex_for_schema, schema)
    assert (_outcome(port_s.validate_instance, value, schema)
            == _outcome(ref_s.validate_instance, value, schema))
    assert port_s.validate_instance(value, SCHEMA) == ref_s.validate_instance(value, SCHEMA)


_bias = st.dictionaries(
    st.one_of(st.integers(-3, 300), st.text("0123-x", min_size=1, max_size=3)),
    st.one_of(st.floats(-150, 150, allow_nan=False), st.text("1.e-", max_size=3),
              st.none()), max_size=4)
_bodies = st.fixed_dictionaries({}, optional={
    "guided_choice": st.one_of(st.lists(st.sampled_from(["a", "bb", "", "c.d"]), max_size=3),
                               st.just("x")),
    "guided_regex": st.sampled_from(PATTERNS + ["(ab", "", "(?=a)b"]),
    "response_format": st.one_of(
        st.sampled_from(["json", None]),
        st.fixed_dictionaries({"type": st.sampled_from(
            ["text", "json_object", "json_schema", "yaml_object"])}),
        st.builds(lambda s: {"type": "json_schema", "json_schema": {"schema": s}}, _schemas)),
    "logit_bias": st.one_of(st.none(), _bias)})


@settings(max_examples=50, deadline=None)
@given(_bodies, _bias)
def test_body_validation_and_logit_bias_match_reference(body, bias):
    assert (_outcome(port_s.validate_structured_body, body)[1]
            == _outcome(ref_s.validate_structured_body, body)[1])
    assert _outcome(port_s.parse_logit_bias, bias) == _outcome(ref_s.parse_logit_bias, bias)


@functools.cache
def _grammars(kind, payload_json):
    payload = json.loads(payload_json)
    ref, _ = ref_s.compile_grammar(kind, payload, JaxByteTokenizer(), 288,
                                   cache=ref_s.GrammarCache(1))
    port, _ = port_s.compile_grammar(kind, payload, TOK, 288, cache=port_s.GrammarCache(1))
    return ref, port


SPECS = [("choice", json.dumps(CHOICES)), ("regex", json.dumps(REGEX)),
         ("json_schema", json.dumps(SCHEMA))]


@pytest.mark.parametrize("kind,payload", SPECS)
def test_dense_tables_match_reference(kind, payload):
    ref, port = _grammars(kind, payload)
    rb, rn = ref.dense_tables()
    pb, pn = port.dense_tables()
    assert np.array_equal(pb, rb) and np.array_equal(pn, rn)
    assert (port.n_states, port.start, port.accept) == (ref.n_states, ref.start, ref.accept)


@settings(max_examples=50, deadline=None)
@given(st.sampled_from(SPECS), st.lists(st.integers(0, 287), max_size=8), st.data())
def test_legal_prefix_len_matches_reference(spec, tokens, data):
    ref, port = _grammars(*spec)
    state = data.draw(st.integers(0, ref.n_states - 1))
    # a walk along allowed tokens too, so long legal prefixes are drawn
    walk, s = [], state
    for _ in range(6):
        allowed = ref.allowed_ids(s)
        t = int(allowed[data.draw(st.integers(0, len(allowed) - 1))])
        walk.append(t)
        s = ref.advance(s, t)
        if s is None:
            break
    for toks in (tokens, walk + tokens):
        assert port.legal_prefix_len(state, toks) == ref.legal_prefix_len(state, toks)


def test_grammar_cache_hits_and_evictions_match_reference():
    caches = (ref_s.GrammarCache(capacity=2), port_s.GrammarCache(capacity=2))
    toks = (JaxByteTokenizer(), TOK)
    mods = (ref_s, port_s)
    trace = [[], []]
    for words in (["a", "b"], ["a", "b"], ["c"], ["d"], ["a", "b"], ["d"]):
        for i in range(2):
            _, hit = mods[i].compile_grammar("choice", words, toks[i], 258, cache=caches[i])
            trace[i].append(hit)
    assert trace[1] == trace[0] == [False, True, False, False, False, True]
    r, p = caches
    assert (p.hits, p.misses, p.evictions, len(p)) == (r.hits, r.misses, r.evictions, len(r))


# ------------------------------------------------------------- the engine


@functools.cache
def _weights():
    jcfg = dataclasses.replace(jax_model_config("tiny"), dtype="float32")
    tcfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _engine(tokenizer=TOK, **over) -> LLMEngine:
    _, tcfg, _, npp = _weights()
    return LLMEngine(tcfg, EngineConfig(**{**BASE, **over}), seed=3, device="cpu",
                     params=tt.params_from_numpy(tcfg, npp), tokenizer=tokenizer)


def _drain(eng):
    toks, fins, steps = {}, {}, 0
    while eng.has_work():
        for o in eng.step():
            toks.setdefault(o.request_id, []).extend(o.new_token_ids)
            if o.finish_reason:
                fins[o.request_id] = o.finish_reason
        steps += 1
        assert steps < 2000, "no forward progress"
    return toks, fins


def _sp(jax_side=False, **kw):
    base = dict(max_tokens=64, temperature=0.0, stop_token_ids=(EOS,))
    return (JaxSamplingParams if jax_side else SamplingParams)(**{**base, **kw})


def _check(kind, text):
    if kind == "choice":
        assert text in CHOICES, text
    elif kind == "regex":
        assert re.fullmatch(REGEX, text), text
    else:
        assert port_s.validate_instance(json.loads(text), SCHEMA), text


def test_corpus_conforms_and_greedy_matches_reference():
    """The corpus, greedy and sampled, through one port engine: every
    generation ends at its grammar's EOS and parses, no violation; the
    greedy constrained tokens equal the JAX engine's."""
    eng = _engine()
    for kind, fields in CORPUS:
        for temp in (0.0, 0.7):
            eng.add_request(f"{kind}-t{temp}", TOK.encode(f"please emit one {kind} now"),
                            _sp(temperature=temp, **fields))
    toks, fins = _drain(eng)
    assert len(toks) == 6
    for rid, ids in toks.items():
        assert fins[rid] == "stop" and ids[-1] == EOS, rid
        _check(rid.split("-")[0], TOK.decode(ids))
    st = eng.stats
    assert st.structured_requests == 6 and st.structured_violations == 0
    assert st.structured_mask_builds > 0 and st.structured_chain_stages > 0
    text = eng.registry.expose()
    assert 'llmd_tpu:structured_requests_total{kind="json_schema"} 2' in text
    assert "llmd_tpu:structured_violations_total 0" in text

    jcfg, _, jp, _ = _weights()
    je = JaxEngine(jcfg, JaxEngineConfig(**BASE, attn_impl="reference"), params=jp,
                   seed=3, tokenizer=JaxByteTokenizer())
    pe = _engine()
    for e, jax_side in ((je, True), (pe, False)):
        for kind, fields in CORPUS:
            e.add_request(f"{kind}-t0.0", TOK.encode(f"please emit one {kind} now"),
                          _sp(jax_side, **fields))
    ref, _ = _drain(je)
    port, _ = _drain(pe)
    assert port == ref
    for key in ("structured_requests", "structured_violations", "structured_chain_stages",
                "structured_mask_builds", "n_unified_steps", "n_decode_calls"):
        assert getattr(pe.stats, key) == getattr(je.stats, key), key


def test_corpus_survives_preemption():
    """A pool that one long constrained generation fits and two overcommit:
    preemption by recompute mid-generation, the automaton re-derived from
    the tokens, every generation conformant."""
    p_choices = ["abcdefghijklmnopqrstuvwx", "zyxwvutsrqponmlkjihgfedc"]
    checks = [("choice", dict(guided_choice=p_choices), lambda t: t in p_choices),
              ("regex", dict(guided_regex=r"[ab]{24}"),
               lambda t: re.fullmatch(r"[ab]{24}", t)),
              ("schema", CORPUS[2][1],
               lambda t: port_s.validate_instance(json.loads(t), SCHEMA))]
    eng = _engine(num_pages=10, max_batch_size=2, enable_prefix_caching=False)
    for i, (kind, fields, _) in enumerate(checks):
        eng.add_request(f"{kind}-p", TOK.encode("x" * (28 + 2 * i)),
                        _sp(temperature=0.7 if i % 2 else 0.0, **fields))
    toks, fins = _drain(eng)
    assert eng.stats.total_preemptions > 0 and eng.stats.structured_violations == 0
    for kind, _, check in checks:
        assert fins[f"{kind}-p"] == "stop"
        assert check(TOK.decode(toks[f"{kind}-p"][:-1])), TOK.decode(toks[f"{kind}-p"])


def test_structured_off_unchanged_and_captures_nothing():
    """An unconstrained request gives bitwise the same tokens with structured
    outputs off, with no tokenizer, and beside a constrained neighbour; an
    engine that never sees a constrained row builds no masked program and no
    tables. Off (or no tokenizer) refuses structured requests, state
    untouched."""
    prompt = TOK.encode("the quick brown fox jumps over the lazy dog")
    sp = _sp(max_tokens=16, stop_token_ids=())
    outs = []
    for kw in (dict(structured_mode="off"), dict(tokenizer=None), {}):
        eng = _engine(decode_steps=4, **kw)
        eng.add_request("u", prompt, sp)
        if not kw:
            eng.add_request("s", TOK.encode("pick"), _sp(guided_choice=CHOICES))
        toks, _ = _drain(eng)
        outs.append(toks["u"])
        if kw:
            assert eng._decode_masked_fn is None and eng._mask_buffers is None
            assert eng.compile_counts() == dict.fromkeys(
                ["unified", "verify", "verify_masked", "decode", "decode_masked", "embed"], 0)
            with pytest.raises(ValueError):
                eng.add_request("s", prompt, _sp(guided_choice=CHOICES))
            assert not eng.has_work() and "s" not in eng.seqs
        else:
            _check("choice", TOK.decode(toks["s"][:-1]))
            assert eng._decode_masked_fn is not None
    assert outs[0] == outs[1] == outs[2]
    with pytest.raises(ValueError):
        _engine(structured_mode="always")


def test_logit_bias_round_trip():
    """+100 on one byte dominates every greedy step; -100 bans the token an
    unbiased run picks first."""
    eng = _engine()
    z = TOK.encode("z")[0]
    eng.add_request("force", TOK.encode("say something"),
                    _sp(max_tokens=6, logit_bias={z: 100}, stop_token_ids=()))
    eng.add_request("plain", TOK.encode("say something"), _sp(max_tokens=6, stop_token_ids=()))
    toks, _ = _drain(eng)
    assert TOK.decode(toks["force"]) == "zzzzzz"
    banned = toks["plain"][0]
    eng.add_request("ban", TOK.encode("say something"),
                    _sp(max_tokens=6, logit_bias={str(banned): -100}, stop_token_ids=()))
    toks, _ = _drain(eng)
    assert banned not in toks["ban"]


# --------------------------------------------------------------- the server

MODEL = "llmd-tpu/tiny"
SERVER_KW = dict(page_size=8, num_pages=64, max_model_len=128, max_batch_size=2,
                 prefill_chunk=16)
MSGS = [{"role": "user", "content": "go"}]
SAMPLING_FIELDS = {"min_p": 0.1, "logprobs": 2, "presence_penalty": 0.5,
                   "frequency_penalty": 0.3, "repetition_penalty": 1.2, "n": 2}


async def _script(base: str) -> dict:
    out = {}
    z = str(TOK.encode("z")[0])
    cases = [
        ("schema chat", "/v1/chat/completions", {"response_format": {
            "type": "json_schema", "json_schema": {"schema": SCHEMA}}}),
        ("choice", "/v1/completions", {"guided_choice": CHOICES}),
        ("choice stream", "/v1/completions", {"guided_choice": CHOICES, "stream": True}),
        ("regex chat stream", "/v1/chat/completions", {"guided_regex": REGEX,
                                                        "stream": True}),
        ("bias", "/v1/completions", {"logit_bias": {z: 100}, "max_tokens": 5}),
        ("json_object", "/v1/completions", {"response_format": {"type": "json_object"},
                                            "max_tokens": 8}),
        ("text format", "/v1/completions", {"response_format": {"type": "text"},
                                            "max_tokens": 4}),
        ("bad schema", "/v1/chat/completions", {"response_format": {
            "type": "json_schema", "json_schema": {"schema": {"type": "wat"}}}}),
        ("bad regex", "/v1/completions", {"guided_regex": "(ab"}),
        ("bad regex stream", "/v1/completions", {"guided_regex": "(ab", "stream": True}),
        ("bad bias", "/v1/completions", {"logit_bias": {"3": 101}}),
        ("bad format", "/v1/completions", {"response_format": {"type": "yaml_object"}}),
    ] + [(f"field {k}", "/v1/completions", {k: v, "max_tokens": 6})
         for k, v in SAMPLING_FIELDS.items()] + [
        ("all fields chat", "/v1/chat/completions", {**SAMPLING_FIELDS, "max_tokens": 6})]
    async with aiohttp.ClientSession() as s:
        for name, path, extra in cases:
            chat = path.endswith("chat/completions")
            body = {"model": MODEL, "max_tokens": 48, "temperature": 0.0,
                    **({"messages": MSGS} if chat else {"prompt": "emit"}), **extra}
            async with s.post(base + path, json=body) as r:
                if r.status != 200:
                    out[name] = (r.status, None)
                    await r.read()
                    continue
                if extra.get("stream"):
                    events = []
                    async for line in r.content:
                        line = line.decode().strip()
                        if line.startswith("data: ") and line != "data: [DONE]":
                            events.append(json.loads(line[6:]))
                    text = "".join(e["choices"][0]["delta"]["content"] if chat
                                   else e["choices"][0]["text"] for e in events)
                    out[name] = (r.status, text, events[-1]["choices"][0]["finish_reason"],
                                 len(events) > 1)
                else:
                    data = await r.json()
                    c = data["choices"]
                    out[name] = (r.status, c[0]["message"]["content"] if chat else c[0]["text"],
                                 c[0]["finish_reason"], len(c))
    return out


@pytest.fixture(scope="module")
def scripts():
    """The script against the reference's EngineServer, then the port's."""
    async def main():
        jcfg, tcfg, jp, npp = _weights()
        ref = JaxEngineServer(jcfg, JaxEngineConfig(**SERVER_KW, attn_impl="reference"),
                              model_name=MODEL, host="127.0.0.1", port=0, params=jp)
        await ref.start()
        try:
            want = await _script(f"http://{ref.address}")
        finally:
            await ref.stop()
        port = EngineServer(tcfg, EngineConfig(**SERVER_KW), model_name=MODEL,
                            host="127.0.0.1", port=0, params=tt.params_from_numpy(tcfg, npp),
                            device="cpu")
        port.start()
        try:
            got = await _script(f"http://{port.address}")
        finally:
            port.stop()
        return want, got

    return run_async(main())


def test_structured_http_matches_reference(scripts):
    want, got = scripts
    names = [k for k in want if not k.startswith(("field", "all fields"))]
    for name in names:
        assert got[name] == want[name], name
    status, content, reason, n = want["schema chat"]
    assert status == 200 and reason == "stop" and n == 1
    assert port_s.validate_instance(json.loads(content), SCHEMA)
    assert want["choice"][1] in CHOICES and want["choice stream"][1] in CHOICES
    assert want["choice stream"][3]  # streamed piece by piece
    assert re.fullmatch(REGEX, want["regex chat stream"][1])
    assert want["bias"][1] == "zzzzz"
    for bad in ("bad schema", "bad regex", "bad regex stream", "bad bias", "bad format"):
        assert want[bad] == (400, None), bad


def test_reference_sampling_fields_accepted(scripts):
    """min_p, logprobs, the penalties and n: the reference accepts them and
    does not act on them; so does the port: 200, the greedy text of the
    same prompt, one choice."""
    want, got = scripts
    for name in [k for k in want if k.startswith(("field", "all fields"))]:
        assert got[name] == want[name], name
        status, text, _, n_choices = got[name]
        assert status == 200 and n_choices == 1 and text, name
    texts = {got[k][1] for k in got if k.startswith("field")}
    assert len(texts) == 1  # the fields do not change the greedy tokens
