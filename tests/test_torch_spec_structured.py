"""Speculation on constrained rows in the port (mirroring
``tests/test_spec_structured.py``): grammar rows draft through the host
automaton and verify through the masked verify program
(``engine/verify_program.verify_masked``), against the JAX engine on the same
float32 weights.

- A mixed batch (choice, regex, a forced schema echo, an unconstrained echo):
  tokens with speculation = the JAX engine's with speculation = the port's
  without, the constrained rows drafting and accepting, no violation, and
  the constrained counts equal the JAX engine's.
- The verify program's automaton states, computed on the host
  (``verify_states``), against the reference's ``lax.scan``; and the masked
  verify program against the JAX engine's ``_verify_masked_fn`` on the same
  packed batch (greedy tokens and next states).
- FSM rollback: a branchy schema whose periodic drafts mispredict, with the
  crosscheck on (device state = host resync after every verify step, zero
  mismatches) and off (the device state adopted: the same tokens).
- Preemption mid-speculation, conformant and equal to plain decode.
- The step-program registry: its routing table, the engine's wiring and the
  per-program ledger balanced after a constrained speculative drain.
- Per-sequence arming: a disarmed row is not probed, still lands its token
  through the verify plan, and re-arms.
"""

import dataclasses
import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.programs import ProgramRegistry
from llmd_tpu_torch.engine.tokenizer import ByteTokenizer
from llmd_tpu_torch.engine.verify_program import verify_masked, verify_states
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.structured import GrammarCache, compile_grammar, validate_instance

TOK = ByteTokenizer()
EOS = TOK.eos_id
CHOICES = ["red", "green", "blue"]
REGEX = r"[a-c]{3}-[0-9]{2}"
BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4, prefill_chunk=32)
SPEC = dict(spec_mode="ngram", spec_tokens=8)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _echo_schema(n_items: int, values=("on",)) -> dict:
    """A fixed-count array of single-key objects: with one enum value its
    serialization is fully forced and periodic; with several, every item is
    a branch point where a periodic draft can mispredict."""
    return {"type": "array",
            "items": {"type": "object", "properties": {"s": {"enum": list(values)}},
                      "required": ["s"]},
            "minItems": n_items, "maxItems": n_items}


def _pattern_prompt(value: str = "on", reps: int = 4) -> list[int]:
    return TOK.encode('[{"s":"%s"},' % value + ('{"s":"%s"},' % value) * reps)


def _fmt(schema):
    return {"type": "json_schema", "json_schema": {"schema": schema}}


@functools.cache
def _weights():
    jcfg = dataclasses.replace(jax_model_config("tiny"), dtype="float32")
    tcfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _engine(spec=False, **over) -> LLMEngine:
    _, tcfg, _, npp = _weights()
    return LLMEngine(tcfg, EngineConfig(**{**BASE, **(SPEC if spec else {}), **over}),
                     params=tt.params_from_numpy(tcfg, npp), device="cpu", tokenizer=TOK)


def _jax_engine(**over) -> JaxEngine:
    jcfg, _, jp, _ = _weights()
    return JaxEngine(jcfg, JaxEngineConfig(**{**BASE, **SPEC, **over}, attn_impl="reference"),
                     params=jp, tokenizer=JaxByteTokenizer())


def _sp(jax_side=False, **kw):
    base = dict(max_tokens=96, temperature=0.0, stop_token_ids=(EOS,))
    return (JaxSamplingParams if jax_side else SamplingParams)(**{**base, **kw})


def _drain(eng, requests):
    jax_side = isinstance(eng, JaxEngine)
    for rid, prompt, kw in requests:
        eng.add_request(rid, prompt, _sp(jax_side, **kw))
    out, steps = {}, 0
    while eng.has_work():
        for o in eng.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
        steps += 1
        assert steps < 2000, "no forward progress"
    return out


def _text(ids):
    return TOK.decode([t for t in ids if t != EOS])


CONSTRAINED = ("spec_drafted", "spec_accepted", "spec_rejected", "n_spec_verify_steps",
               "spec_drafted_constrained", "spec_accepted_constrained",
               "structured_violations", "structured_chain_stages", "structured_mask_builds")


def test_mixed_constrained_batch_matches_reference():
    echo = [(7919 + j % 3) % 286 + 1 for j in range(48)]
    requests = [("choice", TOK.encode("pick"), dict(guided_choice=CHOICES)),
                ("regex", TOK.encode("match"), dict(guided_regex=REGEX)),
                ("schema", _pattern_prompt(), dict(response_format=_fmt(_echo_schema(6)))),
                ("echo", echo, dict(max_tokens=24, stop_token_ids=()))]
    je, te = _jax_engine(), _engine(spec=True)
    want = _drain(je, requests)
    assert _drain(te, requests) == want
    assert _drain(_engine(), requests) == want
    st_ = te.stats
    assert st_.n_spec_verify_steps > 0 and st_.spec_accepted_constrained > 0
    assert st_.structured_violations == 0
    for key in CONSTRAINED:
        assert getattr(st_, key) == getattr(je.stats, key), key
    assert _text(want["choice"]) in CHOICES
    assert re.fullmatch(REGEX, _text(want["regex"]))
    assert validate_instance(json.loads(_text(want["schema"])), _echo_schema(6))
    counters = te.programs.counters()
    assert counters["verify_masked"][0] > 0 and te.programs.quiesced()
    # the acceptance summary's constrained series
    assert te.metrics.spec_acceptance.labels(constrained="yes").count > 0


@functools.cache
def _grammar():
    g, _ = compile_grammar("json_schema", _echo_schema(3, ("on", "off")), TOK, 288,
                           cache=GrammarCache(1))
    return g


@jax.jit
def _scan_states(tokens, sids, first, valid, fsm0, gidx, next_tab):
    """The reference's scan over the packed rows (``_verify_masked``,
    ``llmd_tpu/engine/engine.py:595-603``)."""
    def advance(st_, x):
        tok, row, is_first, ok = x
        cur = jnp.where(is_first, st_[row], next_tab[gidx[row], st_[row], tok])
        st_ = st_.at[row].set(jnp.where(ok, cur, st_[row]))
        return st_, jnp.where(ok, cur, 0)

    _, cur = jax.lax.scan(advance, fsm0, (tokens, sids, first, valid))
    return cur


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_verify_states_match_reference_scan(data):
    """Rows with a grammar (entry state anywhere, drafts walked along allowed
    tokens or arbitrary ones), logit_bias rows and unconstrained rows, padded
    to a static width as the reference packs them."""
    g = _grammar()
    _, nx = g.dense_tables()
    S, V = g.n_states, g.vocab_size
    n_rows = data.draw(st.integers(1, 4))
    chunks, kinds = [], []
    for _ in range(n_rows):
        kind = data.draw(st.sampled_from(["g", "b", "u"]))
        state = data.draw(st.integers(0, S - 1)) if kind == "g" else 0
        draft, s = [], state
        for _ in range(data.draw(st.integers(0, 5))):
            if kind == "g" and data.draw(st.booleans()):
                allowed = g.allowed_ids(s)
                tok = int(allowed[data.draw(st.integers(0, len(allowed) - 1))])
            else:
                tok = data.draw(st.integers(0, V - 1))
            draft.append(tok)
            s = int(nx[s, tok])
        chunks.append((draft, state, nx if kind == "g" else None))
        kinds.append(kind)
    host = verify_states(chunks)
    # the reference's packing: last token + draft per row, padding after to
    # one static width
    NT = 32
    tokens = np.zeros(NT, np.int32)
    sids = np.zeros(NT, np.int32)
    valid = np.zeros(NT, bool)
    fsm0 = np.zeros(8, np.int32)
    gidx = np.zeros(8, np.int32)
    off = 0
    for i, ((draft, state, _), kind) in enumerate(zip(chunks, kinds)):
        n = 1 + len(draft)
        tokens[off : off + n] = [data.draw(st.integers(0, V - 1))] + draft
        sids[off : off + n] = i
        valid[off : off + n] = True
        fsm0[i] = state
        gidx[i] = {"g": 1, "b": 2, "u": 0}[kind]
        off += n
    first = np.concatenate([[True], sids[1:] != sids[:-1]])
    S_pad = 1 << (S - 1).bit_length()
    next_tab = np.zeros((4, S_pad, V), np.int32)
    next_tab[1, :S] = nx
    ref = np.asarray(_scan_states(tokens, sids, first, valid, fsm0, gidx, next_tab))
    assert np.array_equal(host, ref[:off])


def test_verify_masked_matches_reference_program():
    """One packed batch (a grammar row walking its allowed tokens, a
    logit_bias row, an unconstrained row; fresh sequences over empty pools)
    through the JAX engine's ``_verify_masked_fn`` and the port's
    ``verify_masked``: the same greedy tokens and next states."""
    g = _grammar()
    b, nx = g.dense_tables()
    S, V = g.n_states, 288
    S_pad, G_pad = 1 << (S - 1).bit_length(), 4
    bias_tab = np.zeros((G_pad, S_pad, V), np.float32)
    next_tab = np.zeros((G_pad, S_pad, V), np.int32)
    bias_tab[1, :S], next_tab[1, :S] = b, nx
    bias_tab[2, 0, 100], bias_tab[2, 0, 101] = -1e9, 50.0
    walk, s = [], g.start
    for _ in range(4):
        tok = int(g.allowed_ids(s)[0])
        walk.append(tok)
        s = int(nx[s, tok])
    chunks = [(walk, g.start, nx), ([100, 101], 0, None), ([5, 6, 7], 0, None)]
    gi = np.array([1, 2, 0], np.int32)
    lens_q = [1 + len(d) for d, _, _ in chunks]
    N, nb = sum(lens_q), len(chunks)
    toks = np.array([t for i, (d, _, _) in enumerate(chunks) for t in [40 + i] + d], np.int32)
    pos = np.concatenate([np.arange(n) for n in lens_q]).astype(np.int32)
    sids = np.repeat(np.arange(nb), lens_q).astype(np.int32)
    lens = np.array(lens_q, np.int32)
    cu = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    je = _jax_engine(max_batch_size=nb)
    te = _engine(max_batch_size=nb)
    maxp = te.cfg.max_pages_per_seq
    pts = np.full((nb, maxp), -1, np.int32)
    pts[:, 0] = np.arange(nb)
    NT = je._verify_nt()
    pad = lambda a, v: np.concatenate([a, np.full(NT - len(a), v, a.dtype)])  # noqa: E731
    greedy_j, fsm_j, _, _, _ = je._verify_masked_fn(
        je.params, je.cache, pad(toks, 0), pad(pos, -1), pad(sids, 0), pts, lens, cu,
        np.array([nb], np.int32), np.zeros((NT,), np.int32),
        np.array([g.start, 0, 0], np.int32), gi, bias_tab, next_tab)
    tables = te._mask_tables({"key": ("t",), "G_pad": G_pad, "S_pad": S_pad, "V": V,
                              "entries": [("g", g), ("b", ((100, -100.0), (101, 50.0)))]})
    t = torch.from_numpy
    batch = {"tokens": t(toks), "positions": t(pos), "seq_slots": t(sids),
             "page_tables": t(pts), "kv_lens": t(lens), "cu_q_lens": t(cu),
             "num_seqs": t(np.array([nb], np.int32))}
    greedy_p, fsm_p, _, _, _ = verify_masked(
        te.model_cfg, te.params, te.cache, batch, tables, t(np.repeat(gi * S_pad, lens_q)),
        t(verify_states(chunks)), attn_impl=te._attn["unified"], moe_dispatch_impl=None,
        moe_rows=None)
    assert np.array_equal(greedy_p.numpy(), np.asarray(greedy_j)[:N])
    assert np.array_equal(fsm_p.numpy(), np.asarray(fsm_j)[:N])
    bias_rows = greedy_p[lens_q[0]: lens_q[0] + lens_q[1]].tolist()
    assert 100 not in bias_rows and bias_rows == [101] * lens_q[1]
    for j, tok in enumerate(greedy_p[: lens_q[0]].tolist()):  # the grammar row stays legal
        assert tok in g.allowed_ids(int(verify_states(chunks)[j]))


@pytest.mark.parametrize("crosscheck", [True, False])
def test_fsm_rollback_matches_host_sync(crosscheck):
    """A two-value enum per item: periodic drafts mispredict at item
    boundaries, the masked verify rejects the tail and rolls the automaton
    back with it. Crosscheck on: device state = host resync after every
    verify step (zero mismatches); off: the device state adopted. Either way
    the tokens are plain decode's, every output conforms."""
    schema = _echo_schema(8, values=("on", "off"))
    requests = [(f"s-{i}", _pattern_prompt(v), dict(max_tokens=128,
                                                    response_format=_fmt(schema)))
                for i, v in enumerate(("on", "off"))]
    eng = _engine(spec=True, spec_structured_crosscheck=crosscheck)
    got = _drain(eng, requests)
    st_ = eng.stats
    assert st_.spec_drafted_constrained > 0 and st_.spec_rejected > 0
    assert st_.spec_fsm_crosscheck_mismatches == 0 and st_.structured_violations == 0
    assert got == _drain(_engine(), requests)
    for ids in got.values():
        assert validate_instance(json.loads(_text(ids)), schema)


def test_preemption_mid_speculation_stays_conformant():
    schema = _echo_schema(3)
    requests = [(f"s-{i}", _pattern_prompt(reps=2),
                 dict(max_tokens=48, response_format=_fmt(schema))) for i in range(3)]
    kw = dict(num_pages=12, max_batch_size=2, enable_prefix_caching=False)
    eng = _engine(spec=True, **kw)
    got = _drain(eng, requests)
    assert eng.stats.total_preemptions > 0 and eng.stats.spec_drafted_constrained > 0
    assert eng.stats.structured_violations == 0
    assert got == _drain(_engine(**kw), requests)
    for ids in got.values():
        assert validate_instance(json.loads(_text(ids)), schema)


def test_registry_routing_table():
    class Eng:
        def __init__(self, **flags):
            self.__dict__.update(flags)

    reg = ProgramRegistry()
    reg.register("unified", eligible=lambda e: e.constrained or e.prefilling,
                 run=lambda e: None)
    reg.register("verify", eligible=lambda e: e.spec, run=lambda e: None)
    reg.register("verify_masked")
    reg.register("decode", eligible=lambda e: e.decodable, run=lambda e: None)
    table = [(dict(constrained=True, prefilling=False, spec=True, decodable=True), "unified"),
             (dict(constrained=False, prefilling=True, spec=False, decodable=True), "unified"),
             (dict(constrained=False, prefilling=False, spec=True, decodable=True), "verify"),
             (dict(constrained=False, prefilling=False, spec=False, decodable=True), "decode")]
    for flags, want in table:
        assert reg.route(Eng(**flags)).name == want
    with pytest.raises(RuntimeError):
        reg.route(Eng(constrained=False, prefilling=False, spec=False, decodable=False))
    with pytest.raises(ValueError):
        reg.register("decode")
    reg.record_dispatch("decode")
    assert not reg.quiesced()
    reg.record_complete("decode")
    assert reg.quiesced() and reg.counters()["decode"] == (1, 1)


def test_engine_registry_wiring_and_quiesce():
    """Routable entries in priority order, the masked variants and the
    embed program not routable (``embed()`` drives it), and after a
    constrained speculative drain every program's ledger balances; on the
    CPU nothing is captured."""
    eng = _engine(spec=True)
    specs = {s.name: s for s in eng.programs.specs()}
    assert [s.name for s in eng.programs.specs() if s.run is not None] == [
        "unified", "verify", "decode"]
    for name in ("verify_masked", "decode_masked"):
        assert specs[name].run is None and specs[name].eligible is None
    eng.generate([_pattern_prompt()], _sp(response_format=_fmt(_echo_schema(6))))
    counters = eng.programs.counters()
    assert eng.programs.quiesced(), counters
    assert counters["verify_masked"][0] > 0
    assert set(eng.compile_counts().values()) == {0}
    m = eng.metrics.program_dispatches
    for name, (d, _) in counters.items():
        assert m.labels(program=name).value == d, name


def test_per_sequence_arming():
    """A disarmed row is skipped by the probe, still lands its plain token
    through the verify plan, and re-arms when it does."""
    eng = _engine(spec=True)
    eng.add_request("echo", [(7919 + j % 3) % 286 + 1 for j in range(64)],
                    _sp(max_tokens=48, stop_token_ids=()))
    eng.add_request("flat", list(range(10, 58)), _sp(max_tokens=48, stop_token_ids=()))
    seqs, steps = {}, 0
    while eng.has_work() and eng.stats.n_spec_verify_steps < 3:
        seqs.update({s.request_id: s for s in eng.running if s is not None})
        eng.step()
        steps += 1
        assert steps < 2000
    flat, echo = seqs["flat"], seqs["echo"]
    assert not flat.finished and not echo.finished and echo.spec_drafted > 0
    probed: list[str] = []
    orig = eng._spec_propose
    eng._spec_propose = lambda s, m: (probed.append(s.request_id), orig(s, m))[1]
    try:
        v0 = eng.stats.n_spec_verify_steps
        for _ in range(60):
            assert not flat.finished and not echo.finished
            flat.spec_armed = False
            probed.clear()
            n_flat = len(flat.token_ids)
            eng.step()
            if eng.stats.n_spec_verify_steps > v0:
                break
            v0 = eng.stats.n_spec_verify_steps
        else:
            raise AssertionError("no verify step while flat was disarmed")
    finally:
        eng._spec_propose = orig
    assert "flat" not in probed and "echo" in probed
    assert len(flat.token_ids) > n_flat and flat.spec_armed
