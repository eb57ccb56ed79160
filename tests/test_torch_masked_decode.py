"""The masked decode program (``engine/decode_program.py`` with
``MaskTables``; the reference's ``_decode_multi_masked``), mirroring
``tests/test_device_resident_decode.py``, on the CPU in float32.

Constrained rows (grammars and ``logit_bias``) ride the decode chain with
the bias gather, the biased sample and the automaton step on the device;
the automaton state is part of the chain point. Held here:

- a mixed batch (plain, choice, regex, logit_bias rows and a long choice):
  the masked chain's greedy tokens bitwise equal to the one-token unified
  degrade (``structured_fused_decode=False``) and to the JAX engine's masked
  chain, with the same chain stagings, unified steps and decode calls;
- the state carried across chained calls at ``pipeline_depth`` 1 and 2,
  equal to the JAX engine's;
- ``pack_overlap`` on and off give the JAX engine's tokens;
- a row with a grammar and a bias, and tables past
  ``structured_table_max_elems``, degrade to unified steps as the
  reference's do;
- preemption mid-chain stays conformant, with the JAX engine's tokens and
  preemptions;
- ``dense_tables`` against the host automaton (``fill_bias``, ``advance``).
"""

import dataclasses
import functools
import re

import jax
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.tokenizer import ByteTokenizer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.structured import GrammarCache, compile_grammar

TOK = ByteTokenizer()
EOS = TOK.eos_id
CHOICES = ["red", "green", "blue"]
LONG = ["abcdefghijklmnopqrstuvwx", "zyxwvutsrqponmlkjihgfedc"]
REGEX = r"[a-c]{3}-[0-9]{2}"
BASE = dict(page_size=8, num_pages=128, max_model_len=256, max_batch_size=4, prefill_chunk=32,
            decode_steps=4)
STATS = ("structured_chain_stages", "structured_mask_builds", "structured_violations",
         "n_unified_steps", "n_decode_calls", "n_chained_dispatches")


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


def _engine(**over) -> LLMEngine:
    _, tcfg, _, npp = _weights()
    return LLMEngine(tcfg, EngineConfig(**{**BASE, **over}), params=tt.params_from_numpy(tcfg, npp),
                     device="cpu", tokenizer=TOK)


def _jax_engine(**over) -> JaxEngine:
    jcfg, _, jp, _ = _weights()
    return JaxEngine(jcfg, JaxEngineConfig(**{**BASE, **over}, attn_impl="reference"),
                     params=jp, tokenizer=JaxByteTokenizer())


def _drain(eng, requests):
    jax_side = isinstance(eng, JaxEngine)
    for rid, prompt, kw in requests:
        base = dict(max_tokens=32, temperature=0.0, stop_token_ids=(EOS,))
        eng.add_request(rid, prompt, (JaxSamplingParams if jax_side else SamplingParams)(
            **{**base, **kw}))
    toks, fins, steps = {}, {}, 0
    while eng.has_work():
        for o in eng.step():
            toks.setdefault(o.request_id, []).extend(o.new_token_ids)
            if o.finish_reason:
                fins[o.request_id] = o.finish_reason
        steps += 1
        assert steps < 2000, "no forward progress"
    # every launched call was read back, every program's ledger balances
    assert eng.stats.n_decode_dispatches == eng.stats.n_decode_calls
    assert not eng._pending_decode and eng.programs.quiesced()
    return toks, fins


def _text(ids):
    return TOK.decode([t for t in ids if t != EOS])


Z = TOK.encode("z")[0]
MIXED = [("plain", TOK.encode("the quick brown fox"),
          dict(max_tokens=16, stop_token_ids=(), ignore_eos=True)),
         ("choice", TOK.encode("pick a color"), dict(guided_choice=CHOICES)),
         ("regex", TOK.encode("emit a code"), dict(guided_regex=REGEX)),
         ("bias", TOK.encode("say"), dict(max_tokens=8, logit_bias={Z: 100},
                                          stop_token_ids=())),
         ("long", TOK.encode("x"), dict(guided_choice=LONG))]


@functools.cache
def _reference_mixed():
    """The JAX engine's tokens, finish reasons and counts on ``MIXED`` at
    the defaults (computed once: two tests hold the port to them)."""
    je = _jax_engine()
    toks, fins = _drain(je, MIXED)
    return toks, fins, {key: getattr(je.stats, key) for key in STATS}


def test_fused_masked_chain_matches_unified_degrade_and_reference():
    want, _, counts = _reference_mixed()
    outs = {}
    for fused in (True, False):
        eng = _engine(structured_fused_decode=fused)
        toks, fins = _drain(eng, MIXED)
        outs[fused] = toks
        assert eng.stats.structured_violations == 0
        assert fins["choice"] == "stop" and fins["regex"] == "stop"
        if fused:
            assert eng.stats.structured_chain_stages > 0
            assert eng.programs.counters()["decode_masked"][0] > 0
            assert {key: getattr(eng.stats, key) for key in STATS} == counts
        else:
            assert eng.stats.structured_chain_stages == 0 and eng._decode_masked_fn is None
    assert outs[True] == outs[False] == want
    assert _text(want["choice"]) in CHOICES and re.fullmatch(REGEX, _text(want["regex"]))
    assert _text(want["long"]) in LONG
    assert TOK.decode(want["bias"]) == "z" * 8


@pytest.mark.parametrize("depth", [1, 2])
def test_masked_chain_state_carried_across_calls(depth):
    """Long constrained generations over many chained calls: the automaton
    state each call ends with starts the next one (the host uploads it only
    at a chain start), as the JAX engine's device-resident chain does."""
    requests = [("c0", TOK.encode("pick one"), dict(guided_choice=LONG)),
                ("c1", TOK.encode("emit bits"), dict(guided_regex=r"[ab]{24}"))]
    want, _ = _drain(_jax_engine(pipeline_depth=depth), requests)
    eng = _engine(pipeline_depth=depth)
    toks, fins = _drain(eng, requests)
    assert toks == want
    st = eng.stats
    assert st.structured_chain_stages > 0 and st.n_chained_dispatches > 0
    assert st.structured_violations == 0 and fins == {"c0": "stop", "c1": "stop"}
    assert _text(toks["c0"]) in LONG and re.fullmatch(r"[ab]{24}", _text(toks["c1"]))


def test_pack_overlap_parity_with_constrained_rows():
    """``pack_overlap`` on (the reference's default) and off: the same
    tokens, finish reasons and counts as the JAX engine with it on."""
    toks, fins, counts = _reference_mixed()
    for overlap in (True, False):
        eng = _engine(pack_overlap=overlap)
        assert _drain(eng, MIXED) == (toks, fins)
        assert eng.stats.n_chained_dispatches > 0
        assert (eng.stats.time_pack_overlap > 0) == overlap
        if overlap:
            assert {key: getattr(eng.stats, key) for key in STATS} == counts


@pytest.mark.parametrize("case", ["grammar_and_bias", "table_gate"])
def test_inexpressible_batches_degrade_to_unified(case):
    """A row with a grammar AND a bias (two bias sources, one table slot),
    or tables past the size gate: no chain staged, the unified program
    serves the constrained rows, conformant, as in the reference."""
    if case == "grammar_and_bias":
        requests = [("c", TOK.encode("pick"), dict(guided_choice=CHOICES,
                                                   logit_bias={Z: -1.0}))]
        kw = {}
    else:
        requests = [("c", TOK.encode("pick"), dict(guided_choice=CHOICES))]
        kw = dict(structured_table_max_elems=16)
    requests.append(("plain", TOK.encode("abc"), dict(max_tokens=6, stop_token_ids=())))
    je = _jax_engine(**kw)
    want, _ = _drain(je, requests)
    eng = _engine(**kw)
    toks, fins = _drain(eng, requests)
    assert toks == want and fins["c"] == "stop" and _text(toks["c"]) in CHOICES
    assert eng.stats.structured_chain_stages == 0 and eng.stats.structured_violations == 0
    assert eng._decode_masked_fn is None
    for key in STATS:
        assert getattr(eng.stats, key) == getattr(je.stats, key), key


def test_preemption_mid_chain_stays_conformant():
    """A pool two long constrained generations overcommit: preemption by
    recompute mid-chain, conformant, and the same tokens, finish reasons and
    counts (preemptions included) as the JAX engine's."""
    kw = dict(num_pages=10, max_batch_size=2, enable_prefix_caching=False)
    requests = [("choice-p", TOK.encode("x" * 28), dict(guided_choice=LONG)),
                ("regex-p", TOK.encode("y" * 30), dict(guided_regex=r"[ab]{24}"))]
    je = _jax_engine(**kw)
    want = _drain(je, requests)
    eng = _engine(**kw)
    toks, fins = _drain(eng, requests)
    assert (toks, fins) == want
    assert eng.stats.total_preemptions > 0 and eng.stats.structured_violations == 0
    for key in STATS + ("total_preemptions",):
        assert getattr(eng.stats, key) == getattr(je.stats, key), key
    assert fins == {"choice-p": "stop", "regex-p": "stop"}
    assert _text(toks["choice-p"]) in LONG
    assert re.fullmatch(r"[ab]{24}", _text(toks["regex-p"]))


def test_dense_tables_match_host_automaton():
    g, _ = compile_grammar("choice", CHOICES, TOK, TOK.vocab_size, cache=GrammarCache(1))
    bias, nxt = g.dense_tables()
    assert bias.shape == nxt.shape == (g.n_states, g.vocab_size)
    rng = np.random.default_rng(0)
    for s in range(g.n_states):
        row = np.empty((g.vocab_size,), np.float32)
        g.fill_bias(row, s)
        assert np.array_equal(bias[s], row)
        for tid in list(g.allowed_ids(s)) + rng.integers(0, g.vocab_size, 48).tolist():
            adv = g.advance(s, int(tid))
            assert nxt[s, tid] == (s if adv is None else adv), (s, int(tid))
    assert g.dense_tables() is g.dense_tables()
