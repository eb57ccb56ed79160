"""The port's decode program and pipelined dispatch against the JAX reference
engine, on the CPU, with the reference's defaults on: ``pipeline_decode``,
``pack_overlap`` and ``pipeline_prefill_sample``, at ``pipeline_depth`` 1 and 2.

Both engines serve the same float32 numpy weights (the JAX ``init_params``);
the reference runs its XLA attention. Each case drives both engines through
the same script of requests (mixed ``max_tokens``, a stop token, an abort
in the middle of a chain), step by step: greedy tokens must be identical, and
on MoE models so must the dropped copies of the capacity-einsum path and the
EPLB rebalances. The reference speculates past a stop token with calls in
flight, and those calls route tokens too, so these counts are held equal,
not close. On the CPU the decode program runs eagerly; the CUDA graph that
replays it on the card is held to the eager program by
``tests/test_torch_kernel_gpu.py``.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu.parallel.eplb import EPLBConfig as JaxEPLBConfig
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.decode_program import DecodeBuffers, decode_program
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.ops.paged_attention import paged_attention
from llmd_tpu_torch.parallel.eplb import EPLBConfig

BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
            prefill_chunk=32, enable_prefix_caching=False)
PROMPTS = [list(range(3, 30)), list(range(40, 55)), list(range(100, 140))]
MAX_TOKENS = [9, 4, 13]  # mixed budgets: rows leave the chain at different calls


@functools.cache
def _weights(model: str):
    jcfg = dataclasses.replace(jax_model_config(model), dtype="float32")
    tcfg = dataclasses.replace(get_model_config(model), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _drive(eng, requests, abort=None) -> dict[str, list[int]]:
    """Add ``requests`` [(id, prompt, max_tokens, stop ids)], step until done;
    ``abort = (step, id)`` aborts a request after that step."""
    jax_side = isinstance(eng, JaxEngine)
    for rid, prompt, n, stop in requests:
        sp = (JaxSamplingParams(max_tokens=n, temperature=0.0, stop_token_ids=tuple(stop))
              if jax_side else
              SamplingParams(max_tokens=n, temperature=0.0, stop_token_ids=list(stop)))
        eng.add_request(rid, prompt, sp)
    out = {rid: [] for rid, *_ in requests}
    steps = 0
    while eng.has_work():
        for o in eng.step():
            out[o.request_id].extend(o.new_token_ids)
        steps += 1
        assert steps < 500, "no forward progress"
        if abort is not None and steps == abort[0]:
            eng.abort(abort[1])
    return out


def _pair(model, requests, *, cap=None, eplb=None, abort=None, **kw):
    """(reference outputs, reference stats, port outputs, port engine): both
    engines with the same config, the reference's pipelined defaults unless
    ``kw`` turns them off."""
    jcfg, tcfg, jp, npp = _weights(model)
    if cap is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cap)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cap)
    je = JaxEngine(jcfg, JaxEngineConfig(
        **BASE | kw, attn_impl="reference",
        eplb=None if eplb is None else JaxEPLBConfig(*eplb)), params=jp)
    te = LLMEngine(tcfg, EngineConfig(**BASE | kw, eplb=None if eplb is None
                                      else EPLBConfig(*eplb)),
                   params=tt.params_from_numpy(tcfg, npp), device="cpu")
    ro = _drive(je, requests, abort)
    to = _drive(te, requests, abort)
    return ro, je.stats, to, te


def _requests(stop_at=None):
    """The three prompts with mixed budgets; ``stop_at``: (request index,
    stop token id)."""
    reqs = [(f"req-{i}", p, n, []) for i, (p, n) in enumerate(zip(PROMPTS, MAX_TOKENS))]
    if stop_at is not None:
        i, tok = stop_at
        reqs[i] = (reqs[i][0], reqs[i][1], reqs[i][2], [tok])
    return reqs


def _stop_token(model):
    """A token the reference emits as req-2's 4th-to-6th token, first there."""
    ro, *_ = _pair(model, _requests(), pipeline_decode=False,
                   pipeline_prefill_sample=False)
    first = ro["req-2"]
    return next(t for i, t in enumerate(first) if i >= 3 and t not in first[:i])


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("decode_steps", [1, 4])
def test_pipelined_greedy_matches_reference(decode_steps, depth):
    """tiny: mixed budgets and a stop token mid-call, chained calls in flight
    (the reference's speculated calls past the stop included)."""
    stop = _stop_token("tiny")
    ro, rs, to, te = _pair("tiny", _requests((2, stop)), decode_steps=decode_steps,
                           pipeline_depth=depth)
    assert to == ro
    assert to["req-2"][-1] == stop and len(to["req-2"]) < MAX_TOKENS[2]
    st = te.stats
    assert st.n_chained_dispatches > 0
    assert st.n_decode_dispatches == st.n_decode_calls == rs.n_decode_calls
    assert st.n_chained_dispatches == rs.n_chained_dispatches


def test_pipelined_abort_mid_chain():
    """An abort while calls are in flight: the aborted row's tokens in flight
    are dropped, the other rows continue, as in the reference."""
    reqs = _requests()
    ro, _, to, te = _pair("tiny", reqs, decode_steps=2, abort=(6, "req-0"))
    assert to == ro
    assert len(to["req-0"]) < MAX_TOKENS[0] and len(to["req-2"]) == MAX_TOKENS[2]


def test_pipelined_preemption_and_tight_pool():
    """Preemption by recompute under page pressure, and the tight-pool
    degrade of a multi-step call to a unified step, with the chain on."""
    reqs = [(f"req-{i}", p, 16, []) for i, p in
            enumerate([list(range(1, 30)), list(range(60, 95))])]
    ro, _, to, te = _pair("tiny", reqs, num_pages=10, max_batch_size=2, decode_steps=2)
    assert to == ro and te.stats.total_preemptions > 0
    tight = [("req-0", list(range(1, 20)), 5, [])]
    ro, _, to, _ = _pair("tiny", tight, num_pages=3, max_model_len=24, max_batch_size=1,
                         decode_steps=4)
    assert to == ro


@pytest.mark.parametrize("dispatch", ["sorted", "einsum"])
def test_pipelined_moe_matches_reference(dispatch):
    """tiny-moe on both dispatch paths (einsum at capacity 0.5 with idle
    slots, where copies drop): tokens and dropped copies equal."""
    kw = dict(moe_dispatch=dispatch, decode_steps=4)
    cap = None
    if dispatch == "einsum":
        cap, kw["max_batch_size"] = 0.5, 6
    ro, rs, to, te = _pair("tiny-moe", _requests(), cap=cap, **kw)
    assert to == ro
    assert te.stats.moe_dropped_tokens == rs.moe_dropped_tokens
    assert (te.stats.moe_dropped_tokens > 0) == (dispatch == "einsum")


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_pipelined_eplb_rebalances(decode_steps):
    """EPLB every 2 routed steps with calls in flight: same tokens, same
    number of rebalances (each gathered in place) as the reference."""
    ro, rs, to, te = _pair("tiny-moe", _requests(), eplb=(8, 2, 8),
                           decode_steps=decode_steps)
    assert to == ro
    assert te.stats.eplb_rebalances == rs.eplb_rebalances >= 3


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_pipelined_mla_matches_reference(decode_steps):
    ro, _, to, te = _pair("tiny-mla", _requests(), decode_steps=decode_steps,
                          num_pages=128)
    assert to == ro and te.stats.n_chained_dispatches > 0


def test_pack_buffer_rotation():
    """A host buffer set (pack and results) is handed to a dispatch only
    after every earlier dispatch that used it was processed, at depth 1 and
    2, with chains long enough to wrap the ring several times."""
    _, tcfg, _, npp = _weights("tiny")
    for depth in (1, 2):
        eng = LLMEngine(tcfg, EngineConfig(**BASE, decode_steps=1, pipeline_depth=depth),
                        params=tt.params_from_numpy(tcfg, npp), device="cpu")
        last_user: dict[int, int] = {}
        processed: set[int] = set()
        in_flight = []
        dispatch, process = eng._decode_dispatch, eng._decode_process
        pack, result = eng._pack_buf, eng._result_slot

        def checked(get):
            def wrapped():
                buf = get()
                d = eng.stats.n_decode_dispatches
                key = (get.__name__, id(buf))
                assert last_user.get(key, -1) in processed | {-1}, (key, d)
                last_user[key] = d
                return buf
            return wrapped

        def traced_dispatch(*a, **kw):
            d = eng.stats.n_decode_dispatches
            rec = dispatch(*a, **kw)
            rec["dispatch"] = d
            in_flight.append(len(eng._pending_decode) + 1)
            return rec

        def traced_process(rec):
            process(rec)
            processed.add(rec["dispatch"])

        eng._pack_buf, eng._result_slot = checked(pack), checked(result)
        eng._decode_dispatch, eng._decode_process = traced_dispatch, traced_process
        eng.generate([list(range(3, 20)), list(range(30, 41))],
                     SamplingParams(max_tokens=12, temperature=0.0))
        assert eng.stats.n_decode_dispatches > 3 * (depth + 1)
        assert len({k for k in last_user if k[0] == "_pack_buf"}) == depth + 1
        assert max(in_flight) == depth + 1  # the chain really ran ahead


def test_idle_slots_write_only_the_dump_row():
    """The decode program over a static batch with idle slots: every real
    pool row is bit-equal before and after, except the active row's own
    slots; the idle rows' K/V land in the dump row, the last of the dump
    page, which no page table reaches."""
    _, tcfg, _, npp = _weights("tiny")
    params = tt.params_from_numpy(tcfg, npp)
    P, ps, B, maxp = 8, 8, 4, 4
    cache = tt.init_cache(tcfg, P, ps)
    g = torch.Generator().manual_seed(0)
    cache.copy_(torch.randn(cache.shape, generator=g))
    rows = cache.view(-1, *cache.shape[2:])
    before = rows.clone()
    buf = DecodeBuffers.allocate(B, maxp, torch.device("cpu"))
    # slot 2 live: 10 tokens resident on pages [5, 6], 2 iterations to go
    buf.tokens[2], buf.positions[2], buf.kv_lens[2], buf.steps_left[2] = 7, 10, 11, 2
    buf.page_tables[2, :2] = torch.tensor([5, 6])
    o = decode_program(tcfg, params, cache, buf, 3, g, attn_impl=paged_attention,
                       moe_dispatch_impl=None)
    n = P * ps * tcfg.num_layers
    # positions 10 and 11 on page 6 in every layer, and 12: the frozen row's
    # third iteration writes at its next position, which the next call rewrites
    written = {l * P * ps + 6 * ps + off for l in range(tcfg.num_layers)
               for off in (2, 3, 4)}
    changed = {i for i in range(n) if not torch.equal(rows[i], before[i])}
    assert changed == written
    # the idle rows wrote the dump row, and nothing else of the dump page
    assert not torch.equal(rows[-1], before[-1]) and torch.equal(rows[n:-1], before[n:-1])
    assert o.pos_out.tolist() == [-1, -1, 12, -1] and o.lens_out.tolist() == [1, 1, 13, 1]
    assert o.toks_out[:, [0, 1, 3]].eq(0).all() and o.toks_out[2, 2] == 0  # frozen
