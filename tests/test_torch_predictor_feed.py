"""The latency predictor's training feed of the port's engine and server
(reference ``Sequence.admit_features``, the ``latency_trace`` row at
retirement, ``drain_latency_trace`` and the server's one-second ``POST
/samples``).

- On one script of arrivals, steps, a prefix hit and a one-token request,
  the port engine's rows carry the JAX engine's feature columns with the same
  values, in the same order (the latencies are wall clock: present, or None
  for a one-token request, as there).
- The reference's ``TrainingServer`` receives a port server's rows (as
  ``tests/test_predictor_traces.py`` does for the reference's server); a
  trainer that is down loses that batch and the server keeps serving.
"""

import asyncio
import dataclasses
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models.transformer import init_params as jax_init_params
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models.transformer import params_from_numpy
from tests.conftest import run_async

BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=2,
            prefill_chunk=16, decode_steps=2)
FEATURES = ("kv_usage", "input_len", "queue_depth", "running_requests", "inflight_tokens",
            "prefix_match_pct", "tokens_generated")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(eng, sp_cls):
    """Arrivals in two waves over a batch of 2 (a queue forms), a repeated
    prompt (a prefix hit), and a one-token request; the engine's rows."""
    shared = list(range(3, 40))
    first = [("a", shared, 6), ("b", list(range(50, 70)), 4), ("c", list(range(80, 95)), 5)]
    for rid, p, n in first:
        eng.add_request(rid, p, sp_cls(max_tokens=n, temperature=0.0, ignore_eos=True))
    for _ in range(3):
        eng.step()
    eng.add_request("d", shared + [41, 42], sp_cls(max_tokens=3, temperature=0.0,
                                                    ignore_eos=True))
    eng.add_request("e", list(range(100, 111)), sp_cls(max_tokens=1, temperature=0.0,
                                                       ignore_eos=True))
    while eng.has_work():
        eng.step()
    return eng.drain_latency_trace()


def test_feature_columns_equal_the_jax_engines():
    jcfg = dataclasses.replace(jax_model_config("tiny"), dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    je = JaxEngine(jcfg, JaxEngineConfig(**BASE, attn_impl="reference"), params=jp)
    tcfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    te = LLMEngine(tcfg, EngineConfig(**BASE), device="cpu",
                   params=params_from_numpy(tcfg, {k: np.asarray(v) for k, v in jp.items()}))
    want, got = _script(je, JaxSamplingParams), _script(te, SamplingParams)
    assert len(got) == len(want) == 5
    assert [{k: r[k] for k in FEATURES} for r in got] == [
        {k: r[k] for k in FEATURES} for r in want]
    assert [r["tpot_ms"] is None for r in got] == [r["tpot_ms"] is None for r in want]
    assert all(r["ttft_ms"] >= 0 for r in got) and set(got[0]) == set(want[0])
    # the script exercised every feature: a queue, a prefix hit, running rows
    assert max(r["queue_depth"] for r in got) > 0 and max(r["prefix_match_pct"] for r in got) > 0
    assert max(r["running_requests"] for r in got) > 0 and max(r["kv_usage"] for r in got) > 0
    assert te.drain_latency_trace() == []  # drained


def test_reference_training_server_receives_port_rows(tmp_path):
    """Port server --POST /samples (urllib, once a second)--> the reference's
    TrainingServer; then the trainer goes away and a batch is dropped while
    the server keeps answering."""
    from llmd_tpu.predictor.server import TrainingServer

    async def scenario():
        loop = asyncio.get_running_loop()
        trainer = TrainingServer(str(tmp_path / "m.pkl"), retrain_interval_s=0.2)
        await trainer.start()
        srv = EngineServer(get_model_config("tiny"), EngineConfig(**BASE), model_name="m",
                           host="127.0.0.1", port=0, device="cpu",
                           predictor_train_url=f"http://{trainer.address}")
        srv.start()

        def complete(i: int) -> int:
            body = json.dumps({"prompt": f"count to ten please {i}", "max_tokens": 4,
                               "temperature": 0.0, "ignore_eos": True}).encode()
            req = urllib.request.Request(f"http://{srv.address}/v1/completions", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status

        try:
            for i in range(3):
                assert await loop.run_in_executor(None, complete, i) == 200
            for _ in range(80):  # the feed posts once a second
                if len(trainer.window) >= 3:
                    break
                await asyncio.sleep(0.1)
            assert len(trainer.window) >= 3
            await trainer.stop()
            assert await loop.run_in_executor(None, complete, 9) == 200
            for _ in range(100):  # the feed drains the row; its post fails; dropped
                if not srv.engine.latency_trace:
                    break
                await asyncio.sleep(0.05)
            assert not srv.engine.latency_trace
            assert await loop.run_in_executor(None, complete, 10) == 200
        finally:
            await loop.run_in_executor(None, srv.stop)
            await trainer.stop()

    run_async(scenario())
