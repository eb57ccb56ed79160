"""The port's latency plane against the reference's, on the CPU: the
predictor (``predictor/``), the latency plugins, the SLO engine and the
flow-control calibrator.

- **The regressor.** ``predictor/gbdt.py`` against scikit-learn's
  ``HistGradientBoostingRegressor`` with the reference's parameters on three
  seeded sets (the synthetic world of ``tests/test_predictor.py``, integer
  features with at most 255 distinct values, continuous features with more):
  predictions on the training rows and on a fresh grid agree to rtol 1e-4,
  and ``LatencyModel``'s holdout MAPE to 1e-4. Above 10,000 rows early
  stopping runs on both sides and the holdout MAPE agrees within 0.02 (the
  reference's validation split is unseeded).
- **The window.** Bucket keys and snapshot order equal the reference's.
- **The sidecars.** The port's ``TrainingServer`` and ``PredictionServer``
  and the reference's, started here, answer one script with the same codes,
  bodies and ``/metrics`` lines; the sidecar client's failover and
  heuristic fill.
- **The plugins.** The four latency plugins and the predictor-gated P/D
  decider inside a scheduler: picks, scores, filter drops, admit decisions,
  P/D decisions, request state and the producer's metric lines equal the
  reference's under one seed and one fake clock, both sides fed the same
  predictions by a stub predictor.
- **SLO.** ``SLOEngine`` attainment, burn rate and breaches under one fake
  clock, with tenant overrides from the environment.
- **Calibrator.** Its functions and its CLI's stdout.
"""

import asyncio
import contextlib
import dataclasses
import io
import json
import random
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from sklearn.ensemble import HistGradientBoostingRegressor as SkRegressor
from threadpoolctl import threadpool_limits

import llmd_tpu.core.request as ref_request_mod
import llmd_tpu.router.scorers as ref_scorers_mod
import llmd_tpu_torch.core.request as port_request_mod
import llmd_tpu_torch.router.scorers as port_scorers_mod
from llmd_tpu.core import config as ref_config
from llmd_tpu.core import endpoint as ref_endpoint
from llmd_tpu.core.request import InferenceRequest as RefRequest
from llmd_tpu.core.request import SamplingParams as RefSampling
from llmd_tpu.obs import slo as ref_slo
from llmd_tpu.predictor import client as ref_client
from llmd_tpu.predictor import model as ref_model
from llmd_tpu.predictor import server as ref_server
from llmd_tpu.router import calibrator as ref_cal
from llmd_tpu.router import latency_plugins as ref_lp  # noqa: F401 (registers them)
from llmd_tpu.router.scheduler import Scheduler as RefScheduler
from llmd_tpu_torch import router as _port_router  # noqa: F401 (registers the plugins)
from llmd_tpu_torch.core import config as port_config
from llmd_tpu_torch.core import endpoint as port_endpoint
from llmd_tpu_torch.core.metrics_contract import StdMetric
from llmd_tpu_torch.core.request import InferenceRequest as PortRequest
from llmd_tpu_torch.core.request import SamplingParams as PortSampling
from llmd_tpu_torch.obs import slo as port_slo
from llmd_tpu_torch.predictor import client as port_client
from llmd_tpu_torch.predictor import gbdt
from llmd_tpu_torch.predictor import model as port_model
from llmd_tpu_torch.predictor import server as port_server
from llmd_tpu_torch.router import calibrator as port_cal
from llmd_tpu_torch.router import latency_plugins as port_lp
from llmd_tpu_torch.router.http import HTTPClient
from llmd_tpu_torch.router.scheduler import Scheduler as PortScheduler
from tests.conftest import run_async

SK_KW = dict(max_iter=100, max_depth=6, learning_rate=0.1, min_samples_leaf=4)


@pytest.fixture(autouse=True)
def one_openmp_thread():
    """scikit-learn's OpenMP threads spin against the other test workers (a
    1,500-row fit took 48 s with 8 threads on an 8-CPU host busy with other
    workers, 0.5 s on one thread); the fit's result does not depend on the
    thread count. The limit is per thread: it holds the fits and predictions
    this test's own thread runs, not a fit that a ``TrainingServer`` runs in
    its loop's executor (``_one_thread_fits`` holds those)."""
    with threadpool_limits(1):
        yield


def _one_thread_fits(trainer) -> None:
    """Wrap ``trainer.model.fit`` so the fit enters the one-thread OpenMP limit
    itself, in the executor thread that ``retrain_now`` runs it on."""
    fit = trainer.model.fit

    def fit_on_one_thread(samples):
        with threadpool_limits(1):
            return fit(samples)

    trainer.model.fit = fit_on_one_thread


# -- the seeded sets -------------------------------------------------------------
def _world_ttft(s) -> float:
    """tests/test_predictor.py's ground truth."""
    return (0.4 * s.input_len * (1 - s.prefix_match_pct) + 80.0 * s.queue_depth
            + 300.0 * max(0.0, s.kv_usage - 0.7) + 10.0)


def _world(mod, rng, n):
    """tests/test_predictor.py's synthetic world, as ``mod``'s samples."""
    out = []
    for _ in range(n):
        s = mod.LatencySample(
            kv_usage=float(rng.uniform(0, 1)), input_len=float(rng.integers(16, 2048)),
            queue_depth=float(rng.integers(0, 20)),
            running_requests=float(rng.integers(0, 16)),
            prefix_match_pct=float(rng.uniform(0, 1)),
            inflight_tokens=float(rng.integers(0, 4096)))
        s.ttft_ms = _world_ttft(s) * float(rng.normal(1.0, 0.02))
        s.tpot_ms = (5.0 + 2.5 * s.running_requests) * float(rng.normal(1.0, 0.02))
        out.append(s)
    return out


def _integers(mod, rng, n):
    """Every feature an integer with at most 200 distinct values: midpoint bins."""
    X = rng.integers(0, 200, (n, 7)).astype(float)
    out = []
    for row in X:
        s = mod.LatencySample(*row[:7])
        s.ttft_ms = float(2 * row[1] + 30 * np.sin(row[2]) + 50 * (row[3] > 100)
                          + rng.normal(0, 1))
        s.tpot_ms = float(5 + 0.1 * row[3] + (row[6] % 7) + rng.normal(0, 0.1))
        out.append(s)
    return out


def _continuous(mod, rng, n):
    """Every feature continuous, far more than 255 distinct values: percentile bins."""
    X = rng.standard_normal((n, 7)) * [0.3, 500, 5, 4, 0.3, 900, 20] + [0.5, 1000, 8, 6,
                                                                          0.5, 2000, 50]
    out = []
    for row in X:
        s = mod.LatencySample(*map(float, row))
        s.ttft_ms = float(np.abs(row[1]) * (1.2 - row[4]) + 40 * np.tanh(row[2])
                          + rng.normal(0, 5))
        s.tpot_ms = float(5 + np.abs(row[3]) + 0.01 * row[6] ** 2 + rng.normal(0, 0.2))
        out.append(s)
    return out


SETS = {"world": (_world, 2000), "integers": (_integers, 1500),
        "continuous": (_continuous, 3000)}


def _pair(name, seed, n=None):
    make, size = SETS[name]
    n = n or size
    return (make(ref_model, np.random.default_rng(seed), n),
            make(port_model, np.random.default_rng(seed), n))


@pytest.mark.parametrize("name", sorted(SETS))
def test_latency_model_matches_scikit_learn(name):
    """``LatencyModel.fit`` on the same samples: every regressor's predictions
    on the training rows and on a fresh grid, and the holdout MAPE, equal the
    reference's (scikit-learn's fit) to 1e-4."""
    ref_s, port_s = _pair(name, 0)
    ref, port = ref_model.LatencyModel(), port_model.LatencyModel()
    assert ref.fit(ref_s) and port.fit(port_s)
    assert (port.version, port.train_count) == (ref.version, ref.train_count) == (1, 1)
    for k in ("ttft", "tpot"):
        assert abs(port.mape[k] - ref.mape[k]) <= 1e-4, (k, port.mape, ref.mape)
    grid_ref, grid_port = _pair(name, 1, 300)
    for rs, ps in ((ref_s, port_s), (grid_ref, grid_port)):
        want = np.asarray(ref.predict(rs))
        got = np.asarray(port.predict(ps))
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert port.ttft.n_iter_ == ref.ttft.n_iter_ == 100
    # the raw regressor on one feature matrix, without the holdout and the clamp
    X = np.asarray([port_model.ttft_features(s) for s in port_s])
    y = np.asarray([s.ttft_ms for s in port_s])
    Xg = np.asarray([port_model.ttft_features(s) for s in grid_port])
    sk = SkRegressor(**SK_KW).fit(X, y)
    ours = gbdt.HistGradientBoostingRegressor(**SK_KW).fit(X, y)
    for XX in (X, Xg):
        np.testing.assert_allclose(ours.predict(XX), sk.predict(XX), rtol=1e-4)


def test_regressor_with_missing_values_matches_scikit_learn():
    """NaN features (a JSON ``NaN`` from a client): the missing-values bin,
    the right-to-left scan that sends it left, and prediction's NaN branch."""
    rng = np.random.default_rng(9)
    samples = _pair("world", 9, 1200)[1]
    X = np.asarray([port_model.ttft_features(s) for s in samples])
    y = np.asarray([s.ttft_ms for s in samples])
    X[rng.uniform(size=X.shape) < 0.15] = np.nan
    y += np.isnan(X[:, 2]) * 300.0  # a missing queue depth costs as a deep queue
    grid = X[rng.permutation(len(X))[:300]]
    sk = SkRegressor(**SK_KW).fit(X, y)
    ours = gbdt.HistGradientBoostingRegressor(**SK_KW).fit(X, y)
    for XX in (X, grid):
        np.testing.assert_allclose(ours.predict(XX), sk.predict(XX), rtol=1e-4)


def test_bin_thresholds_match_scikit_learn():
    from sklearn.ensemble._hist_gradient_boosting.binning import _find_binning_thresholds

    rng = np.random.default_rng(3)
    for col in (rng.integers(0, 50, 400).astype(float), rng.standard_normal(5000),
                np.r_[np.zeros(300), rng.uniform(0, 1, 700)], np.ones(10),
                np.r_[rng.standard_normal(900), [np.nan] * 20]):
        np.testing.assert_array_equal(gbdt.bin_thresholds(col, 255),
                                      _find_binning_thresholds(col, 255))


def test_early_stopping_above_10000_rows():
    """12,000 rows: 10,800 fit, early stopping on for both; the validation
    split is drawn from an explicit generator here and from an unseeded one
    in scikit-learn, so the holdout MAPE is held within 0.02."""
    ref_s, port_s = _pair("world", 5, 12000)
    np.random.seed(0)  # scikit-learn's random_state=None draws from numpy's global state
    ref = ref_model.LatencyModel()
    port = port_model.LatencyModel(rng=np.random.default_rng(0))
    assert ref.fit(ref_s) and port.fit(port_s)
    assert len(port.ttft.validation_score_) >= 2 and ref.ttft.do_early_stopping_
    for k in ("ttft", "tpot"):
        assert abs(port.mape[k] - ref.mape[k]) <= 0.02, (k, port.mape, ref.mape)


def test_save_and_load_round_trip(tmp_path):
    _, port_s = _pair("integers", 2, 200)
    m = port_model.LatencyModel()
    assert m.fit(port_s)
    m.save(tmp_path / "m.pkl")
    back = port_model.LatencyModel.load(tmp_path / "m.pkl")
    assert back.version == m.version and back.mape == m.mape
    assert back.predict(port_s[:5]) == m.predict(port_s[:5])
    assert not port_model.LatencyModel().fit(port_s[:31])  # MIN_SAMPLES


def test_window_buckets_and_snapshot_order():
    rng = np.random.default_rng(4)
    ref_w, port_w = ref_model.StratifiedWindow(3), port_model.StratifiedWindow(3)
    for _ in range(200):
        kv, ph = float(rng.choice([0.0, 0.05, 0.35, 0.99, 1.0])), float(rng.uniform(0, 1))
        x = float(rng.integers(0, 1000))
        ref_w.add(ref_model.LatencySample(kv_usage=kv, prefix_match_pct=ph, input_len=x))
        port_w.add(port_model.LatencySample(kv_usage=kv, prefix_match_pct=ph, input_len=x))
    assert list(port_w.buckets) == list(ref_w.buckets)
    assert [dataclasses.asdict(s) for s in port_w.snapshot()] == \
           [dataclasses.asdict(s) for s in ref_w.snapshot()]
    assert len(port_w) == len(ref_w)
    s = port_model.LatencySample(input_len=100, prefix_match_pct=0.5, queue_depth=2,
                                 kv_usage=0.95, inflight_tokens=50, running_requests=3)
    r = ref_model.LatencySample(**dataclasses.asdict(s))
    assert port_model.heuristic_latency(s) == ref_model.heuristic_latency(r)


def test_local_predictor_matches_reference():
    ref_s, port_s = _pair("world", 6, 400)
    ref = ref_client.LocalPredictor(retrain_interval_s=1e9)
    port = port_client.LocalPredictor(retrain_interval_s=1e9)
    ref._last_fit = port._last_fit = float("inf")  # no background fit
    assert port.predict(port_s[:2]) is None and ref.predict(ref_s[:2]) is None
    for a, b in zip(ref_s, port_s):
        ref.record(a), port.record(b)
    assert ref.fit_now() and port.fit_now()
    np.testing.assert_allclose(port.predict(port_s[:20]), ref.predict(ref_s[:20]), rtol=1e-4)


# -- the sidecars ----------------------------------------------------------------
async def _sidecar_script(mod, cli_mod, model_mod, tmp_path, tag):
    """One script against a training and a prediction server of ``mod``:
    (method, route, status, content type, body) of every step, then the
    sidecar client of ``cli_mod`` over a dead and a live replica."""
    path = str(tmp_path / f"{tag}.pkl")
    trainer = mod.TrainingServer(path, port=0, retrain_interval_s=3600)
    _one_thread_fits(trainer)
    pred = mod.PredictionServer(path, port=0, reload_interval_s=0.0)
    await trainer.start()
    await pred.start()
    rows = [s.__dict__ for s in _world(port_model, np.random.default_rng(1), 200)]
    client = HTTPClient()
    out = []

    async def call(method, addr, route, body=None, raw=None):
        r = await client.request(method, f"http://{addr}{route}", json_body=body, body=raw)
        data = await r.read()
        out.append((method, route, r.status, r.content_type, data))

    try:
        t, p = trainer.address, pred.address
        await call("POST", p, "/predict", {"samples": rows[:2]})  # not ready: 503
        await call("GET", p, "/health")
        await call("GET", t, "/health")
        await call("GET", t, "/metrics")
        await call("POST", t, "/samples", raw=b"{not json")
        await call("POST", t, "/samples", {"samples": rows})
        await call("GET", t, "/model/info")
        out.append(("retrain", await trainer.retrain_now()))
        await call("GET", t, "/model/info")
        await call("GET", t, "/metrics")
        await call("POST", p, "/predict", {"samples": rows[:4]})
        await call("POST", p, "/predict", raw=b"")
        await call("GET", p, "/health")
        await call("GET", p, "/metrics")
        await call("GET", p, "/nope")
        # the sidecar client: the first replica is down, the second answers
        cli = cli_mod.SidecarPredictorClient(["http://127.0.0.1:9", f"http://{p}"],
                                             train_url=f"http://{t}")
        cli.timeout_s = 5.0  # a loaded CPU, not a slow replica
        samples = _world(model_mod, np.random.default_rng(2), 3)
        loop = asyncio.get_running_loop()
        got = await loop.run_in_executor(None, cli.predict, samples)
        out.append(("client", got, cli.failures))
        dead = cli_mod.SidecarPredictorClient(["http://127.0.0.1:9"])
        out.append(("dead", await loop.run_in_executor(None, dead.predict, samples),
                    dead.failures))
    finally:
        await client.close()
        await trainer.stop()
        await pred.stop()
    return out


def test_sidecar_servers_answer_as_the_reference(tmp_path):
    ref = run_async(_sidecar_script(ref_server, ref_client, ref_model, tmp_path, "ref"))
    port = run_async(_sidecar_script(port_server, port_client, port_model, tmp_path, "port"))
    assert [s[:4] for s in port if len(s) == 5] == [s[:4] for s in ref if len(s) == 5]
    for a, b in zip(port, ref):
        if len(a) == 5 and a[1] != "/predict":
            assert a[4] == b[4], (a, b)
        elif len(a) == 5:  # predictions to rounding of the two fits
            pa, pb = json.loads(a[4]), json.loads(b[4])
            if pa.get("predictions") and pb.get("predictions"):
                for x, y in zip(pa["predictions"], pb["predictions"]):
                    assert x.keys() == y.keys()
                    np.testing.assert_allclose(list(x.values()), list(y.values()),
                                               rtol=1e-4)
            else:
                assert pa == pb
        else:
            assert a[0] == b[0] and a[-1] == b[-1]
            if a[0] == "client":
                np.testing.assert_allclose(a[1], b[1], rtol=1e-4)
    assert port[-1] == ("dead", None, 1) and port[-2][2] == 0


def test_client_round_robin_draws_from_its_rng():
    """The first replica tried is ``rng.randrange(n)`` (the reference's
    global ``random``): the same seed, the same order of URLs."""
    tried = {"ref": [], "port": []}
    for mod, key in ((ref_client, "ref"), (port_client, "port")):
        cli = mod.SidecarPredictorClient([f"http://u{i}" for i in range(5)])
        cli._post = lambda url, payload, timeout, k=key: tried[k].append(url)
        random.seed(7)
        if key == "port":
            cli.rng = random.Random(7)
        for _ in range(4):
            cli.predict([mod.LatencySample()])
    assert tried["port"] == tried["ref"] and len(tried["ref"]) == 20


# -- the plugins in a scheduler ----------------------------------------------------
LATENCY_CFG = """
plugins:
  - {name: prefix-producer, type: approx-prefix-cache-producer, params: {blockSize: 4}}
  - {name: latency, type: predicted-latency-producer, params: {streamingMode: STREAMING}}
  - {name: tier, type: slo-headroom-tier-filter, params: {exploreNegativeProb: 0.3}}
  - {name: admit, type: latency-slo-admitter}
  - {name: lat-least, type: latency-scorer}
  - {name: lat-most, type: latency-scorer, params: {headroomSelectionStrategy: most}}
  - {name: prefill-filter, type: prefill-endpoints-filter}
  - {name: decode-filter, type: decode-endpoints-filter}
  - {name: prefix, type: prefix-cache-scorer}
  - {name: queue, type: queue-depth-scorer}
  - {name: picker, type: max-score-picker}
  - {name: weighted, type: weighted-random-picker}
profileHandler: PROFILE_HANDLER
disaggregation: {uncachedSuffixThreshold: 8}
schedulingProfiles:
  - name: prefill
    plugins:
      - {pluginRef: prefill-filter}
      - {pluginRef: tier}
      - {pluginRef: lat-least, weight: 2}
      - {pluginRef: queue, weight: 1}
      - {pluginRef: picker}
  - name: decode
    plugins:
      - {pluginRef: decode-filter}
      - {pluginRef: tier}
      - {pluginRef: lat-most, weight: 2}
      - {pluginRef: prefix, weight: 1}
      - {pluginRef: weighted}
  - name: default
    plugins:
      - {pluginRef: tier}
      - {pluginRef: lat-least, weight: 3}
      - {pluginRef: queue, weight: 1}
      - {pluginRef: weighted}
"""


class StubPredictor:
    """The same predictions to both packages: a fixed function of the
    sample's features, None (the producer's fallback) when asked about a
    pod with queue depth 15; what it was told to record."""

    def __init__(self) -> None:
        self.recorded = []

    def predict(self, samples):
        if any(s.queue_depth == 15.0 for s in samples):
            return None
        return [(0.3 * s.input_len * (1 - s.prefix_match_pct) + 40.0 * s.queue_depth
                 + 500.0 * s.kv_usage, 4.0 + 3.0 * s.running_requests) for s in samples]

    def record(self, sample):
        self.recorded.append(dataclasses.asdict(sample))


class Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for mod in (ref_scorers_mod, port_scorers_mod, ref_request_mod, port_request_mod,
                ref_endpoint, port_endpoint):
        monkeypatch.setattr(mod, "time", c)
    return c


def _state(req) -> dict:
    """Request state with each package's samples as plain dicts."""
    out = {}
    for k, v in req.state.items():
        if k == "latency_samples":
            v = {a: dataclasses.asdict(s) for a, s in v.items()}
        out[k] = v
    return out


def _outcome(res) -> dict:
    def addr(ep):
        return ep.address if ep is not None else None

    return {"endpoint": addr(res.endpoint), "prefill": addr(res.prefill_endpoint),
            "rejected": res.rejected, "pd": res.pd,
            "profiles": {n: (addr(r.endpoint), {e.address: s for e, s in r.scores.items()})
                         for n, r in res.profiles.items()}}


_attrs = st.tuples(st.sampled_from([0.0, 2.0, 7.0, 15.0]),
                   st.sampled_from([0.0, 0.25, 0.5, 0.97]),
                   st.sampled_from([0.0, 1.0, 4.0]))
_step = st.tuples(st.text("abcxyz ", min_size=0, max_size=40),
                  st.sampled_from([None, 50.0, 200.0, 2000.0]),
                  st.sampled_from([None, 6.0, 20.0]), st.sampled_from([0, -1]),
                  st.integers(1, 64), st.booleans(),
                  st.lists(_attrs, min_size=4, max_size=4))


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(roles=st.lists(st.sampled_from(["both", "prefill", "decode"]), min_size=1, max_size=4),
       disagg=st.booleans(), streaming=st.booleans(), seed=st.integers(0, 2**32 - 1),
       steps=st.lists(_step, min_size=1, max_size=8))
def test_latency_plugins_match_reference(clock, roles, disagg, streaming, seed, steps):
    text = (LATENCY_CFG.replace("STREAMING", str(streaming).lower())
            .replace("PROFILE_HANDLER", "disagg-profile-handler" if disagg
                     else "single-profile-handler"))
    if not disagg:
        text = text.replace("  - name: prefill", "  - name: unused-prefill").replace(
            "  - name: decode", "  - name: unused-decode")
    pools = ref_endpoint.EndpointPool(), port_endpoint.EndpointPool()
    for i, role in enumerate(roles):
        pools[0].upsert(ref_endpoint.Endpoint(address=f"10.0.0.{i}:8000",
                                              role=ref_endpoint.EndpointRole(role)))
        pools[1].upsert(port_endpoint.Endpoint(address=f"10.0.0.{i}:8000",
                                               role=port_endpoint.EndpointRole(role)))
    stubs = StubPredictor(), StubPredictor()
    ref = RefScheduler(ref_config.FrameworkConfig.from_yaml(text), pools[0],
                       {"latency_predictor": stubs[0]})
    port = PortScheduler(port_config.FrameworkConfig.from_yaml(text), pools[1],
                         {"latency_predictor": stubs[1]}, seed=seed)
    random.seed(seed)  # the reference draws from the global random
    for n, (prompt, slo_ttft, slo_tpot, prio, max_tokens, post, attrs) in enumerate(steps):
        clock.t += 1.0
        for pool in pools:
            for ep, (queue, kv, running) in zip(pool.list(), attrs):
                ep.attrs.put(StdMetric.QUEUED_REQUESTS, queue)
                ep.attrs.put(StdMetric.KV_UTILIZATION, kv)
                ep.attrs.put(StdMetric.RUNNING_REQUESTS, running)
        kw = dict(request_id=f"r{n}", model="m", prompt="the shared prefix " + prompt,
                  priority=prio, slo_ttft_ms=slo_ttft, slo_tpot_ms=slo_tpot)
        rreq = RefRequest(sampling=RefSampling(max_tokens=max_tokens), **kw)
        preq = PortRequest(sampling=PortSampling(max_tokens=max_tokens), **kw)
        want, got = ref.schedule(rreq), port.schedule(preq)
        assert _outcome(got) == _outcome(want), n
        assert _state(preq) == _state(rreq), n
        if post and want.endpoint is not None:
            info = {"status": 200, "ttft_ms": 30.0 + n, "itl_ms": 5.0, "e2e_ms": 90.0 + n,
                    "usage": {"completion_tokens": max_tokens}}
            ref.post_response(rreq, want.endpoint, dict(info))
            port.post_response(preq, got.endpoint, dict(info))
    assert port.metrics == ref.metrics
    assert stubs[1].recorded == stubs[0].recorded
    assert port.plugins["latency"].prometheus_lines() == ref.plugins["latency"].prometheus_lines()


def test_plugins_alone_match_reference():
    """Each plugin outside a scheduler on hand-set predictions: the scorer's
    both strategies and the no-SLO ranking, the tier filter's tiers (a
    headroom of exactly 0 counts as negative, as the reference's
    ``(h or -1) >= 0``), the admitter's shed."""
    preds = {"a:1": (100.0, 5.0), "b:1": (300.0, 10.0), "c:1": (200.0, 10.0)}
    cases = [dict(), dict(slo_ttft_ms=200.0), dict(slo_ttft_ms=150.0, slo_tpot_ms=8.0),
             dict(slo_ttft_ms=50.0, priority=-1), dict(slo_ttft_ms=100.0, priority=-1),
             dict(slo_ttft_ms=400.0, priority=-1)]
    for kw in cases:
        outs = []
        for ep_mod, req_cls, samp, lp in (
                (ref_endpoint, RefRequest, RefSampling, ref_lp),
                (port_endpoint, PortRequest, PortSampling, port_lp)):
            eps = [ep_mod.Endpoint(address=a) for a in preds]
            req = req_cls(request_id="r", sampling=samp(max_tokens=10), **kw)
            req.state["predicted_latency"] = dict(preds)
            tier = lp.SLOHeadroomTierFilter(exploreNegativeProb=0.0)
            outs.append((
                {e.address: s for e, s in lp.LatencyScorer().score(req, eps).items()},
                {e.address: s for e, s in lp.LatencyScorer("most").score(req, eps).items()},
                [e.address for e in tier.filter(req, eps)],
                lp.LatencySLOAdmitter().admit(req, eps),
                [lp.slo_headroom_ms(req, p) for p in preds.values()],
                [lp.predicted_e2e_ms(req, p) for p in preds.values()]))
        assert outs[1] == outs[0], kw


# -- SLO -------------------------------------------------------------------------
class Counter:
    def __init__(self) -> None:
        self.n: dict = {}

    def labels(self, **kv):
        key = tuple(sorted(kv.items()))

        class Inc:
            def inc(inner, v=1.0):
                self.n[key] = self.n.get(key, 0) + v

        return Inc()


def test_slo_engine_matches_reference():
    env = {"LLMD_SLO_TTFT_MS": "200", "LLMD_SLO_E2E_MS": "2000", "LLMD_SLO_TARGET": "0.95",
           "LLMD_SLO_TENANT_OVERRIDES": "gold:ttft_ms=100,target=0.999;bronze:e2e_ms=10000;"
                                        "bad;:x=1;silver:ttft_ms=oops,target=2"}
    t = [5000.0]
    engines = [mod.SLOEngine.from_env(env, now_fn=lambda: t[0]) for mod in (ref_slo, port_slo)]
    for e in engines:
        e.breach_counter = Counter()
    assert [e.enabled for e in engines] == [True, True]
    assert {k: (c.ttft_ms, c.e2e_ms, c.target) for k, c in engines[1].overrides.items()} == \
           {k: (c.ttft_ms, c.e2e_ms, c.target) for k, c in engines[0].overrides.items()}
    rng = np.random.default_rng(8)
    for step in range(400):
        t[0] += float(rng.choice([0.5, 7.0, 61.0, 400.0]))
        tenant = str(rng.choice(["anon", "gold", "bronze", "silver"]))
        obj = str(rng.choice(["ttft", "e2e"]))
        lat = float(rng.uniform(0.0, 3.0))
        assert engines[1].observe(tenant, obj, lat) == engines[0].observe(tenant, obj, lat)
        if step % 25 == 0:
            for kind in ("attainment", "burn"):
                assert engines[1].gauge_samples(kind) == engines[0].gauge_samples(kind)
    assert engines[1].breach_counter.n == engines[0].breach_counter.n
    t[0] += 7200.0  # every series idles past the long window: pruned
    assert engines[1].gauge_samples("burn") == engines[0].gauge_samples("burn") == []
    off = port_slo.SLOEngine.from_env({})
    assert not off.enabled and not off.observe("anon", "ttft", 9.0)


# -- calibrator ----------------------------------------------------------------
CAL_ARGS = [
    ["--throughput", "20", "--latency-sec", "4", "--num-pages", "8192", "--isl-mean", "1024",
     "--osl-mean", "256"],
    ["--throughput", "3.5", "--latency-sec", "12.5", "--num-pages", "500", "--page-size",
     "32", "--isl-mean", "3000", "--isl-std", "100", "--osl-mean", "900", "--osl-std", "10",
     "--shared-prefix", "400", "--bands", "0:1,10:3,-5", "--z-score", "3",
     "--queue-factor", "1.5", "--mean-request-bytes", "9000"],
    ["--throughput", "0", "--latency-sec", "1", "--num-pages", "1", "--isl-mean", "0",
     "--osl-mean", "0", "--no-prefix-caching", "--max-num-batched-tokens", "8192"],
]


@pytest.mark.parametrize("argv", CAL_ARGS, ids=["default", "bands", "degenerate"])
def test_calibrator_cli_prints_the_references_json(monkeypatch, argv):
    outs = []
    for mod in (ref_cal, port_cal):
        monkeypatch.setattr(sys, "argv", ["calibrator", *argv])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    assert json.loads(outs[1])["flowControl"]["enabled"] is True


def test_calibrator_functions_match_reference():
    res = []
    for cal, cfg in ((ref_cal, ref_config), (port_cal, port_config)):
        cap = cal.EngineCapacity(num_pages=4096, shared_prefix_tokens=256)
        wl = cal.WorkloadObservation(throughput_rps=12.0, latency_s=3.0, isl_mean=800,
                                     osl_mean=200, isl_osl_correlation=0.3)
        c = cal.calibrate(cap, wl, bands=[cfg.PriorityBandSpec(priority=p, name=f"b{p}")
                                          for p in (0, 5)], band_weights={5: 2.0})
        res.append((cal.compute_constraint(7.3, 2.1), cal.memory_constraint(cap, wl, 1.5),
                    cal.lookahead_buffer(40, 2048, 300.0), cal.lookahead_buffer(3, 2048, None),
                    c.compute_limit, c.memory_limit, c.lookahead_buffer, c.footprint_cv,
                    c.binding_constraint, c.concurrency_limit,
                    [dataclasses.asdict(b) for b in c.spec.bands]))
    assert res[1] == res[0]


def test_latency_configs_of_the_readme_and_the_card_phase_load():
    """The README's ``latency.yaml`` and the card phase's three router
    configs read as ``yaml.safe_load`` reads them and build the same plugin
    graph as the reference's scheduler."""
    import re
    from pathlib import Path

    import yaml

    import chip_smoke

    readme = (Path(__file__).resolve().parent.parent / "README.md").read_text()
    m = re.search(r"cat > latency\.yaml <<'YAML'\n(.*?)\nYAML\n", readme, re.S)
    assert m, "README's latency.yaml block"
    texts = [m.group(1), chip_smoke._latency_cfg("http://127.0.0.1:8011", "http://h:8010"),
             chip_smoke._pd_router_cfg("http://127.0.0.1:8011"), chip_smoke._plane_cfg(6379)]
    for text in texts:
        assert port_config.load_yaml(text) == yaml.safe_load(text)
        port = PortScheduler(port_config.FrameworkConfig.from_yaml(text),
                             port_endpoint.EndpointPool())
        ref = RefScheduler(ref_config.FrameworkConfig.from_yaml(text),
                           ref_endpoint.EndpointPool())
        assert {n: type(p).__name__ for n, p in port.plugins.items()} == \
               {n: type(p).__name__ for n, p in ref.plugins.items()}
        assert port.handler == ref.handler
    producer = PortScheduler(port_config.FrameworkConfig.from_yaml(texts[1]),
                             port_endpoint.EndpointPool()).plugins["latency"]
    assert producer.predictor.predict_urls == ["http://127.0.0.1:8011"]
    assert producer.predictor.train_url == "http://h:8010"
