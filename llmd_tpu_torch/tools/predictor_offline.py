"""The offline mode of ``predictor_accuracy`` (port of the offline half of
``tools/predictor_accuracy.py``): the reference's multi-regime workload served
on the port's engine, the port's GBDT fitted on the engine's latency trace,
the reference's artifact. Run through ``python -m
llmd_tpu_torch.tools.predictor_accuracy [--cpu] [--reps N] [--model M] [--out F]``;
``chip_smoke.py``'s ``tools`` phase calls :func:`offline` on the card.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine.config import EngineConfig
from llmd_tpu_torch.engine.engine import LLMEngine, resolve_device
from llmd_tpu_torch.models import resolve_model
from llmd_tpu_torch.predictor.model import LatencyModel
from llmd_tpu_torch.predictor.server import sample_from_dict


def offline(model: str = "tiny", cpu: bool = False, reps: int = 12,
            out_path: str = "PREDICTOR_ACCURACY.json", seed: int = 0) -> dict:
    """Serve the reference's four regimes ``reps`` times on the port's engine
    (random weights from ``seed`` for a registry name), fit the GBDT on the
    engine's latency trace and write the artifact to ``out_path``. The card
    unless ``cpu``: with no card and no ``cpu`` the engine raises."""
    device = resolve_device("cpu" if cpu else None)
    cfg, params = resolve_model(model)
    eng = LLMEngine(cfg, EngineConfig(page_size=8, num_pages=512,
                                      max_model_len=512, max_batch_size=8,
                                      prefill_chunk=64), params=params, seed=seed,
                    device=device)
    sp = SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True)
    rng = np.random.default_rng(0)
    rid = 0
    t0 = time.monotonic()

    def burst(n_reqs: int, prompt_len: int, shared: bool) -> None:
        nonlocal rid
        base = [int(t) for t in rng.integers(1, cfg.vocab_size - 1, prompt_len)]
        if shared:
            eng.add_request(f"r{rid}", list(base), sp)
            rid += 1
            while eng.has_work():
                eng.step()
        for _ in range(n_reqs):
            toks = list(base) if shared else [
                int(t) for t in rng.integers(1, cfg.vocab_size - 1, prompt_len)]
            eng.add_request(f"r{rid}", toks, sp)
            rid += 1
        while eng.has_work():
            eng.step()

    try:
        for _ in range(reps):
            burst(1, 32, False)    # idle pod, short prompt
            burst(8, 32, False)    # deep queue → queued TTFT
            burst(4, 128, False)   # long prompts → prefill-bound TTFT
            burst(4, 128, True)    # shared prefix → cache-cut TTFT
        serve_s = time.monotonic() - t0
        rows = eng.drain_latency_trace()
    finally:
        eng.close()
    samples = [sample_from_dict(r) for r in rows]
    train, test = samples[0::2] + samples[1::4], samples[3::4]
    lm = LatencyModel()
    if not lm.fit(train):
        raise SystemExit(f"too few trace rows to train: {len(train)}")

    def mape(y, pred):
        y, pred = np.asarray(y, float), np.asarray(pred, float)
        return float(np.mean(np.abs(pred - y) / np.maximum(y, 1e-6)))

    preds = lm.predict(test)
    y_ttft = [s.ttft_ms for s in test]
    ttft_mape = mape(y_ttft, [p[0] for p in preds])
    ttft_mean_mape = mape(y_ttft, [float(np.mean([s.ttft_ms for s in train]))] * len(test))
    tpot_pairs = [(s.tpot_ms, p[1]) for s, p in zip(test, preds)
                  if s.tpot_ms is not None and p[1] is not None]
    tpot_mape = (mape([a for a, _ in tpot_pairs], [b for _, b in tpot_pairs])
                 if tpot_pairs else None)

    artifact = {
        "artifact": "predictor-accuracy",
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else device.type),
        "model": model,
        "requests_served": rid,
        "serve_seconds": round(serve_s, 1),
        "n_train": len(train),
        "n_test": len(test),
        "ttft_mape": round(ttft_mape, 4),
        "tpot_mape": round(tpot_mape, 4) if tpot_mape is not None else None,
        "mean_baseline_ttft_mape": round(ttft_mean_mape, 4),
        "skill_vs_mean": round(ttft_mean_mape / max(ttft_mape, 1e-9), 2),
        "reference_mape": 0.05,  # latency-predictor.md:58, dedicated serving hw
    }
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps(artifact))
    if ttft_mape >= ttft_mean_mape:
        print("WARNING: model shows no skill vs the mean baseline",
              file=sys.stderr)
    return artifact
