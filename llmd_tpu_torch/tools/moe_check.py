"""MoE dispatch gate (port of ``tools/moe_check.py``: the same engines,
workload, checks and printed lines; ``ci_gate`` stage ``bench-tiny-moe``).

Two tiny-moe engines run the same greedy workload — one on the dense
one-hot einsum dispatch (capacity-bounded, drops tokens past
``moe_capacity_factor``; K4, the grouped GEMM, on the card) and one on the
token-sorted drop-free path (K2, the ragged grouped GEMM, on the card) — then
the dispatch plane's standing invariants are asserted end to end:

1. ``moe_dispatch=auto`` resolves to the sorted path on a MoE model
2. greedy outputs are parity-matched between the two paths at matched routing
   decisions (einsum run at a capacity factor generous enough to keep every
   routed token)
3. the sorted engine records ZERO dropped tokens — in ``EngineStats`` and in
   the scraped ``llmd_tpu:moe_dropped_tokens_total{path="sorted"}`` series
4. the einsum engine at tiny-moe's default capacity factor provably drops
   tokens on this workload (> 0), and its counter matches the engine ledger
   exactly

On the card each engine's K2 / K4 launches are counted (the wrappers'
``launches``) beside its forwards: two expert GEMMs a MoE layer a forward,
all on K2 for the sorted engine and all on K4 for the two einsum ones.

Run: python -m llmd_tpu_torch.tools.moe_check [--cpu]  (the card unless
``--cpu``; exit 0 = all checks pass)
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine.config import EngineConfig
from llmd_tpu_torch.engine.engine import LLMEngine, resolve_device
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.ops import grouped_gemm

PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9]]
BASE = dict(page_size=8, num_pages=64, max_model_len=128, max_batch_size=4)
SEED = 7


def _launches() -> dict[str, int]:
    return {"ragged_grouped_gemm": grouped_gemm.ragged_grouped_gemm.launches,
            "grouped_gemm": grouped_gemm.grouped_gemm.launches}


def _serve(device, moe_dispatch: str, capacity_factor: "float | None" = None,
           params=None) -> tuple[LLMEngine, list[list[int]], dict]:
    cfg = get_model_config("tiny-moe")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity_factor)
    eng = LLMEngine(cfg, EngineConfig(moe_dispatch=moe_dispatch, **BASE),
                    params=params, seed=SEED, device=device)
    before = _launches()
    for i, p in enumerate(PROMPTS):
        eng.add_request(f"m-{i}", list(p),
                        SamplingParams(max_tokens=8, temperature=0.0))
    done: dict[str, list[int]] = {}
    while eng.has_work():
        for r in eng.step():
            done.setdefault(r.request_id, []).extend(r.new_token_ids)
    launches = {k: v - before[k] for k, v in _launches().items()}
    return eng, [done[f"m-{i}"] for i in range(len(PROMPTS))], launches


def _scrape_dropped(eng: LLMEngine) -> dict[str, float]:
    """path -> value of llmd_tpu:moe_dropped_tokens_total."""
    out: dict[str, float] = {}
    for name, labels, value in eng.metrics.registry.collect():
        if name != "llmd_tpu:moe_dropped_tokens_total":
            continue
        for part in labels.strip("{}").split(","):
            k, _, v = part.partition("=")
            if k == "path":
                out[v.strip('"')] = value
    return out


def _forwards(eng: LLMEngine) -> int:
    """The engine's model forwards: unified steps plus decode iterations."""
    return eng.stats.n_unified_steps + eng.stats.n_decode_iterations


def _check_launches(label: str, eng: LLMEngine, launches: dict, kernel: str) -> dict:
    """On the card: every expert GEMM of every forward went through ``kernel``
    (two a MoE layer a forward) and none through the other."""
    layers = eng.model_cfg.num_layers
    want = 2 * layers * _forwards(eng)
    other = ({"ragged_grouped_gemm", "grouped_gemm"} - {kernel}).pop()
    assert launches[kernel] == want and launches[other] == 0, (
        f"{label}: launches {launches}, expected {want} of {kernel} "
        f"({layers} MoE layers x {_forwards(eng)} forwards x 2) and no {other}")
    print(f"moe-check: {label} launched {kernel} {launches[kernel]} times over "
          f"{_forwards(eng)} forwards x {layers} MoE layers x 2")
    return {"launches": launches[kernel], "forwards": _forwards(eng)}


def check(device: "torch.device | str", params=None) -> dict:
    """The four checks on ``device``; raises AssertionError on a failed one,
    else returns ``{"tokens", "einsum_dropped", ...}`` (and, on the card,
    each engine's kernel launches against its forwards). ``params``: the
    tiny-moe weights (default: drawn from the gate's seed)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    out: dict = {}
    eng_s, out_s, l_s = _serve(device, "auto", params=params)
    try:
        # (1) auto must resolve to the sorted path on a MoE model
        assert eng_s.moe_dispatch == "sorted", (
            "moe_dispatch=auto did not select the sorted path",
            eng_s.moe_dispatch, eng_s.moe_dispatch_fallback_reason)
        assert eng_s.stats.moe_dispatch == "sorted", eng_s.stats.moe_dispatch
        print("moe-check: auto selected the sorted dispatch path")
        if on_card:
            out["sorted"] = _check_launches("sorted", eng_s, l_s, "ragged_grouped_gemm")

        # (2) greedy parity at matched routing decisions: einsum gets a
        # capacity factor generous enough (C >= T*k) that it keeps every
        # routed token, so any divergence is dispatch math, not drops
        eng_p, out_p, l_p = _serve(device, "einsum", capacity_factor=8.0, params=params)
        try:
            assert eng_p.moe_dispatch == "einsum", eng_p.moe_dispatch
            assert eng_p.stats.moe_dropped_tokens == 0, (
                "parity reference still dropped tokens at capacity_factor=8.0",
                eng_p.stats.moe_dropped_tokens)
            if on_card:
                out["einsum_parity"] = _check_launches("einsum (capacity 8)", eng_p, l_p,
                                                       "grouped_gemm")
        finally:
            eng_p.close()
        assert out_s == out_p, ("sorted vs einsum greedy outputs diverged",
                                out_s, out_p)
        n_tok = sum(len(o) for o in out_s)
        print(f"moe-check: greedy outputs parity-matched across both paths "
              f"({n_tok} tokens)")

        # (3) sorted path is drop-free: engine ledger and scraped counter
        assert eng_s.stats.moe_dropped_tokens == 0, eng_s.stats.moe_dropped_tokens
        scraped_s = _scrape_dropped(eng_s)
        assert scraped_s.get("sorted", 0.0) == 0.0, scraped_s
        print("moe-check: sorted path dropped 0 tokens (stats + counter)")
    finally:
        eng_s.close()

    # (4) capacity-bounded einsum at the default factor provably drops on
    # this workload, and the counter matches the engine ledger exactly
    eng_e, _, l_e = _serve(device, "einsum", params=params)
    try:
        assert eng_e.moe_dispatch == "einsum", eng_e.moe_dispatch
        dropped = eng_e.stats.moe_dropped_tokens
        assert dropped > 0, (
            "einsum reference dropped nothing — the workload no longer "
            "exercises the capacity bound the sorted path removes")
        scraped_e = _scrape_dropped(eng_e)
        assert scraped_e.get("einsum", 0.0) == float(dropped), (scraped_e, dropped)
        print(f"moe-check: einsum reference dropped {dropped} tokens at "
              f"capacity; counter == ledger")
        if on_card:
            out["einsum"] = _check_launches("einsum", eng_e, l_e, "grouped_gemm")
    finally:
        eng_e.close()
    return out | {"tokens": out_s, "einsum_dropped": dropped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU; default the card")
    args = ap.parse_args(argv)
    t_start = time.monotonic()
    check(resolve_device("cpu" if args.cpu else None))
    print(f"moe-check: ALL OK ({time.monotonic() - t_start:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
