"""Serving throughput benchmark of the port on one card (port of ``bench.py``).

    python -m llmd_tpu_torch.tools.bench [--tiny] [--cpu] [--model NAME_OR_DIR]
        [--batch N] [--decode-steps K] [--isl N] [--osl N]
        [--quantize int8|none|default] [--kv-dtype fp8|bf16|default]
        [--moe-dispatch auto|sorted|einsum]
        [--chain-depth N] [--pack-overlap on|off] [--spec-mode off|ngram]
        [--spec-tokens N] [--structured-fused on|off]
        [--workload uniform|echo|json|json-echo] [--assert-spec-structured]
        [--attn-impl auto|pallas|reference] [--tune-attn] [--attn-tune-file F]

The reference's headline run: 64 concurrent requests of ISL 256 / OSL 128,
greedy with ``ignore_eos``, on ``llama-1b`` with int8 weight-only weights
(``--quantize none`` for bf16; ``--kv-dtype fp8`` for a ``float8_e4m3fn``
KV pool), through the engine's unified chunked prefill
and its captured, pipelined multi-step decode. ``--model`` takes a registry
name or an HF checkpoint directory; with no flag ``checkpoints/llama-1b-hf``
at the repo root is served when it exists, else random weights from seed 0
(the JSON says which). ``--tiny`` runs ``tiny``: 8 requests of ISL 64 / OSL
32. One warm-up ``generate`` of 2 prompts (the decode program's capture
included), then the measured window. Runs on the CUDA card unless ``--cpu``.

Workloads, as ``bench.py``'s: ``uniform`` (distinct streams), ``echo``
(periodic prompts, where prompt-lookup drafts pay; pair with ``--spec-mode
ngram``), ``json`` (every request constrained to a bounded JSON schema:
the masked decode program end to end; ``--structured-fused off`` takes the
unified degrade) and ``json-echo`` (a fully forced periodic schema with its
pattern in the prompt: speculation on constrained rows).
``--assert-spec-structured`` fails the run unless constrained rows accepted
drafts with no structured violation. Random weights constrain over the byte
tokenizer's vocabulary, an HF checkpoint over its own tokenizer.

Prints the card's name and power limit (``nvidia-smi``) and the run's phase
split on stderr, and ONE JSON line on stdout with ``bench.py``'s keys (every
key of ``tools/perf_regress.TOLERANCES`` a measured number), computed as
``bench.py`` computes them:

- ``value`` (output tok/s over the window's wall), ``vs_baseline`` against
  the same 3,100 tok/s anchor, ``decode_tok_per_s`` (tokens of decode calls
  over their wall), ``weights_bw_gbs`` / ``weights_bw_util`` and
  ``decode_weights_bw_util`` (one weight pass per decode iteration of the
  whole batch, over the card's HBM rate), ``decode_mfu`` (2 x active params
  per output token over the window, against the card's bf16 dense peak; a
  whole-run share, as the reference's). Peaks come from
  ``obs/costmodel.chip_peaks``: null for a device not in its table.
- the engine's counters and its wall split (``prefill_steps_s``,
  ``decode_steps_s``, ``host_pack_s``, ``device_s``, ``postprocess_s``,
  ``launch_gap_s``), the utilization ledger's goodput classes over the
  window, ``padding_efficiency`` and ``recompiles`` (CUDA-graph captures in
  the window). ``host_device_rtt_ms``: a one-element kernel and a
  synchronise.
- TTFT (``ttft_mean_ms``, ``ttft_p50_ms``, ``ttft_p90_ms``) and end-to-end
  latency (``e2e_mean_ms``, ``e2e_p90_ms``) per request, under
  ``llmd_tpu/benchmark/harness.py``'s names, from each sequence's
  ``arrival_time`` and ``first_token_time`` and the time its last token
  landed; TPOT (``tpot_mean_ms``, ``tpot_p90_ms``) as the reference engine
  defines it, (finish - first token) / (tokens - 1).
- provenance: ``device`` (the card's name), ``power_limit_w``, ``weights``
  (``random:<name>`` or ``hf:<dir>``), ``quantize``, backends.

- speculation and structured outputs under ``bench.py``'s names
  (``spec_*``, ``structured_*``, ``mask_build_s``, ``spec_steps_s``), and
  the goodput class ``spec_rejected`` (rejected draft rows of verify steps).

- K1's launch-config table (``ops/attn_tune``): ``--attn-tune-file F``
  serves the engine with F's plans; ``--tune-attn`` (on the card) first
  times K1 at the serving decode shape (``max_batch_size`` rows over the
  engine's page-table width, kv ``isl + osl // 2``) under candidate plans:
  ``bkv`` = the table width over 1, 2, 4, 8 and 16 splits, plus the
  policy's own plan, each by CUDA events with the card held by a spin
  kernel while the calls are enqueued (``tools/timing.cuda_ms``, which
  ``chip_smoke.py`` uses too). A candidate other than the policy wins only
  by beating it by 5%, as ``bench.py``'s tuner. The winner is merged into F (default: a file in the
  temp directory) with ``tuned_on`` the card's ``nvidia-smi`` name, the
  engine is built from F and must report F's hash, and the JSON carries
  ``attn_tune_hash``, the candidates' times (``attn_tune_candidates``), the
  winner and the policy's plan. ``--attn-impl`` is the engine's
  ``attn_impl``; ``attn_fallback_reason`` is the engine's.

Left out, since the port lacks the features: ``kv_layout``, ``layer_unroll``.
Flags for what the port does not serve exit non-zero naming the ROADMAP item.
Unlike ``bench.py`` there is no device preflight with its harvest of an old
campaign number and no fallback to a smaller config: a failure is a non-zero
exit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

# the reference's per-accelerator decode-throughput anchor (bench.py:38)
B200_ANCHOR_TOK_S = 3100.0
REPO = Path(__file__).resolve().parents[2]

# flag -> (the value(s) the port takes, the ROADMAP item that brings the rest)
REFUSED = {
    "layer_unroll": ((None,), "Queue A item 1 (the port's layers are a Python loop "
                              "inside captured programs; there is no scan to unroll)"),
    "kv_layout": ((None,), "Queue A, not ported by design (ops/packed_kv reclaims TPU "
                           "lane padding the port never adds)"),
}
# json workload: a bounded schema (enum / boolean / maxLength: a DAG grammar),
# so the mask forces completion; its longest serialization (29 characters)
# fits the tiny run's OSL 32
BENCH_SCHEMA = {
    "type": "object",
    "properties": {"n": {"type": "string", "maxLength": 4},
                   "c": {"enum": [0, 1, 2, 3, 4, 5, 6, 7]},
                   "ok": {"type": "boolean"}},
    "required": ["n", "c", "ok"],
}


def parse_args(argv: "list[str] | None" = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true", help="CI-sized run (tiny, 8 requests)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--model", default=None, help="registry name or HF checkpoint dir")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--decode-steps", type=int, default=None)
    ap.add_argument("--isl", type=int, default=None)
    ap.add_argument("--osl", type=int, default=None)
    ap.add_argument("--quantize", default="default", choices=["int8", "none", "default"],
                    help="weight-only quantization; default: int8, off for --tiny")
    ap.add_argument("--moe-dispatch", default="auto", choices=["auto", "sorted", "einsum"])
    ap.add_argument("--kv-dtype", default="default", choices=["fp8", "bf16", "default"],
                    help="KV pool dtype (EngineConfig.kv_cache_dtype): fp8 halves "
                         "decode's per-step KV read stream; default / bf16: the model's")
    ap.add_argument("--chain-depth", type=int, default=None,
                    help="decode calls in flight (EngineConfig.pipeline_depth)")
    ap.add_argument("--pack-overlap", default="on", choices=["on", "off"])
    ap.add_argument("--tune-attn", action="store_true",
                    help="time K1's candidate plans at the decode shape on the card "
                         "and merge the winner into --attn-tune-file")
    ap.add_argument("--attn-tune-file", default=None,
                    help="K1's launch-config table (ops/attn_tune JSON)")
    ap.add_argument("--attn-impl", default="auto", choices=["auto", "pallas", "reference"],
                    help="EngineConfig.attn_impl")
    # the reference's flags for features the port does not serve: refused
    ap.add_argument("--layer-unroll", type=int, default=None)
    ap.add_argument("--kv-layout", default=None)
    ap.add_argument("--spec-mode", default="off", choices=["off", "ngram"],
                    help="ngram: prompt-lookup drafts through the verify program")
    ap.add_argument("--spec-tokens", type=int, default=None,
                    help="max draft tokens a sequence a verify step")
    ap.add_argument("--structured-fused", default="on", choices=["on", "off"],
                    help="constrained rows on the masked decode program "
                         "(EngineConfig.structured_fused_decode); off: unified degrade")
    ap.add_argument("--workload", default="uniform",
                    choices=["uniform", "echo", "json", "json-echo"])
    ap.add_argument("--assert-spec-structured", action="store_true",
                    help="fail unless constrained rows accepted drafts with no "
                         "structured violation")
    args = ap.parse_args(argv)
    for name, (taken, item) in REFUSED.items():
        value = getattr(args, name)
        if value not in taken:
            ap.error(f"--{name.replace('_', '-')} {value!r} is not served by the port: "
                     f"ROADMAP {item}")
    if args.tune_attn and args.cpu:
        ap.error("--tune-attn times K1's plans on the card; the CPU runs its plain "
                 "version, which has no plan")
    return args


def tune_attention(cfg, eng_cfg, isl: int, osl: int, path: str, card_name: str,
                   device) -> dict:
    """Time K1's candidate plans at the serving decode shape and merge the
    winner into ``path`` (``ops/attn_tune``); returns the candidates, the
    winner, the policy's plan and the merged table's hash."""
    from llmd_tpu_torch.ops import attn_tune
    from llmd_tpu_torch.ops import paged_attention as pa
    from llmd_tpu_torch.tools.timing import cuda_ms

    B, ps, maxp = eng_cfg.max_batch_size, eng_cfg.page_size, eng_cfg.max_pages_per_seq
    H, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qpk, kvlen = H // Hk, min(isl + osl // 2, maxp * ps)
    gen = torch.Generator(device=device).manual_seed(0)
    pool = torch.randn((B * maxp + 1, ps, 2 * Hk, D), generator=gen, device=device,
                       dtype=torch.bfloat16)
    pts = torch.arange(B * maxp, dtype=torch.int32, device=device).reshape(B, maxp)
    q = torch.randn((B, H, D), generator=gen, device=device, dtype=torch.bfloat16)
    lens = torch.full((B,), kvlen, dtype=torch.int32, device=device)
    rows = torch.arange(B + 1, dtype=torch.int32, device=device)
    ns = torch.tensor([B], dtype=torch.int32, device=device)
    layout = attn_tune.head_layout_key(H, D, 2 * Hk)
    policy = pa._plan(B, B, maxp, ps, qpk, Hk, pa._num_sms(device.index or 0))

    def entry(bkv: int, us: "float | None" = None) -> dict:
        e = {"batch": B, "page_size": ps, "pages_per_seq": maxp, "head_layout": layout,
             "bkv": bkv, "bq": policy.tq, "tuned_on": card_name}
        if us is not None:
            e["us_per_call"] = round(us, 1)
        return e

    policy_bkv = maxp if policy.splits == 1 else policy.split_keys // ps
    cands: dict = {}  # (splits, split_keys) -> bkv: one timing per distinct plan
    for bkv in [maxp // s for s in (1, 2, 4, 8, 16) if maxp // s >= 1] + [policy_bkv]:
        plan = pa._plan(B, B, maxp, ps, qpk, Hk, override=(bkv, policy.tq))
        cands.setdefault((plan.splits, plan.split_keys), bkv)
    results = []
    for (splits, keys), bkv in cands.items():
        table = attn_tune.AttnTuneTable(entries=(entry(bkv),))
        ms = cuda_ms(lambda t=table: pa.paged_attention(
            q, pool, pts, lens - 1, rows[:B], lens, scale=D ** -0.5, cu_q_lens=rows,
            num_seqs=ns, tune=t))
        results.append({"bkv": bkv, "splits": splits, "split_keys": keys, "ms": ms,
                        "policy": (splits, keys) == (policy.splits, policy.split_keys)})
        print(f"# attn-tune bkv={bkv} ({splits} splits of {keys} keys): {ms:.4f} ms"
              f"{' (policy)' if results[-1]['policy'] else ''}", file=sys.stderr)
    base = next(r for r in results if r["policy"])
    best = min(results, key=lambda r: r["ms"])
    if not best["policy"] and best["ms"] >= 0.95 * base["ms"]:
        best = base  # jitter must not flip the policy
    table = attn_tune.merge_and_save(path, [entry(best["bkv"], best["ms"] * 1e3)])
    print(f"# attn-tune picked bkv={best['bkv']} ({best['splits']} splits) beside the "
          f"policy's {base['splits']} splits; table {path} sha={table.sha} "
          f"({len(table.entries)} entries)", file=sys.stderr)
    return {"candidates": results, "winner": best, "policy": base, "sha": table.sha,
            "path": path}


def card() -> tuple[Optional[str], Optional[float], str]:
    """(name, power limit W, nvidia-smi's line) of card 0; Nones off the card."""
    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None, None, ""
    name, _, limit = line.partition(",")
    try:
        watts = float(limit.strip().split()[0])
    except (ValueError, IndexError):
        watts = None
    return name.strip(), watts, line


def prompts(n: int, salt: int, vocab: int, isl: int, workload: str = "uniform",
            tok=None) -> list[list[int]]:
    """``bench.py``'s prompts: distinct token streams (no prefix-cache
    shortcut), the salt offsetting each stream. ``echo``: a short pattern
    per request repeated to ISL, so continuations repeat spans of the
    context. ``json-echo``: four salted head tokens, then the forced
    serialization the output will repeat (``[{"s":"on"},...``)."""
    if workload == "json-echo" and tok is not None:
        pat = tok.encode('[{"s":"on"},' + '{"s":"on"},' * 3)
        out = []
        for i in range(n):
            head = [(salt * 7919 + i * 131 + j) % (vocab - 2) + 1 for j in range(4)]
            out.append(head + (pat * (isl // max(1, len(pat)) + 1))[: isl - len(head)])
        return out
    if workload in ("echo", "json-echo"):
        return [[(salt * 7919 + i * 131 + j % 3) % (vocab - 2) + 1 for j in range(isl)]
                for i in range(n)]
    return [[(salt * 7919 + i * 131 + j) % (vocab - 2) + 1 for j in range(isl)]
            for i in range(n)]


def workload_schema(workload: str, osl: int) -> Optional[dict]:
    """The schema of the json workloads (None otherwise). ``json-echo``: a
    fixed-count array of single-enum objects, a fully forced periodic
    string whose element count scales with OSL."""
    if workload == "json":
        return BENCH_SCHEMA
    if workload == "json-echo":
        n_items = max(1, (osl - 10) // 11)
        return {"type": "array",
                "items": {"type": "object", "properties": {"s": {"enum": ["on"]}},
                          "required": ["s"]},
                "minItems": n_items, "maxItems": n_items}
    return None


def _pct(xs: list[float], q: float) -> float:
    """``harness.LoadResult._pct``: the sorted sample at ``int(q * n)``."""
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(q * len(ys)))]


def kernel_wrappers() -> dict:
    """The hand kernels' wrappers, whose counters count launches per kernel
    instance: K1 (paged attention), K3 (MLA latent decode), K2 and K4 (the
    grouped GEMMs)."""
    from llmd_tpu_torch.ops import grouped_gemm as gg
    from llmd_tpu_torch.ops import mla_decode as md
    from llmd_tpu_torch.ops import paged_attention as pa

    return {"paged_attention": pa.paged_attention, "mla_decode": md.mla_decode,
            "ragged_grouped_gemm": gg.ragged_grouped_gemm, "grouped_gemm": gg.grouped_gemm}


def run_window(eng, prompt_ids: list[list[int]], sampling) -> tuple[dict, dict]:
    """``eng.generate`` of ``prompt_ids`` that also keeps each request's
    arrival, first-token and finish times: (tokens by request id, times by
    request id)."""
    seqs = {}
    for i, p in enumerate(prompt_ids):
        rid = f"req-{i}"
        eng.add_request(rid, p, sampling)
        seqs[rid] = eng.seqs[rid]
    done: dict[str, list[int]] = {rid: [] for rid in seqs}
    finish: dict[str, float] = {}
    while eng.has_work():
        for out in eng.step():
            done[out.request_id].extend(out.new_token_ids)
            if out.finished:
                finish[out.request_id] = time.monotonic()
    st = eng.stats
    assert st.n_decode_dispatches == st.n_decode_calls, "decode pipeline leak"
    times = {rid: (s.arrival_time, s.first_token_time, finish[rid]) for rid, s in seqs.items()}
    return done, times


def main(argv: "list[str] | None" = None) -> int:
    args = parse_args(argv)
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.engine import EngineStats, LLMEngine, resolve_device
    from llmd_tpu_torch.models import resolve_model
    from llmd_tpu_torch.obs.costmodel import (
        GOODPUT_KINDS, bytes_per_param, chip_peaks, flops_per_token, param_count)

    device = resolve_device("cpu" if args.cpu else None)
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
    name, power_w, smi = card() if on_card else (None, None, "")
    dev_name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"# card: {smi or dev_name}", file=sys.stderr)

    tiny = args.tiny
    if tiny:
        model, n_req, isl, osl = "tiny", 8, 64, 32
        eng_cfg = EngineConfig(page_size=16, num_pages=256, max_model_len=512,
                               max_batch_size=8, prefill_chunk=64, decode_steps=8,
                               max_num_batched_tokens=256, instrument=True)
    else:
        model, n_req, isl, osl = "llama-1b", 64, 256, 128
        eng_cfg = EngineConfig(page_size=16, num_pages=2048, max_model_len=1024,
                               max_batch_size=64, prefill_chunk=256, decode_steps=32,
                               max_num_batched_tokens=8192, instrument=True)
        default_ckpt = REPO / "checkpoints" / "llama-1b-hf"
        if args.model is None and (default_ckpt / "config.json").is_file():
            args.model = str(default_ckpt)
    if args.model is not None:
        model = args.model
    n_req = args.batch or n_req
    isl, osl = args.isl or isl, args.osl or osl
    if args.batch:
        eng_cfg.max_batch_size = args.batch
        eng_cfg.max_num_batched_tokens = max(eng_cfg.batched_tokens, args.batch * 8)
    if args.decode_steps:
        eng_cfg.decode_steps = args.decode_steps
    if args.quantize == "default":
        eng_cfg.quantize_weights = None if tiny else "int8"
    else:
        eng_cfg.quantize_weights = None if args.quantize == "none" else "int8"
    eng_cfg.kv_cache_dtype = "fp8" if args.kv_dtype == "fp8" else None
    eng_cfg.moe_dispatch = args.moe_dispatch
    eng_cfg.pack_overlap = args.pack_overlap == "on"
    if args.chain_depth is not None:
        eng_cfg.pipeline_depth = max(1, args.chain_depth)
    eng_cfg.spec_mode = args.spec_mode
    if args.spec_tokens is not None:
        eng_cfg.spec_tokens = args.spec_tokens
    eng_cfg.structured_fused_decode = args.structured_fused == "on"
    eng_cfg.attn_impl = args.attn_impl
    eng_cfg.attn_tune_file = args.attn_tune_file

    # host <-> device round trip: a one-element kernel and a synchronise
    x = torch.zeros((), device=device)
    (x + 1).cpu()
    t0 = time.monotonic()
    for _ in range(3):
        (x + 1).cpu()
    rtt_ms = (time.monotonic() - t0) / 3 * 1e3
    print(f"# host<->device RTT {rtt_ms:.3f} ms", file=sys.stderr)

    t0 = time.monotonic()
    cfg, params = resolve_model(model)
    weights_src = f"hf:{model}" if params is not None else f"random:{model}"
    print(f"# weights {weights_src} (loaded in {time.monotonic() - t0:.1f}s)", file=sys.stderr)

    # the pool covers every request's prompt, output and the lookahead of the
    # decode calls in flight (bench.py's build_and_measure)
    lookahead = eng_cfg.decode_steps * (eng_cfg.pipeline_depth + 1)
    pages_per_seq = (isl + osl + lookahead) // eng_cfg.page_size + 1
    eng_cfg.num_pages = max(eng_cfg.num_pages, n_req * pages_per_seq + 64)
    eng_cfg.max_model_len = max(eng_cfg.max_model_len, isl + osl + lookahead + 1)
    tuned = None
    if args.tune_attn:
        if cfg.is_mla:
            print("# attn-tune: K1 serves MLA's unified program only; its decode "
                  "runs K3, which the table does not key: skipped", file=sys.stderr)
        else:
            import tempfile

            path = args.attn_tune_file or str(
                Path(tempfile.gettempdir()) / f"llmd_attn_tune_{os.getpid()}.json")
            tuned = tune_attention(cfg, eng_cfg, isl, osl, path, name or dev_name, device)
            eng_cfg.attn_tune_file = path
    tok = None
    if args.workload.startswith("json"):
        from llmd_tpu_torch.engine.tokenizer import load_tokenizer

        # an HF checkpoint brings its tokenizer; random weights constrain over
        # the byte tokenizer (the vocabulary the prompts draw from)
        tok = load_tokenizer(model if params is not None else None)
    t0 = time.monotonic()
    eng = LLMEngine(cfg, eng_cfg, params=params, device=device, tokenizer=tok)
    del params
    print(f"# engine built in {time.monotonic() - t0:.1f}s on {dev_name} "
          f"(NT={eng_cfg.batched_tokens}, k={eng_cfg.decode_steps}); "
          f"attn_backend={eng.attn_backend}"
          f"{f' (fallback: {eng.attn_fallback_reason})' if eng.attn_fallback_reason else ''}"
          f"{f' tune={eng.attn_tune_hash}' if eng.attn_tune_hash else ''} "
          f"moe_backend={eng.moe_backend} moe_dispatch={eng.moe_dispatch}", file=sys.stderr)
    if tuned is not None:
        # the round trip: the engine loaded the table the tuner just wrote
        assert eng.attn_tune_hash == tuned["sha"], (
            "engine did not load the tuner's table", eng.attn_tune_hash, tuned["sha"])
    schema = workload_schema(args.workload, osl)
    sp = SamplingParams(max_tokens=osl, temperature=0.0, ignore_eos=True,
                        response_format=None if schema is None else {
                            "type": "json_schema", "json_schema": {"schema": schema}})
    t0 = time.monotonic()
    eng.generate(prompts(2, 1, cfg.vocab_size, isl, args.workload, tok), sp)
    print(f"# warm-up {time.monotonic() - t0:.1f}s (decode graph captures "
          f"{eng.stats.decode_graph_captures}, "
          f"{eng.stats.decode_graph_capture_s:.2f}s)", file=sys.stderr)
    # fresh counters for the measured window; the ledger's totals are deltas
    # against this snapshot
    eng.stats = EngineStats(attn_backend=eng.attn_backend, moe_backend=eng.moe_backend,
                            moe_dispatch=eng.moe_dispatch,
                            kv_cache_dtype=eng.stats.kv_cache_dtype,
                            attn_fallback_reason=eng.attn_fallback_reason,
                            attn_tune_hash=eng.attn_tune_hash)
    base = ((eng.util.totals(), eng.util.compiles(), eng.util.moe_comm_total())
            if eng.util is not None else None)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():  # the window's kernel launches, per instance
        fn.launches, fn.launches_by_instance = 0, dict.fromkeys(fn.launches_by_instance, 0)
    if on_card:
        torch.cuda.synchronize(device)
    t0 = time.monotonic()
    out, times = run_window(eng, prompts(n_req, 2, cfg.vocab_size, isl, args.workload, tok),
                            sp)
    wall = time.monotonic() - t0
    launches = {n: dict(fn.launches_by_instance) for n, fn in wrappers.items()}
    out_tokens = sum(len(v) for v in out.values())
    assert out_tokens == n_req * osl, (out_tokens, n_req * osl)
    tput = out_tokens / wall

    st = eng.stats
    if args.assert_spec_structured:
        # the masked verify program landed drafts on constrained rows, with
        # no violation: a silent fallback to plain decode would pass a
        # throughput check while the path is dead
        assert st.spec_accepted_constrained > 0, (
            "no accepted drafts on constrained rows", st.spec_drafted_constrained,
            st.spec_accepted_constrained)
        assert st.structured_violations == 0, (
            "constrained-spec run produced violations", st.structured_violations)
        assert st.spec_fsm_crosscheck_mismatches == 0, st.spec_fsm_crosscheck_mismatches
    n_params = param_count(cfg)
    peak_tflops, peak_gbs = chip_peaks(dev_name)
    model_gb = n_params * bytes_per_param(cfg, eng_cfg.quantize_weights) / 1e9
    hbm_gb_per_tok = model_gb / max(1, eng_cfg.max_batch_size)
    achieved_gbs = tput * hbm_gb_per_tok  # the weight stream only: a lower bound
    decode_tput = st.decode_tokens_fused / max(1e-9, st.time_decode_steps)
    decode_bw_gbs = decode_tput * hbm_gb_per_tok
    mfu = tput * flops_per_token(cfg) / (peak_tflops * 1e12) if peak_tflops else None
    launch_gap = wall - st.time_prefill_steps - st.time_decode_steps - st.time_spec_steps
    dev_ms_per_decode = st.time_device_decode / max(1, st.n_decode_calls) * 1e3
    pack_us_per_call = st.time_host_pack / max(1, st.n_decode_calls + st.n_unified_steps) * 1e6

    goodput = {k: None for k in GOODPUT_KINDS}
    padding_efficiency = recompiles = moe_comm_bytes = None
    if base is not None:
        base_tokens, base_compiles, base_comm = base
        moe_comm_bytes = round(eng.util.moe_comm_total() - base_comm)
        goodput = dict.fromkeys(GOODPUT_KINDS, 0)
        for prog, tk in eng.util.totals().items():
            for kind, v in tk.items():
                goodput[kind] += v - base_tokens.get(prog, {}).get(kind, 0)
        real = goodput["committed"] + goodput["spec_rejected"] + goodput["preempted_recompute"]
        cap = real + goodput["padding"]
        padding_efficiency = round(real / cap, 4) if cap else None
        recompiles = sum(v - base_compiles.get(p, 0) for p, v in eng.util.compiles().items())

    ttft = [(f - a) for a, f, _ in times.values()]
    e2e = [(e - a) for a, _, e in times.values()]
    tpot = [(e - f) / max(1, len(out[rid]) - 1) for rid, (_, f, e) in times.items()]
    ms = lambda v: round(v * 1e3, 3)  # noqa: E731

    print(f"# {out_tokens} output tokens in {wall:.2f}s (prefill {st.total_prefill_tokens} "
          f"toks, decode {st.total_decode_tokens} toks, preemptions "
          f"{st.total_preemptions})", file=sys.stderr)
    if st.structured_requests:
        print(f"# structured: {st.structured_requests} constrained requests, "
              f"{st.structured_mask_builds} mask builds + {st.structured_chain_stages} "
              f"chain stages in {st.time_mask_build:.3f}s host, violations "
              f"{st.structured_violations}", file=sys.stderr)
    if st.n_spec_verify_steps:
        print(f"# spec: drafted {st.spec_drafted}, accepted {st.spec_accepted}, rejected "
              f"{st.spec_rejected} over {st.n_spec_verify_steps} verify steps "
              f"({st.spec_accepted / st.n_spec_verify_steps:.2f} accepted/verify-step; "
              f"constrained {st.spec_accepted_constrained}/{st.spec_drafted_constrained} "
              "accepted/drafted)", file=sys.stderr)
    print(f"# phase split: prefill-steps {st.time_prefill_steps:.3f}s, decode-steps "
          f"{st.time_decode_steps:.3f}s, spec-steps {st.time_spec_steps:.3f}s, "
          f"launch-gap {launch_gap:.3f}s | host-pack "
          f"{st.time_host_pack:.3f}s (+{st.time_pack_overlap:.3f}s overlapped, "
          f"{st.n_chained_dispatches} chained), device {st.time_device:.3f}s, post "
          f"{st.time_postprocess:.3f}s ({st.n_unified_steps} unified + "
          f"{st.n_decode_calls} decode calls; {dev_ms_per_decode:.2f} ms "
          "device/decode-call)", file=sys.stderr)
    wdtype = "int8" if eng_cfg.quantize_weights == "int8" else cfg.dtype
    print(f"# model {n_params / 1e9:.3f}B params ({model_gb:.2f} GB {wdtype}); weights-BW "
          f"{achieved_gbs:.1f} GB/s of {peak_gbs} peak; decode-MFU {mfu}", file=sys.stderr)

    result = {
        "metric": "output_tok_per_s_per_chip",
        "value": round(tput, 1),
        "unit": "tok/s",
        "vs_baseline": round(tput / B200_ANCHOR_TOK_S, 4),
        "weights": weights_src,
        "quantize": eng_cfg.quantize_weights,
        "kv_cache_dtype": eng.stats.kv_cache_dtype,
        "attn_backend": eng.attn_backend,
        "attn_fallback_reason": eng.attn_fallback_reason,
        "attn_tune_hash": eng.attn_tune_hash,
        "moe_backend": eng.moe_backend,
        "moe_dispatch": eng.moe_dispatch,
        "moe_dropped_tokens": st.moe_dropped_tokens,
        "moe_comm_bytes": moe_comm_bytes,
        "device": dev_name,
        "power_limit_w": power_w,
        "weights_bw_gbs": round(achieved_gbs, 1),
        "weights_bw_util": round(achieved_gbs / peak_gbs, 4) if peak_gbs else None,
        "decode_tok_per_s": round(decode_tput, 1),
        "decode_vs_baseline": round(decode_tput / B200_ANCHOR_TOK_S, 4),
        "decode_weights_bw_util": round(decode_bw_gbs / peak_gbs, 4) if peak_gbs else None,
        "decode_mfu": round(mfu, 5) if mfu is not None else None,
        "prefill_tokens": st.total_prefill_tokens,
        "decode_tokens": st.total_decode_tokens,
        "preemptions": st.total_preemptions,
        "goodput_committed_tokens": goodput["committed"],
        "goodput_spec_rejected_tokens": goodput["spec_rejected"],
        "goodput_padding_tokens": goodput["padding"],
        "goodput_preempted_recompute_tokens": goodput["preempted_recompute"],
        "goodput_prefix_saved_tokens": goodput["prefix_saved"],
        "padding_efficiency": padding_efficiency,
        "recompiles": recompiles,
        "wall_s": round(wall, 4),
        "prefill_steps_s": round(st.time_prefill_steps, 4),
        "decode_steps_s": round(st.time_decode_steps, 4),
        "spec_steps_s": round(st.time_spec_steps, 4),
        "launch_gap_s": round(launch_gap, 4),
        "host_pack_s": round(st.time_host_pack, 4),
        "pack_overlap_s": round(st.time_pack_overlap, 4),
        "chained_dispatches": st.n_chained_dispatches,
        "serialized_host_s": round(st.time_host_pack + st.time_mask_build, 4),
        "pack_overlap": eng_cfg.pack_overlap,
        "structured_fused": eng_cfg.structured_fused_decode,
        "chain_depth": eng_cfg.pipeline_depth,
        "attn_impl": eng_cfg.attn_impl,
        "device_s": round(st.time_device, 4),
        "device_decode_s": round(st.time_device_decode, 4),
        "postprocess_s": round(st.time_postprocess, 4),
        "unified_steps": st.n_unified_steps,
        "decode_calls": st.n_decode_calls,
        "device_ms_per_decode_call": round(dev_ms_per_decode, 3),
        "host_pack_us_per_call": round(pack_us_per_call, 1),
        "host_device_rtt_ms": round(rtt_ms, 4),
        "pipeline_decode": eng_cfg.pipeline_decode,
        "decode_graph_replays": st.decode_graph_replays,
        "decode_iterations": st.n_decode_iterations,
        "kernel_launches": launches,
        "batch": eng_cfg.max_batch_size,
        "decode_steps_fused": eng_cfg.decode_steps,
        "isl": isl,
        "osl": osl,
        "workload": args.workload,
        "spec_mode": eng_cfg.spec_mode,
        "spec_tokens": eng_cfg.spec_tokens if eng_cfg.spec_mode != "off" else None,
        "spec_drafted": st.spec_drafted,
        "spec_accepted": st.spec_accepted,
        "spec_rejected": st.spec_rejected,
        "spec_drafted_constrained": st.spec_drafted_constrained,
        "spec_accepted_constrained": st.spec_accepted_constrained,
        "spec_fsm_crosscheck_mismatches": st.spec_fsm_crosscheck_mismatches,
        "spec_verify_steps": st.n_spec_verify_steps,
        "spec_accepted_per_verify_step": round(st.spec_accepted / st.n_spec_verify_steps, 3)
        if st.n_spec_verify_steps else None,
        "structured_requests": st.structured_requests,
        "structured_mask_builds": st.structured_mask_builds,
        "structured_chain_stages": st.structured_chain_stages,
        "structured_violations": st.structured_violations,
        "mask_build_s": round(st.time_mask_build, 4),
        "requests": n_req,
        "ttft_mean_ms": ms(sum(ttft) / len(ttft)),
        "ttft_p50_ms": ms(_pct(ttft, 0.5)),
        "ttft_p90_ms": ms(_pct(ttft, 0.9)),
        "tpot_mean_ms": ms(sum(tpot) / len(tpot)),
        "tpot_p90_ms": ms(_pct(tpot, 0.9)),
        "e2e_mean_ms": ms(sum(e2e) / len(e2e)),
        "e2e_p90_ms": ms(_pct(e2e, 0.9)),
    }
    if tuned is not None:
        result.update(attn_tune_candidates=tuned["candidates"],
                      attn_tune_winner=tuned["winner"], attn_tune_policy=tuned["policy"],
                      attn_tune_file=tuned["path"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
