"""Where a decode step's time goes, on the card.

    python -m llmd_tpu_torch.tools.profile_engine [--batches 8,32] [--model llama-1b]
        [--moe-dispatch auto|sorted|einsum] [--quantize int8] [--lora N] [--images N]

``--model`` takes any served registry model, dense (``llama-1b``), MoE
(``moe-wide-sim``; its expert GEMMs are K2 on the sorted dispatch, K4 on the
einsum one) or MLA (``moe-wide-mla``: K1's latent instance in the unified
program, the latent decode kernel K3 in the decode program). ``--quantize
int8`` serves int8 weight-only weights (their plain products; no K2/K4 on
int8 banks). ``--lora N`` serves under LoRA (8 slots of rank 8) with N test
adapters, drawn from the seed, spread over the rows (row i on adapter i % N).
``--images N`` profiles the unified program instead (``profile_unified``):
one step over a batch whose prompts carry N media items each after
``--prompt-len`` text tokens, beside a batch of text prompts of the same
length; a model without media tokens is given LLaVA-1.5's 576
a media item, the last vocabulary id as the placeholder.

For each batch size, in turn for the decode program captured into a CUDA
graph and replayed (``graph``, the engine's default) and for the same program
run eagerly (``eager``, ``decode_graph=False``): an engine
(random bf16 weights from ``--seed``, the reference's pipelined dispatch on)
prefills ``batch`` prompts of ``--prompt-len`` tokens, then runs decode calls
of ``--decode-steps`` iterations, all through its public ``step()`` and
``stats``. It reports

- prefill throughput from the engine's own step timer and decode throughput
  from wall time around calls that end in a device synchronise (no profiler
  attached),
- the host time to enqueue one ``forward_core`` (no synchronise inside),
- from ``torch.profiler`` over a separate window of decode calls: device time
  by kernel name, host time by op, device kernels per decode iteration
  (``device_kernels_per_iteration``) beside the host's launch calls per
  iteration (``host_launch_calls_per_iteration``: the CUDA API calls
  (``cuda*`` and ``cu*``) that launch a kernel or a graph, by name in
  ``host_launch_calls``; a graph replay is one call for all its kernels, so
  the two differ by design), and the device's busy
  share of that window's wall time (the profiler's own overhead inflates the
  window, so busy device ms per iteration is also set against the unprofiled
  wall per iteration), and the shares of device time of K1 (paged attention),
  of K3 (MLA latent decode) and of the grouped GEMMs (K2/K4), and the device
  time of the KV-split merges (K1's and K3's second kernel) per iteration,
- on MoE models, the host time of one K2 launch (no synchronise inside) at
  this batch's decode shape: layer 0's ``wi`` bank and a random top-k routing
  of ``batch`` tokens, median over runs of 100 calls; the wrapper's call, and
  the library's C entry point alone for each kernel instance (the wgmma one
  encodes two tensor maps per launch, the simt one none),
- on GQA models, the host time of one K1 launch the same way, at this
  batch's decode shape over the engine's pool (``batch`` one-token rows of
  ``prompt_len + 1`` keys, the engine's table width): the wrapper's call,
  and the C entry point alone with the same arguments (the instance the
  wrapper picks, its split plan and scratch made once outside the loop);
  on MLA models the same for one K3 launch (the decode program's kernel).

Prints one line per batch (``--out PATH`` also writes every row as JSON).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch


# host seconds that a profiled window's trace runs before its first and after
# its last call (see ``profile_batch``)
TRACE_MARGIN_S = 0.05


def _kernel_rows(prof) -> list[dict]:
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us > 0 and "cuda" in str(getattr(e, "device_type", "")).lower():
            rows.append({"name": e.key[:120], "count": e.count, "device_us": dev_us})
    return sorted(rows, key=lambda r: -r["device_us"])


# host-side CUDA API calls (``cuda*`` and ``cu*``) that launch device work:
# a kernel, or a whole CUDA graph
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


def launch_calls(prof) -> dict[str, int]:
    """Host launch calls in the profiled window, by CUDA API call."""
    out: dict[str, int] = {}
    for e in prof.key_averages():
        if e.key in LAUNCH_CALLS:
            out[e.key] = out.get(e.key, 0) + e.count
    return out


# the device kernel that each wrapper instance launches once a call (a split
# launch adds a merge kernel, which is not one of these); an fp8 pool's
# variant is the same template over another pool type
KERNEL_OF_INSTANCE = {
    ("paged_attention", "mma"): "paged_attention_mma_kernel",
    ("paged_attention", "simt"): "paged_attention_kernel",
    ("paged_attention", "mma_fp8"): "paged_attention_mma_kernel",
    ("paged_attention", "simt_fp8"): "paged_attention_kernel",
    ("mla_decode", "mma"): "mla_decode_mma_kernel",
    ("mla_decode", "simt"): "mla_decode_kernel",
    ("mla_decode", "mma_fp8"): "mla_decode_mma_kernel",
    ("mla_decode", "simt_fp8"): "mla_decode_kernel",
    ("ragged_grouped_gemm", "wgmma"): "grouped_gemm_wgmma_kernel",
    ("ragged_grouped_gemm", "simt"): "grouped_gemm_simt_kernel",
    ("grouped_gemm", "wgmma"): "grouped_gemm_wgmma_kernel",
    ("grouped_gemm", "simt"): "grouped_gemm_simt_kernel",
}


def counted_launches() -> dict[str, int]:
    """The kernel wrappers' launch counters (K1, K3, K2, K4), summed by the
    device kernel each instance launches. Under a graph replay these are the
    launches the capture recorded, credited once per replay."""
    from llmd_tpu_torch.engine.cuda_graph import launch_counters

    out = dict.fromkeys(KERNEL_OF_INSTANCE.values(), 0)
    for fn in launch_counters():
        for inst, n in fn.launches_by_instance.items():
            out[KERNEL_OF_INSTANCE[fn.__name__, inst]] += n
    return out


def device_launches(kernels: list[dict]) -> dict[str, int]:
    """The same kernels' launches as the profiler saw them run on the device."""
    out = {}
    for name in dict.fromkeys(KERNEL_OF_INSTANCE.values()):
        pat = re.compile(rf"(?<!\w){name}(?!\w)")
        out[name] = sum(r["count"] for r in kernels if pat.search(r["name"]))
    return out


def _host_rows(prof) -> list[dict]:
    """Host-side ops and CUDA runtime calls by self CPU time."""
    rows = [{"name": e.key[:80], "count": e.count, "cpu_us": e.self_cpu_time_total}
            for e in prof.key_averages() if e.self_cpu_time_total > 0]
    return sorted(rows, key=lambda r: -r["cpu_us"])


def _host_us(fn) -> float:
    """Median host microseconds per call of ``fn`` over 5 runs of 100 calls
    (after one warm-up run); no synchronise inside a run."""
    runs = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        if i:  # the first run warms up
            runs.append((time.perf_counter() - t0) / 100)
    torch.cuda.synchronize()
    return float(np.median(runs)) * 1e6


def k1_host_us(eng, batch: int, prompt_len: int, seed: int) -> dict:
    """Host microseconds per K1 launch at the decode shape of ``batch``
    sequences: ``k1_host_us_per_launch`` (the wrapper) and
    ``k1_c_call_us`` (the C entry point alone); empty on an MLA model, whose
    decode program runs K3."""
    cfg = eng.model_cfg
    if cfg.is_mla:
        return {}
    from llmd_tpu_torch.ops import paged_attention as pa

    pool, dev = eng.cache, eng.cache.device
    ps, planes, D = pool.shape[1], pool.shape[2], pool.shape[3]
    maxp = eng.cfg.max_pages_per_seq
    g = torch.Generator(device=dev).manual_seed(seed)
    # q in the model's dtype: an fp8 pool's dtype is not q's
    q = torch.randn((batch, cfg.num_heads, D), generator=g, device=dev).to(cfg.torch_dtype)
    n_pages = -(-(prompt_len + 1) // ps)
    pts = torch.full((batch, maxp), -1, dtype=torch.int32, device=dev)
    pts[:, :n_pages] = torch.arange(batch * n_pages, dtype=torch.int32,
                                    device=dev).view(batch, n_pages)
    lens = torch.full((batch,), prompt_len + 1, dtype=torch.int32, device=dev)
    pos, rows = lens - 1, torch.arange(batch, dtype=torch.int32, device=dev)
    cu = torch.arange(batch + 1, dtype=torch.int32, device=dev)
    ns = torch.tensor([batch], dtype=torch.int32, device=dev)
    scale = D ** -0.5
    group = pa._check(q, pool, pts, lens, cu, ns)
    instance = pa._instance(q.dtype, planes, D, group, pool.dtype)
    plan = pa._plan(batch, batch, maxp, ps, group, planes // 2, pa._num_sms(dev.index or 0))
    scratch = torch.empty(plan.splits * batch * cfg.num_heads * (D + 2), dtype=torch.float32,
                          device=dev)
    out = torch.empty_like(q)
    c_fn = pa._library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (q.data_ptr(), pool.data_ptr(), pts.data_ptr(), lens.data_ptr(), cu.data_ptr(),
            ns.data_ptr(), out.data_ptr(), scratch.data_ptr(), batch, cfg.num_heads, planes,
            group, D, ps, maxp, scale, pa._DTYPE_CODE[q.dtype], pa._POOL_CODE[pool.dtype],
            pa._INSTANCE_CODE[instance.removesuffix("_fp8")],
            plan.tq, plan.slots, plan.splits, plan.split_keys, stream)
    return {"k1_instance": instance, "k1_splits": plan.splits,
            "k1_host_us_per_launch": _host_us(lambda: pa.paged_attention(
                q, pool, pts, pos, rows, lens, scale=scale, cu_q_lens=cu, num_seqs=ns)),
            "k1_c_call_us": _host_us(lambda: c_fn(*args))}


def k3_host_us(eng, batch: int, prompt_len: int, seed: int) -> dict:
    """Host microseconds per K3 launch at the decode shape of ``batch``
    sequences over the engine's latent pool: ``k3_host_us_per_launch`` (the
    wrapper, through the decode program's adapter) and ``k3_c_call_us`` (the
    C entry point alone with the same arguments); empty on a GQA model."""
    cfg = eng.model_cfg
    if not cfg.is_mla:
        return {}
    from llmd_tpu_torch.ops import mla_decode as md

    pool, dev = eng.cache, eng.cache.device
    ps, D = pool.shape[1], pool.shape[3]
    maxp = eng.cfg.max_pages_per_seq
    g = torch.Generator(device=dev).manual_seed(seed)
    # q in the model's dtype: an fp8 pool's dtype is not q's
    q = torch.randn((batch, cfg.num_heads, D), generator=g, device=dev).to(cfg.torch_dtype)
    n_pages = -(-(prompt_len + 1) // ps)
    pts = torch.full((batch, maxp), -1, dtype=torch.int32, device=dev)
    pts[:, :n_pages] = torch.arange(batch * n_pages, dtype=torch.int32,
                                    device=dev).view(batch, n_pages)
    lens = torch.full((batch,), prompt_len + 1, dtype=torch.int32, device=dev)
    scale = 0.1
    instance = md._instance(q.dtype, cfg.num_heads, D, pool.dtype)
    plan = md._plan(batch, maxp, ps, md._num_sms(dev.index or 0))
    scratch = torch.empty(plan.splits * batch * cfg.num_heads * (D + 2), dtype=torch.float32,
                          device=dev)
    out = torch.empty_like(q)
    pt0 = pts.clamp(min=0)
    c_fn = md._library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (q.data_ptr(), pool.data_ptr(), pt0.data_ptr(), lens.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), batch, cfg.num_heads, D, ps, maxp, scale,
            md._DTYPE_CODE[q.dtype], md._POOL_CODE[pool.dtype],
            md._INSTANCE_CODE[instance.removesuffix("_fp8")], plan.splits,
            plan.split_keys, stream)
    return {"k3_instance": instance, "k3_splits": plan.splits,
            "k3_host_us_per_launch": _host_us(lambda: md.mla_paged_attention_latent(
                q, pool, pts, None, None, lens, scale=scale)),
            "k3_c_call_us": _host_us(lambda: c_fn(*args))}


def k2_host_us(cfg, params, batch: int, seed: int) -> dict:
    """Host microseconds per K2 launch at the decode shape of ``batch``
    tokens: ``k2_host_us_per_launch`` (the wrapper), ``k2_c_call_us_wgmma``
    and ``k2_c_call_us_simt`` (the C entry point); empty on a dense model."""
    if not cfg.is_moe or "moe_wi" not in params:  # dense, or int8 banks (no K2)
        return {}
    from llmd_tpu_torch.ops.grouped_gemm import _library, ragged_grouped_gemm
    from llmd_tpu_torch.ops.moe_dispatch import dispatch_stage, pick_block_size

    wi = params["moe_wi"][0]
    S, D, F = wi.shape
    k, dev = cfg.moe_top_k, wi.device
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.argsort(torch.rand((batch, S), generator=g, device=dev), dim=1)[:, :k]
    x = torch.randn((batch, D), generator=g, device=dev).to(wi.dtype)
    bc = pick_block_size(batch * k, S, pallas=True)
    xs, _, _, _, slot, rows = dispatch_stage(
        x, idx, torch.ones((batch, k), device=dev),
        torch.ones((batch, 1), dtype=torch.int32, device=dev), S, bc)
    xb = xs.view(-1, bc, D)
    nb = xb.shape[0]
    out = torch.empty((nb, bc, F), dtype=wi.dtype, device=dev)
    c_fn = _library()[0]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def c_call(instance: int):
        args = (xb.data_ptr(), wi.data_ptr(), slot.data_ptr(), rows.data_ptr(),
                out.data_ptr(), nb, bc, D, F, S, 1, instance, stream)
        return lambda: c_fn(*args)

    return {"k2_host_us_per_launch": _host_us(lambda: ragged_grouped_gemm(xb, wi, slot, rows)),
            "k2_c_call_us_wgmma": _host_us(c_call(1)), "k2_c_call_us_simt": _host_us(c_call(0))}


def profile_batch(cfg, params, batch: int, prompt_len: int, decode_steps: int,
                  calls: int, prof_calls: int, seed: int, moe_dispatch: str = "auto",
                  decode_graph: bool = True, quantize: "str | None" = None,
                  sampling: "dict | None" = None, tokenizer=None, lora: int = 0) -> dict:
    """One engine's decode at ``batch`` sequences, replayed or eager.
    ``sampling``: extra SamplingParams fields of every request (a grammar
    runs the masked decode program; ``tokenizer`` lifts it). ``lora``: that
    many test adapters (8 slots of rank 8), row i on adapter ``i % lora``."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models.lora import LoRAConfig
    from llmd_tpu_torch.models.transformer import forward_core

    ps = 16
    # the budget covers the warm-up calls, both windows and the calls that
    # the pipelined dispatch keeps in flight
    budget = (calls + prof_calls + 8) * decode_steps + 1
    per_seq = (prompt_len + budget + ps) // ps + 1
    ecfg = EngineConfig(
        page_size=ps, num_pages=batch * per_seq + 8, max_model_len=4096,
        max_batch_size=batch, prefill_chunk=min(prompt_len, 2048),
        max_num_batched_tokens=max(2048, prompt_len), decode_steps=decode_steps,
        moe_dispatch=moe_dispatch, quantize_weights=quantize,
        lora=LoRAConfig() if lora else None)
    eng = LLMEngine(cfg, ecfg, params=params, seed=seed, decode_graph=decode_graph,
                    tokenizer=tokenizer)
    for j in range(lora):
        eng.load_lora_adapter(f"adapter-{j}", seed=seed + j)
    rng = np.random.default_rng(seed)
    for i in range(batch):
        eng.add_request(f"r{i}", rng.integers(0, 256, prompt_len).tolist(),
                        SamplingParams(max_tokens=budget, temperature=0.0, **(sampling or {})),
                        lora_id=f"adapter-{i % lora}" if lora else None)
    st = eng.stats
    while st.n_decode_calls == 0:  # the prefill steps, then warm-up decode calls
        eng.step()
    # the prefill steps' host time; each but the last waits for the one before
    prefill_s = st.time_prefill_steps
    sync = torch.cuda.synchronize
    # each window starts on an idle device (the calls in flight finished) and
    # ends when the calls it launched have: their device time is all inside
    sync()
    it0 = st.n_decode_iterations
    t0 = time.perf_counter()
    for _ in range(calls):
        eng.step()
    sync()
    wall = time.perf_counter() - t0
    iters = st.n_decode_iterations - it0

    from torch.profiler import ProfilerActivity, profile

    it1, rp1 = st.n_decode_iterations, st.decode_graph_replays
    sync()
    counted0 = counted_launches()
    # the profiler places device records on the host's clock with an error
    # of up to a few ms, and drops those that land outside its trace: the
    # window is held kernel for kernel against the wrappers' counters, so the
    # trace runs TRACE_MARGIN_S on either side of the profiled calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        p0 = time.perf_counter()
        for _ in range(prof_calls):
            eng.step()
        sync()
        prof_wall = time.perf_counter() - p0
        time.sleep(TRACE_MARGIN_S)
    prof_iters = st.n_decode_iterations - it1
    counted = {k: v - counted0[k] for k, v in counted_launches().items()}
    prof_replays = st.decode_graph_replays - rp1

    # host time to enqueue one forward_core at the decode shape (no sync
    # inside): a batch of one token per sequence over distinct pages of the
    # engine's pool. Runs last, so the KV it writes touches no measured step.
    dev = eng.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    n_pages = -(-(prompt_len + 1) // ps)
    pts = np.full((batch, ecfg.max_pages_per_seq), -1, np.int32)
    pts[:, :n_pages] = np.arange(batch * n_pages).reshape(batch, n_pages)
    args = (t(rng.integers(0, 256, batch)), t(np.full(batch, prompt_len)),
            t(np.arange(batch)), t(pts), t(np.full(batch, prompt_len + 1)))
    host = []
    with torch.no_grad():
        for _ in range(5):
            sync()
            h0 = time.perf_counter()
            forward_core(cfg, eng.params, eng.cache, *args,
                         cu_q_lens=t(np.arange(batch + 1)), num_seqs=t([batch]),
                         attn_impl=eng._attn["decode"])
            host.append(time.perf_counter() - h0)
            sync()

    kernels = _kernel_rows(prof)
    host_ops = _host_rows(prof)
    calls_by_name = launch_calls(prof)
    busy_us = sum(r["device_us"] for r in kernels)
    launches = sum(r["count"] for r in kernels)
    attn_us = sum(r["device_us"] for r in kernels if "paged_attention" in r["name"])
    mla_us = sum(r["device_us"] for r in kernels if "mla_decode" in r["name"])
    merge_us = sum(r["device_us"] for r in kernels if "split_combine" in r["name"])
    gemm_us = sum(r["device_us"] for r in kernels if "grouped_gemm" in r["name"])
    wall_iter_ms = wall / max(iters, 1) * 1e3
    busy_iter_ms = busy_us / 1e3 / max(prof_iters, 1) if kernels else None
    return {
        "mode": "graph" if decode_graph else "eager", "quantize": quantize,
        "masked_decode_calls": eng.programs.counters().get("decode_masked", (0, 0))[0],
        "decode_graph_capture_s": st.decode_graph_capture_s,
        "batch": batch, "prompt_len": prompt_len, "decode_steps": decode_steps,
        "prefill_s": prefill_s, "prefill_tok_s": batch * prompt_len / prefill_s,
        "decode_iterations": iters, "decode_wall_s": wall,
        "decode_tok_s": batch * iters / wall, "wall_ms_per_iteration": wall_iter_ms,
        "host_enqueue_ms_per_forward": float(np.median(host)) * 1e3,
        "profiled_iterations": prof_iters, "profiled_wall_s": prof_wall,
        "profiled_graph_replays": prof_replays,
        # K1/K3/K2/K4 launches in the profiled window: the wrappers' counters
        # beside what ran on the device (equal unless a counter is wrong)
        "kernel_launches_counted": counted,
        "kernel_launches_on_device": device_launches(kernels),
        "device_busy_ms_per_iteration": busy_iter_ms,
        "device_busy_share_profiled": (busy_us / 1e6 / prof_wall) if kernels else None,
        "device_busy_share_vs_unprofiled_wall": (busy_iter_ms / wall_iter_ms)
        if kernels else None,
        "device_kernels_per_iteration": launches / max(prof_iters, 1) if kernels else None,
        "host_launch_calls_per_iteration": sum(calls_by_name.values()) / max(prof_iters, 1),
        "host_launch_calls": calls_by_name,
        "attention_share_of_device_time": attn_us / busy_us if busy_us else None,
        "mla_decode_share_of_device_time": mla_us / busy_us if busy_us else None,
        "split_merge_device_us_per_iteration": merge_us / max(prof_iters, 1),
        "grouped_gemm_share_of_device_time": gemm_us / busy_us if busy_us else None,
        **k1_host_us(eng, batch, prompt_len, seed),
        **k3_host_us(eng, batch, prompt_len, seed),
        **k2_host_us(cfg, eng.params, batch, seed),
        "moe_dispatch": eng.stats.moe_dispatch,
        "top_kernels": kernels[:12],
        "top_host_ops": host_ops[:12],
    }


def profile_unified(cfg, params, batch: int, prompt_len: int, images: int, seed: int,
                    windows: int = 2, device=None) -> dict:
    """The unified program over ``batch`` prompts of ``prompt_len`` tokens,
    the last ``images * mm_tokens`` of them media placeholders (rows from a
    seeded generator: the tower is not part of the step), one unified step a
    window, each window's prompts and media new (no prefix hit); the first
    window warms up, the rest run under ``torch.profiler``. Returns device
    kernels and busy ms per unified step and the host's wall a step."""
    from torch.profiler import ProfilerActivity, profile

    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine

    ps, k, n_tok = 16, cfg.mm_tokens, prompt_len
    ecfg = EngineConfig(page_size=ps, num_pages=batch * (n_tok // ps + 2) + 8,
                        max_model_len=max(4096, n_tok + 2), max_batch_size=batch,
                        prefill_chunk=n_tok, max_num_batched_tokens=batch * n_tok)
    eng = LLMEngine(cfg, ecfg, params=params, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    sp = SamplingParams(max_tokens=1, temperature=0.0)
    st = eng.stats

    # every window's prompts and rows made up front, outside the timed region
    reqs = [[(f"w{w}-r{i}",
              rng.integers(0, 256, n_tok - images * k).tolist()
              + [cfg.mm_placeholder_id] * (images * k),
              [(f"w{w}-r{i}-m{j}".encode(),
                rng.standard_normal((k, cfg.hidden_size)).astype(np.float32))
               for j in range(images)]) for i in range(batch)] for w in range(windows)]

    def window(w: int) -> None:
        for rid, prompt, items in reqs[w]:
            eng.add_request(rid, prompt, sp, mm_items=items)
        while eng.has_work():
            eng.step()

    window(0)
    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (lambda: None)
    sync()
    steps0 = st.n_unified_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        t0 = time.perf_counter()
        for w in range(1, windows):
            window(w)
        sync()
        wall = time.perf_counter() - t0
        time.sleep(TRACE_MARGIN_S)
    steps = max(st.n_unified_steps - steps0, 1)
    kernels = _kernel_rows(prof)
    return {"images": images, "batch": batch, "prompt_tokens": n_tok,
            "media_rows_per_step": batch * images * k * (windows - 1) // steps,
            "unified_steps": steps, "wall_ms_per_step": wall / steps * 1e3,
            "device_kernels_per_step": sum(r["count"] for r in kernels) / steps,
            "device_busy_ms_per_step": sum(r["device_us"] for r in kernels) / 1e3 / steps,
            "top_kernels": kernels[:12]}


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llama-1b")
    ap.add_argument("--batches", default="8,32")
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--prof-calls", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--moe-dispatch", default="auto", choices=("auto", "sorted", "einsum"))
    ap.add_argument("--quantize", default=None, choices=("int8",))
    ap.add_argument("--lora", type=int, default=0, help="test adapters spread over the rows")
    ap.add_argument("--images", type=int, default=0,
                    help="profile the unified program with this many media items a prompt")
    ap.add_argument("--out", default=None, help="also write the rows here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_engine: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.transformer import init_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    from llmd_tpu_torch.ops import grouped_gemm, mla_decode, paged_attention

    for mod in (paged_attention, grouped_gemm, mla_decode):  # before anything is timed
        print(f"kernel build {mod.__name__} s={mod.build():.3f}", flush=True)
    cfg = get_model_config(args.model)
    dev = torch.device("cuda", 0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    if args.images:
        if cfg.mm_tokens == 0:  # LLaVA-1.5's media tokens an item
            cfg = dataclasses.replace(cfg, mm_tokens=576, mm_placeholder_id=cfg.vocab_size - 1)
        rows = []
        for b in (int(x) for x in args.batches.split(",")):
            for images in (args.images, 0):
                r = profile_unified(cfg, params, b, args.prompt_len + args.images * cfg.mm_tokens,
                                    images, args.seed)
                r["card"] = smi
                rows.append(r)
                print(json.dumps({k: v for k, v in r.items() if k != "top_kernels"}),
                      flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"model": args.model, "rows": rows}, indent=1))
        return
    # warm-up pass (cuBLAS handles, lazy module loads), not reported
    for graph in (True, False):
        profile_batch(cfg, params, 2, 32, args.decode_steps, 1, 1, args.seed,
                      args.moe_dispatch, decode_graph=graph, quantize=args.quantize,
                      lora=args.lora)
    rows = []
    for b in (int(x) for x in args.batches.split(",")):
        for graph in (True, False):
            r = profile_batch(cfg, params, b, args.prompt_len, args.decode_steps,
                              args.calls, args.prof_calls, args.seed, args.moe_dispatch,
                              decode_graph=graph, quantize=args.quantize, lora=args.lora)
            r["card"] = smi
            rows.append(r)
            print(json.dumps({k: v for k, v in r.items()
                              if k not in ("top_kernels", "top_host_ops")}), flush=True)
            n = max(r["profiled_iterations"], 1)
            for k in r["top_kernels"][:6]:
                print(f"  device {k['device_us'] / n:9.1f} us/iter x{k['count']:5d}  "
                      f"{k['name']}", flush=True)
            for k in r["top_host_ops"][:8]:
                print(f"  host   {k['cpu_us'] / n:9.1f} us/iter x{k['count']:5d}  "
                      f"{k['name']}", flush=True)
            torch.cuda.empty_cache()
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"model": args.model, "moe_dispatch": args.moe_dispatch,
                                   "quantize": args.quantize, "lora": args.lora,
                                   "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
