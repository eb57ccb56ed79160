#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llmd_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--report PATH]

Phases, in order; each prints one line of numbers and any failure ends the run
with a non-zero exit:

1. device   the card's name and power limit (nvidia-smi); TF32 off.
2. build    nvcc builds every kernel of the main path from ``llmd_tpu_torch/csrc``.
3. check    each kernel against its plain PyTorch version on the card, at the
            main path's shapes (llama-1b heads), in float32 and bfloat16 (the
            bf16 kernel against the plain version in float32 on the same
            inputs, with two bf16-precision controls it must tell apart).
4. time     each kernel at the decode shape (CUDA events, median), beside its
            bound, its plain version and one PyTorch library call.
5. engine   llama-1b at full width (random bf16 weights from a seed) behind the
            port's HTTP server: 8 concurrent greedy completions. The kernels'
            launch counts are zeroed just before and read just after; the
            plain versions must not have run. Then one mixed unified batch runs
            through ``forward_core`` twice in float32, with the kernel and with
            the plain version, and the logits are held together.

It ends with a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. ``--report PATH`` also writes every phase's details (nvcc's register
report, per-check errors) as JSON. Without a CUDA device it exits 1 and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# H100 SXM data-sheet peaks (dense): HBM3 bytes/s, and FLOP/s by input type —
# bf16 on the tensor cores, float32 on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version, valid rows. float32: summation order and exp
# rounding only, max abs <= F32_ATOL. bfloat16: the kernel is held against the
# plain version run in float32 on the same bf16-rounded inputs, element by
# element in units of one bf16 rounding of the output
# (ops.paged_attention.bf16_rounding_units): float32 accumulation rounded once
# reads <= 1. Two controls must read above the limit (see phase_check).
F32_ATOL = 2e-5
BF16_UNITS = 1.0
# float32 forward through 16 layers, kernel vs plain attention: logits agree
# to summation order.
FORWARD_ATOL = 1e-3
H, HK, D, PS = 32, 8, 64, 16  # llama-1b attention: heads, kv heads, head dim, page


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# Attention inputs at the main path's shapes
# --------------------------------------------------------------------------


def make_attention_case(q_lens, kv_lens, dtype, device, seed, pad_rows=0,
                        pad_seqs=0):
    """Random q and pool, page tables over a shuffled page pool; sequence b's
    queries are its last q_lens[b] tokens. ``pad_rows`` trailing query rows and
    ``pad_seqs`` trailing unused table rows mimic the engine's padded packing."""
    rng = np.random.default_rng(seed)
    q_lens, kv_lens = np.asarray(q_lens), np.asarray(kv_lens)
    nb = len(q_lens)
    B = nb + pad_seqs
    maxp = int(max(-(-kv_lens // PS)))
    need = -(-kv_lens // PS)
    P = int(need.sum()) + 8
    perm = rng.permutation(P)
    pts = np.full((B, maxp), -1, np.int32)
    o = 0
    for b in range(nb):
        pts[b, : need[b]] = perm[o : o + need[b]]
        o += need[b]
    N = int(q_lens.sum()) + pad_rows
    pos = np.full((N,), -1, np.int32)
    sids = np.zeros((N,), np.int32)
    cu = np.zeros((B + 1,), np.int32)
    off = 0
    for b in range(nb):
        ql, kl = int(q_lens[b]), int(kv_lens[b])
        pos[off : off + ql] = np.arange(kl - ql, kl)
        sids[off : off + ql] = b
        off += ql
        cu[b + 1] = off
    cu[nb + 1 :] = off
    lens = np.ones((B,), np.int32)
    lens[:nb] = kv_lens
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((N, H, D), generator=g).to(device=device, dtype=dtype)
    pool = torch.randn((P, PS, 2 * HK, D), generator=g).to(device=device, dtype=dtype)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return dict(q=q, pool=pool, pts=t(pts), pos=t(pos), sids=t(sids),
                lens=t(lens), cu=t(cu), ns=t(np.array([nb], np.int32)),
                valid=off, q_lens=q_lens, kv_lens=kv_lens)


def run_attention(fn, c):
    return fn(c["q"], c["pool"], c["pts"], c["pos"], c["sids"], c["lens"],
              scale=D ** -0.5, cu_q_lens=c["cu"], num_seqs=c["ns"])


def decode_case(dtype, device, seed=1):
    rng = np.random.default_rng(seed)
    kv = rng.integers(128, 1025, 64)
    return make_attention_case(np.ones(64, int), kv, dtype, device, seed)


def mixed_case(dtype, device, seed=2):
    rng = np.random.default_rng(seed)
    q_lens = np.concatenate([[128, 128, 128], np.ones(32, int)])
    kv = np.concatenate([[128, 1000, 2048], rng.integers(1, 2049, 32)])
    return make_attention_case(q_lens, kv, dtype, device, seed, pad_rows=16,
                               pad_seqs=5)


def attention_bound(c, dtype):
    """(bound_ms, bound_by): each input byte read once, each output byte
    written once, KV only where this run's masks let it be read; flops of
    QK^T and PV over the keys each query attends."""
    elt = torch.finfo(dtype).bits // 8
    q_lens, kv_lens = c["q_lens"], c["kv_lens"]
    kv_bytes = int(kv_lens.sum()) * 2 * HK * D * elt
    qo_bytes = 2 * int(q_lens.sum()) * H * D * elt
    idx_bytes = 4 * (int((-(-kv_lens // PS)).sum()) + 2 * len(kv_lens) + 2)
    keys = sum(int(kl - ql + i + 1) for ql, kl in zip(q_lens, kv_lens) for i in range(ql))
    flops = 4 * H * D * keys
    t_bytes = (kv_bytes + qo_bytes + idx_bytes) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps=25, inner=10):
    """Median per-call device time over ``reps`` runs of ``inner`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def sdpa_dense(c):
    """The same decode attention as one ``scaled_dot_product_attention`` call
    over K/V gathered dense (a yardstick only; the port never calls it)."""
    pool, pts, kv_lens = c["pool"], c["pts"].long(), c["kv_lens"]
    B = len(kv_lens)
    S = pts.shape[1] * PS
    kv = pool[pts.clamp(min=0)].reshape(B, S, 2 * HK, D)
    k = kv[:, :, 0::2].transpose(1, 2).contiguous()  # [B, Hk, S, D]
    v = kv[:, :, 1::2].transpose(1, 2).contiguous()
    q = c["q"][: B].reshape(B, H, 1, D)
    key_pos = torch.arange(S, device=pool.device)
    lens = torch.from_numpy(np.asarray(kv_lens)).to(pool.device)
    mask = (key_pos[None, :] < lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
        return lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
    except TypeError:  # torch without enable_gqa: expand heads in set-up
        k = k.repeat_interleave(H // HK, dim=1)
        v = v.repeat_interleave(H // HK, dim=1)
        return lambda: sdpa(q, k, v, attn_mask=mask)


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(smi.splitlines()[0] if smi else "nvidia-smi: no card listed")
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device_name={name!r} count={torch.cuda.device_count()}")
    return {"nvidia_smi": smi, "kind": name, "count": torch.cuda.device_count()}


def phase_build() -> dict:
    from llmd_tpu_torch.native.build import load
    from llmd_tpu_torch.ops import paged_attention as pa

    seconds = pa.build()
    built = load("paged_attention")
    log(f"build: paged_attention.cu seconds={seconds:.3f} lib={built.path.name}")
    return {"paged_attention": {"seconds": seconds, "nvcc_log": built.log}}


def bf16_accumulating_control(c):
    """What a kernel with a bfloat16 P·V accumulator returns on the valid rows:
    float32 scores and softmax as in the plain version, the normalised P·V sum
    rounded to bfloat16 after every 32-key tile (the kernel's tile). Only for
    showing that the bfloat16 check tells such a kernel from a sound one."""
    q, pool = c["q"], c["pool"]
    pts, pos, sids, lens = c["pts"].long(), c["pos"].long(), c["sids"].long(), c["lens"].long()
    S = pts.shape[1] * PS
    key = torch.arange(S, device=q.device)
    outs = []
    for c0 in range(0, c["valid"], 32):
        b = sids[c0:min(c0 + 32, c["valid"])]
        n = b.shape[0]
        pt = pts[b]
        kv = pool[pt.clamp(min=0)].reshape(n, S, 2 * HK, D).float()
        s = torch.einsum("nkqd,nskd->nkqs", q[c0:c0 + n].float().reshape(n, HK, H // HK, D),
                         kv[:, :, 0::2]) * D ** -0.5
        mask = ((pt[:, key // PS] >= 0) & (key[None] <= pos[c0:c0 + n, None])
                & (key[None] < lens[b][:, None]))
        p = torch.softmax(s.masked_fill(~mask[:, None, None], -1e30), dim=-1)
        T = -(-S // 32)
        pad = T * 32 - S  # zero keys fill the last tile
        vt = torch.nn.functional.pad(kv[:, :, 1::2], (0, 0, 0, 0, 0, pad))
        part = torch.einsum("nkqtj,ntjkd->nkqtd",
                            torch.nn.functional.pad(p, (0, pad)).reshape(n, HK, H // HK, T, 32),
                            vt.reshape(n, T, 32, HK, D))
        acc = torch.zeros_like(part[:, :, :, 0], dtype=torch.bfloat16)
        for t in range(T):
            acc = (acc.float() + part[:, :, :, t]).to(torch.bfloat16)
        outs.append(acc.reshape(n, H, D))
    return torch.cat(outs)


def phase_check(device) -> dict:
    """float32: kernel vs plain version, max abs error. bfloat16: kernel vs the
    plain version in float32 on the same (upcast) bf16 inputs, in bf16 rounding
    units; beside it two controls on the same inputs that the check must
    reject: the plain version in bfloat16 (probabilities cast to bf16 before
    P·V) and a bfloat16 P·V accumulator."""
    from llmd_tpu_torch.ops.paged_attention import (
        bf16_rounding_units, paged_attention, paged_attention_ref)

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, make in (("decode", decode_case), ("mixed", mixed_case)):
            c = make(dtype, device)
            got = run_attention(paged_attention, c)
            torch.cuda.synchronize()
            c32 = dict(c, q=c["q"].float(), pool=c["pool"].float())
            ref = run_attention(paged_attention_ref, c32)
            torch.cuda.synchronize()
            v = c["valid"]
            err = (got[:v].float() - ref[:v]).abs().max().item()
            pad = got[v:].float().abs().max().item() if got.shape[0] > v else 0.0
            key = f"{label}_{str(dtype).split('.')[-1]}"
            row = {"max_abs_err": err, "pad_rows_max": pad, "tokens": int(c["q"].shape[0])}
            if dtype == torch.float32:
                row["atol"] = F32_ATOL
                ok = err <= F32_ATOL
                log(f"check: paged_attention {key} tokens={row['tokens']} "
                    f"max_abs_err={err:.3e} atol={F32_ATOL:.0e} pad_rows_max={pad:.1e}")
            else:
                units = bf16_rounding_units(got[:v], ref[:v])
                ctl_p = bf16_rounding_units(run_attention(paged_attention_ref, c)[:v], ref[:v])
                ctl_acc = bf16_rounding_units(bf16_accumulating_control(c), ref[:v])
                row.update(bf16_units=units, limit_units=BF16_UNITS,
                           control_p_bf16_units=ctl_p, control_acc_bf16_units=ctl_acc)
                ok = units <= BF16_UNITS < min(ctl_p, ctl_acc)
                log(f"check: paged_attention {key} tokens={row['tokens']} "
                    f"max_abs_err={err:.3e} bf16_units={units:.3f} (limit {BF16_UNITS}) "
                    f"controls: p_bf16={ctl_p:.1f} acc_bf16={ctl_acc:.1f} "
                    f"pad_rows_max={pad:.1e}")
            out[key] = row
            if not (ok and pad == 0.0 and torch.isfinite(got).all()):
                raise AssertionError(f"paged_attention {key}: the check failed: {row}")
    return out


def phase_time(device) -> dict:
    from llmd_tpu_torch.ops.paged_attention import paged_attention, paged_attention_ref

    dtype = torch.bfloat16
    c = decode_case(dtype, device)
    ms = cuda_ms(lambda: run_attention(paged_attention, c))
    plain_ms = cuda_ms(lambda: run_attention(paged_attention_ref, c), reps=5, inner=2)
    library_ms = cuda_ms(sdpa_dense(c))
    bound_ms, bound_by = attention_bound(c, dtype)
    row = {"shape": "decode B=64 q_len=1 kv_len 128-1024 bf16 (H32 Hk8 D64 ps16)",
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "kv_tokens": int(c["kv_lens"].sum())}
    log(f"time: paged_attention decode bf16 ms={ms:.4f} bound_ms={bound_ms:.4f} "
        f"({bound_by}) plain_ms={plain_ms:.4f} library_ms(sdpa dense)={library_ms:.4f} "
        f"roofline_share={bound_ms / ms:.3f}")
    return row


def _post(url: str, body: dict, timeout: float = 600.0) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(url: str) -> tuple[int, dict]:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def phase_engine(device, card: str, model: str = "llama-1b", n_requests: int = 8,
                 max_tokens: int = 32, prompt_range=(64, 512), seed: int = 0,
                 engine_kw: "dict | None" = None) -> dict:
    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.engine import EngineStats
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.ops.paged_attention import paged_attention, paged_attention_ref

    cfg = get_model_config(model)
    kw = dict(page_size=PS, num_pages=2048, max_model_len=2048, max_batch_size=32,
              prefill_chunk=512, max_num_batched_tokens=2048, decode_steps=4)
    kw.update(engine_kw or {})
    t0 = time.perf_counter()
    server = EngineServer(cfg, EngineConfig(**kw), host="127.0.0.1", port=0,
                          seed=seed, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    prompts = [bytes(rng.choice(letters, int(n))).decode()
               for n in rng.integers(prompt_range[0], prompt_range[1] + 1, n_requests)]
    server.start()
    try:
        base = f"http://{server.address}"
        assert _get(base + "/health") == (200, {"status": "ok"})
        # warm-up request (cuBLAS handles, allocator), not measured
        _post(base + "/v1/completions", {"prompt": "warm up", "max_tokens": 2,
                                         "temperature": 0})
        eng = server.engine
        eng.stats = EngineStats(attn_backend=eng.attn_backend)
        paged_attention.launches = 0
        paged_attention_ref.calls = 0
        results: list = [None] * n_requests

        def one(i: int) -> None:
            try:
                results[i] = _post(base + "/v1/completions", {
                    "model": server.model_name, "prompt": prompts[i],
                    "max_tokens": max_tokens, "temperature": 0})
            except Exception as e:  # noqa: BLE001 — reported below as a failed request
                results[i] = e

        t1 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(n_requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t1
        launches, ref_calls = paged_attention.launches, paged_attention_ref.calls
        st = eng.stats
    finally:
        server.stop()
    bad = [(i, r) for i, r in enumerate(results)
           if not (isinstance(r, tuple) and r[0] == 200)
           or not (r[1]["usage"]["completion_tokens"] == max_tokens
                   or r[1]["choices"][0]["finish_reason"] == "stop")]
    if bad:
        raise AssertionError(f"engine: failed requests {bad[:3]}")
    completion = sum(r[1]["usage"]["completion_tokens"] for r in results)
    prompt_toks = sum(r[1]["usage"]["prompt_tokens"] for r in results)
    expect = cfg.num_layers * (st.n_unified_steps + st.n_decode_iterations)
    row = {
        "card": card, "model": model, "requests": n_requests, "setup_s": setup_s,
        "wall_s": wall, "prompt_tokens": prompt_toks, "completion_tokens": completion,
        "output_tok_s": completion / wall,
        "prefill_tok_s": st.total_prefill_tokens / max(st.time_prefill_steps, 1e-9),
        "decode_tok_s": st.decode_tokens_fused / max(st.time_decode_steps, 1e-9),
        "unified_steps": st.n_unified_steps, "decode_calls": st.n_decode_calls,
        "decode_iterations": st.n_decode_iterations,
        "paged_attention_launches": launches, "paged_attention_ref_calls": ref_calls,
        "launches_per_decode_call": cfg.num_layers * max(1, kw["decode_steps"]),
        "engine_config": kw,
    }
    log(f"engine: {model} on {card}: {n_requests} requests wall_s={wall:.3f} "
        f"prefill_tok_s={row['prefill_tok_s']:.1f} decode_tok_s={row['decode_tok_s']:.1f} "
        f"output_tok_s={row['output_tok_s']:.1f} unified_steps={st.n_unified_steps} "
        f"decode_calls={st.n_decode_calls} launches={launches} ref_calls={ref_calls}")
    if device.type == "cuda" and not (launches > 0 and ref_calls == 0):
        raise AssertionError(f"engine: kernel launches {launches}, plain calls "
                             f"{ref_calls}: the main path did not run the kernel")
    if device.type == "cuda" and launches != expect:
        raise AssertionError(f"engine: {launches} launches, expected {expect} "
                             "(one per layer per forward)")
    return row


def phase_forward_check(device, model: str = "llama-1b", seed: int = 0) -> dict:
    """One mixed unified batch (two decode rows over resident KV, a fresh
    prefill chunk, a second chunk of a longer prompt) through forward_core in
    float32, once with the kernel's wrapper and once with the plain version."""
    import dataclasses

    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.transformer import (
        forward_core, init_cache, init_params, unembed)
    from llmd_tpu_torch.ops.paged_attention import paged_attention, paged_attention_ref

    cfg = dataclasses.replace(get_model_config(model), dtype="float32")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device)
    rng = np.random.default_rng(seed)
    P = 96
    lens_a = [300, 90, 200]  # resident before the mixed step
    pages = {}
    free = iter(rng.permutation(P).tolist())

    def table(b, n_tok):
        pages.setdefault(b, [])
        while len(pages[b]) * PS < n_tok:
            pages[b].append(next(free))

    def batch(rows):
        """rows: (seq, tokens, start) → flat batch tensors."""
        toks, pos, sids, cu = [], [], [], [0]
        pts = np.full((len(rows), 2048 // PS), -1, np.int32)
        lens = np.zeros((len(rows),), np.int32)
        for i, (b, tk, start) in enumerate(rows):
            table(b, start + len(tk))
            toks += tk
            pos += list(range(start, start + len(tk)))
            sids += [i] * len(tk)
            cu.append(cu[-1] + len(tk))
            pts[i, : len(pages[b])] = pages[b]
            lens[i] = start + len(tk)
        t = lambda a, dt=np.int32: torch.from_numpy(np.asarray(a, dt)).to(device)  # noqa: E731
        return (t(toks), t(pos), t(sids), t(pts), t(lens), t(cu),
                t([len(rows)]), np.asarray(cu))

    seqs = {b: rng.integers(0, cfg.vocab_size, n + 1).tolist() for b, n in enumerate(lens_a)}
    first = [(0, seqs[0][:300], 0), (1, seqs[1][:90], 0), (2, seqs[2][:200], 0)]
    e_tok = rng.integers(0, cfg.vocab_size, 128).tolist()
    mixed = [(0, seqs[0][300:301], 300), (1, seqs[1][90:91], 90),
             (3, e_tok, 0), (2, seqs[2][200:201], 200)]
    out = {}
    for name, impl in (("kernel", paged_attention), ("plain", paged_attention_ref)):
        cache = init_cache(cfg, P, PS, device=device)
        logits = []
        for rows in (first, mixed):
            toks, pos, sids, pts, lens, cu, ns, cu_np = batch(rows)
            hidden, cache = forward_core(cfg, params, cache, toks, pos, sids, pts,
                                         lens, cu_q_lens=cu, num_seqs=ns,
                                         attn_impl=impl)
            last = torch.from_numpy(cu_np[1:] - 1).to(device)
            logits.append(unembed(cfg, params, hidden[last]))
        out[name] = torch.cat(logits)
    diff = (out["kernel"] - out["plain"]).abs().max().item()
    agree = (out["kernel"].argmax(-1) == out["plain"].argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(out["kernel"]).all())
    log(f"forward: {model} float32 mixed batch rows={out['kernel'].shape[0]} "
        f"logits_max_abs_diff={diff:.3e} atol={FORWARD_ATOL:.0e} argmax_agree={agree:.3f}")
    if not (finite and diff <= FORWARD_ATOL and agree == 1.0):
        raise AssertionError(f"forward: kernel vs plain logits diff {diff}, "
                             f"argmax agreement {agree}, finite {finite}")
    return {"logits_max_abs_diff": diff, "argmax_agree": agree, "atol": FORWARD_ATOL}


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=None, help="write every phase's details here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    device = torch.device("cuda", 0)
    report: dict = {}
    report["device"] = dev = phase_device()
    card = dev["nvidia_smi"].splitlines()[0] if dev["nvidia_smi"] else dev["kind"]
    report["build"] = phase_build()
    report["check"] = phase_check(device)
    report["time"] = tm = phase_time(device)
    report["engine"] = eng = phase_engine(device, card)
    report["forward"] = phase_forward_check(device)
    if args.report:
        out = Path(args.report)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    bf16_err = max(v["max_abs_err"] for k, v in report["check"].items()
                   if k.endswith("bfloat16"))
    kernels = {"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "llmd_tpu_torch/csrc/paged_attention.cu",
        "replaces": "llmd_tpu/ops/paged_attention.py:106",
        "launches": eng["paged_attention_launches"], "max_abs_err": bf16_err,
        "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
