"""Rank-side checks of the mesh: functions every rank of a world runs with
the same arguments (``World.call("llmd_tpu_torch.parallel.checks:<name>",
...)``), each returning what rank 0 compares. ``chip_smoke.py`` runs them on
cards and the tests over gloo on the CPU.

- :func:`ep_dispatch`: the EP exchange (``ops/moe_dispatch.ep_moe``) from
  the whole banks, each rank on its own slots and its (dp, sp) part of the
  rows;
- :func:`ring_prefill`: ``ops/ring_attention.sp_flash_prefill``;
- :func:`forward_logits`: one prefill through ``forward_core`` on this
  rank's shards (tp / ep as the engine shards them) and its (dp, sp) part of
  the rows (``parallel/rows``), the gathered logits;
- :func:`collectives_in_graph`: ``all_reduce``, ``all_gather`` and
  ``all_to_all_single`` on the default group captured in one CUDA graph,
  replayed, against the same calls run eagerly (NCCL inside a graph).

Shard reads (``World.engine_call``, ``fn(engine, **kw)`` on every rank's
engine shard):

- :func:`lora_slot_sums`: each adapter leaf's absolute sum at one bank slot
  on this rank (0 everywhere: the slot is the null adapter);
- :func:`pool_pages`: this rank's planes of some pages, block-major, as
  their bytes;
- :func:`row_log`: the rows each op of this rank's engine ran through its
  dense layers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def _t(mesh, a, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
    return t.to(device=mesh.device, dtype=dtype if dtype is not None else t.dtype)


def _flat_split(mesh, n: int):
    """This rank's rows of an ``n``-row step split over (dp, sp) and the
    split (None when those axes hold one rank)."""
    from llmd_tpu_torch.parallel.rows import FLAT_AXES, RowSplit, flat_plan

    if mesh.size(FLAT_AXES) == 1:
        return np.arange(n), None
    plan = flat_plan(n, mesh.size(FLAT_AXES))
    return plan.parts[mesh.index(FLAT_AXES)], RowSplit(mesh, plan, mesh.device)


def ep_dispatch(mesh, x, idx, topw, valid, wi, wo, wi_scale=None, wo_scale=None,
                kernel: bool = False, bf16: bool = False) -> np.ndarray:
    """y [T, D] of the sorted dispatch over ``mesh`` (float32 numpy). Each
    rank keeps its 1/ep of the slots of the whole banks ``wi`` / ``wo``
    (and the int8 scales) and runs its (dp, sp) part of the rows, as the
    engine splits a step; the parts are gathered. ``kernel``: K2 (on
    cards); else its plain version. ``bf16``: activations and float banks in
    bfloat16."""
    from llmd_tpu_torch.ops import grouped_gemm as gg
    from llmd_tpu_torch.ops.moe_dispatch import make_sorted_dispatch

    ep, r = mesh.size("ep"), mesh.index("ep")
    Sl = np.asarray(wi).shape[0] // ep
    sl = slice(r * Sl, (r + 1) * Sl)
    dt = torch.bfloat16 if bf16 else torch.float32
    banks = [_t(mesh, w)[sl] for w in (wi, wo)]
    if wi_scale is None:
        banks = [b.to(dt) for b in banks]
        scales = [None, None]
    else:
        scales = [_t(mesh, s)[sl] for s in (wi_scale, wo_scale)]
    impl = make_sorted_dispatch(mesh, gemm=gg.ragged_grouped_gemm if kernel
                                else gg.ragged_grouped_gemm_ref)
    rows, split = _flat_split(mesh, np.asarray(x).shape[0])
    y = impl(*(_t(mesh, np.asarray(a)[rows], dt if a is x else None)
               for a in (x, idx, topw, valid)), *banks, *scales)
    if split is not None:
        y = split.gather(y)
    return y.float().cpu().numpy()


def ring_prefill(mesh, q, k, v, zigzag: bool = True, bf16: bool = False) -> np.ndarray:
    """``sp_flash_prefill`` of the whole sequence over ``mesh``'s sp axis
    (float32 numpy; ``bf16``: the inputs in bfloat16)."""
    import warnings

    from llmd_tpu_torch.ops.ring_attention import sp_flash_prefill

    dt = torch.bfloat16 if bf16 else torch.float32
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the contiguous degrade's warning
        out = sp_flash_prefill(_t(mesh, q, dt), _t(mesh, k, dt), _t(mesh, v, dt), mesh,
                               zigzag=zigzag)
    return out.float().cpu().numpy()


def forward_logits(mesh, model_cfg, params: dict, tokens, page_size: int = 8,
                   quantize: Optional[str] = None, kv_cache_dtype: Optional[str] = None,
                   attn_impl=None) -> np.ndarray:
    """The logits [N, V] (float32 numpy) of one fresh sequence ``tokens``,
    prefilled in one chunk through ``forward_core`` on this rank's shards:
    ``params`` (the whole model, numpy or tensors) quantized first under
    ``quantize="int8"``, then sharded as the engine shards them; this rank
    runs its (dp, sp) part of the rows (``parallel/rows.local_batch``) and
    the logits are gathered over the split."""
    from llmd_tpu_torch.models.quant import quantize_params
    from llmd_tpu_torch.models.transformer import forward_core, init_cache, unembed
    from llmd_tpu_torch.ops.moe_dispatch import make_sorted_dispatch
    from llmd_tpu_torch.ops.paged_attention import paged_attention
    from llmd_tpu_torch.parallel.mesh import engine_rules, param_logical_axes, shard_params
    from llmd_tpu_torch.parallel.rows import local_batch

    dev = mesh.device
    p = {k: _t(mesh, v) for k, v in params.items()}
    p = {k: v if k.endswith(("_q", "_scale")) else v.to(model_cfg.torch_dtype)
         for k, v in p.items()}
    if quantize == "int8":
        p = quantize_params(model_cfg, p)
    p = shard_params(p, mesh, param_logical_axes(model_cfg),
                     engine_rules(model_cfg, mesh.size("ep"), eplb=False))
    whole = model_cfg.is_moe and model_cfg.moe_num_experts % mesh.size("ep") != 0
    toks = np.asarray(tokens, np.int32)
    N = toks.shape[0]
    pages = -(-N // page_size)
    cache = init_cache(model_cfg, pages + 1, page_size, device=dev, tp=mesh.size("tp"),
                       dtype=torch.float8_e4m3fn if kv_cache_dtype == "fp8" else None)
    pt = np.full((1, pages + 1), -1, np.int32)
    pt[0, :pages] = np.arange(pages)
    batch = {"tokens": toks, "positions": np.arange(N, dtype=np.int32),
             "seq_slots": np.zeros((N,), np.int32), "page_tables": pt,
             "kv_lens": np.array([N], np.int32), "cu_q_lens": np.array([0, N], np.int32)}
    rows, split = _flat_split(mesh, N)
    b = {k: _t(mesh, v) for k, v in local_batch(batch, rows, ()).items()}
    hidden, _, _, _ = forward_core(
        model_cfg, p, cache, b["tokens"], b["positions"], b["seq_slots"], b["page_tables"],
        b["kv_lens"], cu_q_lens=b["cu_q_lens"], num_seqs=b["num_seqs"],
        attn_impl=attn_impl or paged_attention,
        moe_dispatch_impl=make_sorted_dispatch(mesh) if not whole else None, mesh=mesh,
        moe_rows=(_t(mesh, rows.astype(np.int64)), N), rows=split)
    logits = unembed(model_cfg, p, hidden, mesh)
    if split is not None:
        logits = split.gather(logits)
    return logits.float().cpu().numpy()


def collectives_in_graph(mesh=None, n: int = 4096, replays: int = 3) -> dict:
    """``all_reduce`` / ``all_gather_into_tensor`` / ``all_to_all_single`` on
    the default group (any world size, one rank included), run eagerly and
    captured into one CUDA graph on this rank's card, the graph replayed
    ``replays`` times on fresh inputs: the largest difference between
    replayed and eager results (0.0 when they agree), and the world size."""
    from llmd_tpu_torch.parallel.mesh import _all_gather_single

    del mesh
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.empty((world * n,), dtype=torch.float32, device=dev)

    def run():
        a = x.clone()
        dist.all_reduce(a)
        g = torch.empty((world * x.numel(),), dtype=x.dtype, device=dev)
        _all_gather_single(g, x, None)
        t = torch.empty_like(x)
        dist.all_to_all_single(t, x)
        return a, g, t

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        x.copy_(torch.arange(x.numel(), device=dev, dtype=torch.float32) + rank)
        run()  # warm-up on the side stream: communicators made outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    worst = 0.0
    for i in range(replays):
        x.copy_(torch.randn(x.numel(), generator=torch.Generator(dev).manual_seed(i + rank),
                            device=dev))
        graph.replay()
        want = run()
        torch.cuda.synchronize(dev)
        worst = max(worst, *(float((a - b).abs().max()) for a, b in zip(out, want)))
    return {"world": world, "max_abs_diff": worst}


def lora_slot_sums(engine, slot: int) -> dict[str, float]:
    """|leaf| summed over bank slot ``slot`` of this rank's adapter bank."""
    return {k: float(b[:, :, slot].abs().sum() if k.startswith("lora_A_")
                     else b[:, slot].abs().sum())
            for k, b in sorted(engine._lora_params.items())}


def pool_pages(engine, pids: list) -> np.ndarray:
    """This rank's planes of pages ``pids`` (``[n, L, ps, planes, D]``) as
    uint8 bytes, read from its own pool shard."""
    from llmd_tpu_torch.disagg.transfer import gather_pages

    part = gather_pages(engine.cache, list(pids), engine.cfg.num_pages)
    return part.view(torch.uint8).cpu().numpy()


def row_log(engine) -> list:
    """(program, the step's rows, the rows this rank ran through its dense
    layers) of each op of this rank's engine since it was built."""
    return list(engine._row_log)
