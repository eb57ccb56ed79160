"""Decoder over a paged KV cache, GQA or absorbed MLA, dense or MoE (port of
``llmd_tpu/models/transformer.py``), in PyTorch.

Layout and semantics follow the reference so parity tests compare like with
like:

- Parameters are a dict of stacked tensors with the reference's names and
  shapes (``wq [L, D, H, Dh]``, ``wi [L, D, 2F]`` fused gate+up, MoE
  ``router [L, D, E]``, ``moe_wi [L, E, D, 2Fe]``, ...).
- The KV cache is ONE flat pool ``[L*P, page_size, 2*Hk, Dh]`` with the layer
  folded into the page dimension (layer ``l``'s page ``p`` at row ``l*P + p``)
  and K/V interleaved per head (K at plane 2h, V at 2h+1). An MLA model's
  pool has one plane, ``[L*P, page_size, 1, r + dr]``: the shared latent row
  ``[c_kv ; k_rope]`` that absorbed attention reads as both K and V. Unlike
  the reference, the width is NOT padded to 128 lanes: that padding is a TPU
  tile rule, and the packed layout that wins it back has no use here.
- ``forward_core`` runs a flat mixed batch (prefill chunks + decode tokens,
  described by ``cu_q_lens``/``num_seqs``) through the layers in a Python
  loop — the counterpart of the reference's ``lax.scan`` — and writes K/V
  into the pool IN PLACE (the reference's donated-buffer update).
- Attention is the kernel's wrapper ``ops/paged_attention.paged_attention``
  (GQA, and MLA's single-plane latent pool in the unified program; the
  engine's decode program passes ``ops/mla_decode.mla_paged_attention_latent``
  for MLA) and the MoE expert GEMMs are the kernels' wrappers of
  ``ops/grouped_gemm`` (the CUDA kernels for CUDA tensors, their plain
  versions for CPU tensors). Any impl with the same signature can be passed
  instead; only the kernel-vs-plain checks do.

Serves dense and MoE configs, GQA or MLA, with Qwen2's q/k/v(/o) biases
(``attn_bias``) and Qwen3's per-head q/k RMSNorm (``qk_norm``), and int8
weight-only params (``<key>_q`` int8 and ``<key>_scale`` float32 leaves from
``models/quant.quantize_params``): every weight product goes through
:func:`linear`, the counterpart of the reference's ``_mm``. int8 expert banks
run plain products with their scales (the sorted dispatch's block-gathered
experts, or the scaled capacity einsum), never the grouped-GEMM kernels, as
the reference gives them to XLA. Vision towers and LoRA raise
``NotImplementedError`` naming the ROADMAP Queue A item that brings them;
LoRA on MLA raises as in the reference (the absorbed path has no adapter
hook), and MLA excludes qk-norm and biases as the reference does.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from llmd_tpu_torch.models.config import ModelConfig
from llmd_tpu_torch.models.quant import CONTRACT_AXES, QUANTIZABLE_LAYER_KEYS
from llmd_tpu_torch.ops.grouped_gemm import grouped_gemm
from llmd_tpu_torch.ops.moe_dispatch import make_sorted_dispatch
from llmd_tpu_torch.ops.paged_attention import paged_attention

# the default MoE dispatch: token-sorted, drop-free, expert GEMMs through K2
SORTED_DISPATCH = make_sorted_dispatch()


def check_supported(cfg: ModelConfig, lora: bool = False) -> None:
    """Raise for architectures the port does not serve (``lora``: the params
    carry LoRA adapters)."""
    if lora and cfg.is_mla:
        raise NotImplementedError(
            f"{cfg.name}: LoRA adapters are unsupported on MLA models (no adapter "
            "hook in the absorbed path)")
    if lora:
        raise NotImplementedError("LoRA params are ROADMAP Queue A item 7")
    if cfg.mm_tokens > 0 or cfg.has_vision:
        raise NotImplementedError(f"{cfg.name}: vision is ROADMAP Queue A item 7")
    if cfg.is_mla and (cfg.qk_norm or cfg.attn_bias):
        raise NotImplementedError(f"{cfg.name}: MLA excludes qk_norm/attn_bias")


def param_shapes(cfg: ModelConfig, quantized: bool = False) -> dict[str, tuple[int, ...]]:
    """Leaf shapes of the param dict. ``quantized``: the int8 weight-only
    layout of ``models/quant.quantize_params`` (each quantizable ``<key>``
    as ``<key>_q`` of the same shape and ``<key>_scale`` over its output
    axes, and ``unembed_q [D, V]`` / ``unembed_scale [V]`` in place of any
    ``unembed``)."""
    L, D, H, Hk, Dh = (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    Fi = cfg.intermediate_size
    shapes = {
        "embed": (cfg.vocab_size, D), "final_norm": (D,),
        "attn_norm": (L, D), "mlp_norm": (L, D),
    }
    if cfg.is_mla:  # no wk/wv: the pool stores the shared latent once per token
        r, dr = cfg.mla_kv_lora_rank, cfg.mla_rope_dim
        dn, dv = cfg.mla_qk_nope_dim, cfg.mla_v_head_dim
        shapes |= {"mla_wq": (L, D, H, dn + dr), "mla_wdkv": (L, D, r),
                   "mla_wkr": (L, D, dr), "mla_kv_norm": (L, r),
                   "mla_wuk": (L, H, dn, r), "mla_wuv": (L, H, r, dv),
                   "wo": (L, H, dv, D)}
    else:
        shapes |= {"wq": (L, D, H, Dh), "wk": (L, D, Hk, Dh), "wv": (L, D, Hk, Dh),
                   "wo": (L, H, Dh, D)}
    if cfg.is_moe:
        E, Fe = cfg.moe_num_experts, cfg.moe_intermediate_size or Fi
        shapes |= {"router": (L, D, E), "moe_wi": (L, E, D, 2 * Fe),
                   "moe_wo": (L, E, Fe, D)}
        if cfg.moe_num_shared_experts:
            Fs = Fi * cfg.moe_num_shared_experts
            shapes |= {"shared_wi": (L, D, 2 * Fs), "shared_wo": (L, Fs, D)}
    else:
        shapes |= {"wi": (L, D, 2 * Fi),  # fused gate+up (SwiGLU)
                   "wo_mlp": (L, Fi, D)}
    if cfg.qk_norm:
        shapes |= {"q_norm": (L, Dh), "k_norm": (L, Dh)}
    if cfg.attn_bias:
        shapes |= {"bq": (L, H, Dh), "bk": (L, Hk, Dh), "bv": (L, Hk, Dh), "bo": (L, D)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (D, cfg.vocab_size)
    if not quantized:
        return shapes
    for key in QUANTIZABLE_LAYER_KEYS:
        if key in shapes:
            shape = shapes.pop(key)
            shapes[key + "_q"] = shape
            shapes[key + "_scale"] = tuple(n for i, n in enumerate(shape)
                                           if i not in CONTRACT_AXES[key])
    shapes.pop("unembed", None)
    shapes |= {"unembed_q": (D, cfg.vocab_size), "unembed_scale": (cfg.vocab_size,)}
    return shapes


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: "torch.device | str | None" = None) -> dict[str, torch.Tensor]:
    """Random-init params (scaled normal, the reference's scales) drawn from
    ``generator``; made on the generator's device, then moved to ``device``."""
    check_supported(cfg)
    dt = cfg.torch_dtype
    gen_dev = generator.device
    device = torch.device(device) if device is not None else gen_dev
    shapes = param_shapes(cfg)
    D, H, Dh, Fi = cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.intermediate_size
    Fe = cfg.moe_intermediate_size or Fi
    Fs = Fi * cfg.moe_num_shared_experts
    scales = {"embed": 0.02, "wq": D ** -0.5, "wk": D ** -0.5, "wv": D ** -0.5,
              "wo": (H * Dh) ** -0.5, "wi": D ** -0.5, "wo_mlp": Fi ** -0.5,
              "router": D ** -0.5, "moe_wi": D ** -0.5, "moe_wo": Fe ** -0.5,
              "shared_wi": D ** -0.5, "shared_wo": max(Fs, 1) ** -0.5,
              "unembed": D ** -0.5}
    if cfg.is_mla:
        scales |= {"mla_wq": D ** -0.5, "mla_wdkv": D ** -0.5, "mla_wkr": D ** -0.5,
                   "mla_wuk": cfg.mla_qk_nope_dim ** -0.5,
                   "mla_wuv": cfg.mla_kv_lora_rank ** -0.5,
                   "wo": (H * cfg.mla_v_head_dim) ** -0.5}
    params: dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        if name.endswith("norm"):  # attn/mlp/final/q/k norms and mla_kv_norm: ones
            params[name] = torch.ones(shape, dtype=dt, device=device)
            continue
        if name in ("bq", "bk", "bv", "bo"):  # biases: zeros, as the reference's
            params[name] = torch.zeros(shape, dtype=dt, device=device)
            continue
        w = torch.randn(shape, generator=generator, device=gen_dev,
                        dtype=torch.float32) * scales[name]
        params[name] = w.to(device=device, dtype=dt)
    return params


def params_from_numpy(cfg: ModelConfig, np_params: dict,
                      device: "torch.device | str" = "cpu") -> dict[str, torch.Tensor]:
    """The reference's param dict (numpy arrays, ``llmd_tpu`` ``init_params``
    layout, plain or int8 weight-only) as this package's tensors. bf16
    arrays come out of JAX as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects: every float array goes through float32,
    then to the config's dtype. int8 leaves stay int8 and scales float32."""
    check_supported(cfg, lora=any(k.startswith("lora_") for k in np_params))
    shapes = param_shapes(cfg, quantized=any(k.endswith("_q") for k in np_params))
    extra = sorted(set(np_params) - set(shapes))
    if extra:
        raise NotImplementedError(
            f"params {extra} are not served by the port (LoRA adapters are "
            "ROADMAP Queue A item 7)")
    out: dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        q8 = name.endswith("_q")
        a = np.array(np_params[name], dtype=np.int8 if q8 else np.float32)  # a writable copy
        if a.shape != shape:
            raise ValueError(f"param {name}: shape {a.shape} != {shape}")
        dt = (torch.int8 if q8 else
              torch.float32 if name.endswith("_scale") else cfg.torch_dtype)
        out[name] = torch.from_numpy(a).to(device=device, dtype=dt)
    return out


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 variance, cast back to the input dtype, THEN scale by ``w``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [..., T, 1, half] for the half-split rotation."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., T, H, Dh]; positions: [..., T]."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return apply_rope(x, cos, sin)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """Fused gate/up MLP: ``wi [D, 2F]`` holds gate then up."""
    gate, up = (x @ wi).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ wo


def linear(params: dict[str, torch.Tensor], key: str, l: int, x: torch.Tensor) -> torch.Tensor:
    """``x [N, K]`` times layer ``l``'s weight ``key`` flattened to ``[K, out]``.
    An int8 weight-only model carries ``<key>_q`` and ``<key>_scale`` instead
    (``models/quant.py``): the product is the reference's ``_mm``,
    ``(x @ q.to(x.dtype)) * s.to(x.dtype)``, in that order (the
    per-output-channel scale commutes out of the dot)."""
    K = x.shape[-1]
    w = params.get(key)
    if w is not None:
        return x @ w[l].reshape(K, -1)
    y = x @ params[key + "_q"][l].reshape(K, -1).to(x.dtype)
    return y * params[key + "_scale"][l].reshape(-1).to(x.dtype)


def swiglu_layer(params: dict[str, torch.Tensor], wi: str, wo: str, l: int,
                 x: torch.Tensor) -> torch.Tensor:
    """:func:`swiglu` over layer ``l``'s weights ``wi``/``wo``, plain or int8."""
    gate, up = linear(params, wi, l, x).chunk(2, dim=-1)
    return linear(params, wo, l, F.silu(gate) * up)


def moe_block(
    cfg: ModelConfig,
    x: torch.Tensor,  # [T, D]
    router: torch.Tensor,  # [D, E]
    wi: torch.Tensor,  # [S, D, 2Fe] (S = E, or the EPLB physical slots)
    wo: torch.Tensor,  # [S, Fe, D]
    eplb: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    matmul_impl: Callable = grouped_gemm,
    token_mask: Optional[torch.Tensor] = None,  # [T] bool
    dispatch_impl: Optional[Callable] = SORTED_DISPATCH,
    rows: Optional[tuple[torch.Tensor, int]] = None,
    wi_scale: Optional[torch.Tensor] = None,  # [S, 2Fe] float32: wi/wo are int8 banks
    wo_scale: Optional[torch.Tensor] = None,  # [S, D]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routed MoE (port of the reference's ``moe_block``).

    Routing stays here for both paths, so both see the same decisions: f32
    router logits, softmax, top-k, renormalised with ``+1e-9``; masked tokens
    (``token_mask`` False) neither count nor consume capacity.

    ``eplb = (replica_slots [E, R], replica_counts [E])``: ``wi``/``wo`` hold
    the physical slot weights and copy j of token t goes to replica
    ``(t + j) % replica_counts`` of its expert.

    ``dispatch_impl(x, idx, topw, valid, wi, wo, wi_scale, wo_scale) -> y``
    is the token-sorted drop-free path (``ops/moe_dispatch``, the default).
    ``None`` selects the capacity-einsum path: ``C = max(1,
    int(t·k/S·moe_capacity_factor))`` slots per expert, copies past C
    dropped, expert GEMMs through ``matmul_impl(xe [S, C, D], w, slot_counts
    [S])`` (K4's wrapper), or, for int8 banks (``wi_scale``/``wo_scale``
    given), plain batched products times the per-expert per-output-channel
    scales (the reference runs int8 banks on XLA, not its kernel).

    ``rows = (row_ids [T] int64, size)`` places the T rows in the reference's
    static batch of ``size`` rows (the reference pads its unified batch to the
    token budget, real rows first, and its decode batch to every slot, row =
    slot). The replica choice uses ``row_ids`` for ``t``; the einsum path runs
    on the padded batch (its C, cumsum order and DBO halves depend on it), so
    its drops equal the reference's. Default: ``arange(T)``, size T.

    ``cfg.moe_dbo`` runs two half batches (split at half the static size).
    Returns (y [T, D], logical expert counts [E] int32, dropped copies int32
    scalar; 0 on the sorted path)."""
    T, D = x.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    dev = x.device
    weights = torch.softmax(x.float() @ router.float(), dim=-1)
    topw, topi = torch.topk(weights, k, dim=-1)  # [T, k]
    topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-9)
    valid = (token_mask.to(torch.int32)[:, None] if token_mask is not None
             else torch.ones((T, 1), dtype=torch.int32, device=dev))
    counts = torch.zeros((E,), dtype=torch.int32, device=dev).scatter_add_(
        0, topi.reshape(-1), valid.expand(T, k).reshape(-1))
    row_ids, size = rows if rows is not None else (torch.arange(T, device=dev), T)

    if eplb is not None:
        replica_slots, replica_counts = eplb
        S = wi.shape[0]
        rc = replica_counts.long()[topi]  # [T, k]
        choice = (row_ids.long()[:, None] + torch.arange(k, device=dev)[None, :]) % rc
        idx = replica_slots.long()[topi, choice]  # [T, k] physical slot ids
    else:
        S, idx = E, topi

    def halves(fn, *args):
        """``fn`` on the whole batch, or on its two DBO halves."""
        t = args[0].shape[0]
        if cfg.moe_dbo and t % 2 == 0 and t >= 2:
            h = t // 2
            (ya, ka), (yb, kb) = fn(*(a[:h] for a in args)), fn(*(a[h:] for a in args))
            return torch.cat([ya, yb]), ka + kb
        return fn(*args)

    if dispatch_impl is not None:
        def sorted_half(x, idx, topw, valid):
            return dispatch_impl(x, idx, topw, valid, wi, wo, wi_scale, wo_scale), 0

        y, _ = halves(sorted_half, x, idx, topw, valid)
        return y, counts, torch.zeros((), dtype=torch.int32, device=dev)

    def einsum_half(x, idx, topw, valid):
        t = x.shape[0]
        C = max(1, int(t * k / S * cfg.moe_capacity_factor))
        onehot = F.one_hot(idx, S).to(torch.int32) * valid[..., None]  # [t, k, S]
        flat = onehot.reshape(t * k, S)
        pos_in_expert = (torch.cumsum(flat, 0) - flat).reshape(t, k, S)
        pos = pos_in_expert.gather(2, idx[..., None])[..., 0]  # [t, k] own slot
        keep = (pos < C) & (valid > 0)  # [t, k]
        # kept copy -> row slot*C + pos of the [S*C] expert buffer; the rest
        # -> the dump row S*C (sliced off)
        dst = torch.where(keep, idx * C + pos, S * C).reshape(-1)
        tok = torch.arange(t * k, device=dev) // k
        xe = x.new_zeros((S * C + 1, D)).index_copy_(0, dst, x[tok])[: S * C]
        if wi_scale is None:
            slot_counts = (onehot * keep[..., None]).sum(dim=(0, 1)).to(torch.int32)
            gate, up = matmul_impl(xe.view(S, C, D), wi, slot_counts).chunk(2, dim=-1)
            ye = matmul_impl(F.silu(gate) * up, wo, slot_counts).reshape(S * C, D)
        else:
            dt = x.dtype
            gate_up = torch.bmm(xe.view(S, C, D), wi.to(dt)) * wi_scale[:, None, :].to(dt)
            gate, up = gate_up.chunk(2, dim=-1)
            ye = (torch.bmm(F.silu(gate) * up, wo.to(dt))
                  * wo_scale[:, None, :].to(dt)).reshape(S * C, D)
        g = torch.cat([ye, ye.new_zeros((1, D))])[dst].float()
        wt = (topw.to(x.dtype) * keep).float().reshape(-1, 1)
        y = (g * wt).view(t, k, D).sum(dim=1).to(x.dtype)
        return y, keep.sum().to(torch.int32)

    if size != T:  # scatter into the reference's static batch; the rest masked
        def pad(a):
            return a.new_zeros((size, *a.shape[1:])).index_copy_(0, row_ids.long(), a)

        y, kept = halves(einsum_half, pad(x), pad(idx), pad(topw), pad(valid))
        y = y[row_ids.long()]
    else:
        y, kept = halves(einsum_half, x, idx, topw, valid)
    return y, counts, counts.sum().to(torch.int32) - kept


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, num_pages: int, page_size: int,
               dtype: Optional[torch.dtype] = None,
               device: "torch.device | str | None" = None) -> torch.Tensor:
    """[L*P + 1, page_size, 2*Hk, Dh] flat pool: layer l's page p at row
    l*P + p; K at plane 2h, V at 2h+1; unpadded head dim. MLA: one plane of
    the unpadded latent width, [L*P + 1, page_size, 1, r + dr].

    The last page, L*P, is the dump page: no page table reaches it, and the
    K/V writes of padding rows (position -1) land in its last row, the dump
    row (:func:`write_kv`, :func:`forward_core`). So a write needs no host
    read to find its real rows (the reference drops them with
    ``mode="drop"``).

    ``dtype`` overrides the model dtype for the pool: ``torch.float8_e4m3fn``
    halves decode's KV read stream (``EngineConfig.kv_cache_dtype="fp8"``);
    the attention kernels read fp8 pages and their plain versions upcast
    at use."""
    planes = 1 if cfg.is_mla else 2 * cfg.num_kv_heads
    return torch.zeros(
        (cfg.num_layers * num_pages + 1, page_size, planes, cfg.kv_cache_head_dim),
        dtype=dtype if dtype is not None else cfg.torch_dtype, device=device)


# float8_e4m3fn has no inf: the reference's cast turns values past +-448 into
# nan, torch's saturates; writes clamp first (as the reference's write_kv),
# so the stored bytes depend on neither library's overflow.
_FP8_MAX = 448.0


def _write_rows(flat_cache: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                slots: torch.Tensor) -> None:
    n, hk, d = k.shape
    if flat_cache.shape[1] == 1:  # single-plane MLA pool: k IS the latent row; v unused
        kv = k
    else:
        kv = torch.stack([k, v], dim=2).reshape(n, 2 * hk, d)
    if flat_cache.dtype == torch.float8_e4m3fn:
        # index_copy_ takes no fp8 (on the CPU): the same bytes through uint8 views
        kv = kv.float().clamp(-_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn)
        flat_cache.view(torch.uint8).index_copy_(0, slots.long(), kv.view(torch.uint8))
    else:
        flat_cache.index_copy_(0, slots.long(), kv.to(flat_cache.dtype))


def write_kv(flat_cache: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             slots: torch.Tensor) -> torch.Tensor:
    """Write new tokens' K/V into flat cache slots, in place.

    flat_cache: [S, 2*Hk, D], the pool viewed as token slots, its last row
    S - 1 the dump row (:func:`init_cache`); k/v: [N, Hk, D]; slots: [N]
    global slot ids. Slot -1 marks padding and is written to the dump row,
    with no host read. A single-plane pool [S, 1, D] takes k [N, 1, D] (the
    latent row) and ignores v. An fp8 pool stores the rows clamped to
    +-448, then cast to ``float8_e4m3fn`` (unit scale), as the reference."""
    _write_rows(flat_cache, k, v, torch.where(slots >= 0, slots, flat_cache.shape[0] - 1))
    return flat_cache


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward_core(
    cfg: ModelConfig,
    params: dict[str, torch.Tensor],
    cache: torch.Tensor,  # [L*P+1, ps, 2*Hk, Dh] / MLA [L*P+1, ps, 1, r+dr] (updated in place)
    tokens: torch.Tensor,  # [N] flat mixed batch
    positions: torch.Tensor,  # [N] (-1 pad)
    seq_slots: torch.Tensor,  # [N] owning batch row (page lookup / masks)
    page_tables: torch.Tensor,  # [B, max_pages] int32 (-1 unmapped)
    kv_lens: torch.Tensor,  # [B] cache length AFTER this step's tokens
    cu_q_lens: Optional[torch.Tensor] = None,  # [B+1] (kernel path)
    num_seqs: Optional[torch.Tensor] = None,  # [1] (kernel path)
    attn_impl: Callable = paged_attention,
    moe_dispatch_impl: Optional[Callable] = SORTED_DISPATCH,
    moe_matmul_impl: Callable = grouped_gemm,
    moe_rows: Optional[tuple[torch.Tensor, int]] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run a flat mixed batch through the model, writing K/V into the pool.

    MoE layers route through ``moe_block``: the sorted dispatch by default,
    the capacity einsum with ``moe_dispatch_impl=None``; ``moe_rows`` places
    the rows in the reference's static batch (see ``moe_block``). Physical
    EPLB slot weights arrive in ``params`` under the logical names, with
    ``eplb_replica_slots``/``eplb_replica_counts`` beside them.

    Returns (hidden [N, D] final-normed, cache, expert_counts [L, E] int32
    ([L, 0] for a dense model), dropped copies int32 scalar). Callers unembed
    only the rows they need. Padding rows write their K/V to the pool's dump
    row (:func:`init_cache`): no host read anywhere, so the decode program
    that runs it can be captured into a CUDA graph."""
    check_supported(cfg)
    N = tokens.shape[0]
    Ptot, ps, HkC, Dh = cache.shape
    L, D, H, Hk = cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads
    if (Ptot - 1) % L:
        raise ValueError(f"forward_core: a pool of {Ptot} pages is not L*P pages and the "
                         "dump page: allocate it with init_cache")
    P = (Ptot - 1) // L  # pages per layer
    B = page_tables.shape[0]
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)  # [N, D]

    # global slot ids of the new tokens, layer l's at page_table[seq, pos //
    # ps] * ps + pos % ps + l*P*ps; padding rows (position -1) at the dump
    # row, the last of the dump page
    valid = positions >= 0
    b = seq_slots.long().clamp(0, B - 1)
    pos0 = torch.where(valid, positions, 0).long()
    safe_page = torch.where(page_tables >= 0, page_tables, 0).long()[b, pos0 // ps]
    flat = cache.view(Ptot * ps, HkC, Dh)
    layer_base = torch.arange(L, device=x.device)[:, None] * (P * ps)
    dst = torch.where(valid[None, :], (safe_page * ps + pos0 % ps)[None, :] + layer_base,
                      Ptot * ps - 1)  # [L, N]
    if cfg.is_mla:
        # absorbed MLA: MQA over the latent row [c ; k_rope]; RoPE turns only
        # the dr rope dims, so its tables are built at dr, not head_dim
        r, dr, dn = cfg.mla_kv_lora_rank, cfg.mla_rope_dim, cfg.mla_qk_nope_dim
        Dv = cfg.mla_v_head_dim
        cos, sin = rope_tables(positions, dr, cfg.rope_theta)
        scale = (dn + dr) ** -0.5
    else:
        Dv = Dh
        cos, sin = rope_tables(positions, Dh, cfg.rope_theta)
        scale = Dh ** -0.5
    eplb = params.get("eplb_replica_slots"), params.get("eplb_replica_counts")
    counts, dropped = [], []

    for l in range(L):
        h = rms_norm(x, params["attn_norm"][l], cfg.rms_eps)
        if cfg.is_mla:
            # scores: q_nope·(W_UK c) + q_rope·k_rope == (W_UK^T q_nope)·c +
            # q_rope·k_rope; the values are the latents, re-expanded per head
            # through W_UV after the weighted sum (the reference's :619-643)
            q = (h @ params["mla_wq"][l].reshape(D, -1)).view(N, H, dn + dr)
            q_rope = apply_rope(q[..., dn:], cos, sin)
            c = rms_norm(h @ params["mla_wdkv"][l], params["mla_kv_norm"][l], cfg.rms_eps)
            kr = apply_rope((h @ params["mla_wkr"][l])[:, None, :], cos, sin)[:, 0]
            q_lat = torch.einsum("nhk,hkr->nhr", q[..., :dn], params["mla_wuk"][l])
            q = torch.cat([q_lat, q_rope], dim=-1)  # [N, H, r + dr]
            k = v = torch.cat([c, kr], dim=-1)[:, None, :]  # [N, 1, r + dr]
        else:
            q = linear(params, "wq", l, h).view(N, H, Dh)
            k = linear(params, "wk", l, h).view(N, Hk, Dh)
            v = linear(params, "wv", l, h).view(N, Hk, Dh)
            if cfg.attn_bias:
                q, k, v = q + params["bq"][l], k + params["bk"][l], v + params["bv"][l]
            if cfg.qk_norm:  # per-head RMSNorm over head_dim, before RoPE (Qwen3)
                q = rms_norm(q, params["q_norm"][l], cfg.rms_eps)
                k = rms_norm(k, params["k_norm"][l], cfg.rms_eps)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        # this layer's slice of the pool: slots/pages shifted by the layer offset
        _write_rows(flat, k, v, dst[l])
        pt_l = torch.where(page_tables >= 0, page_tables + l * P, -1)
        attn = attn_impl(q, cache, pt_l, positions, seq_slots, kv_lens,
                         cu_q_lens=cu_q_lens, num_seqs=num_seqs, scale=scale)
        if cfg.is_mla:  # the latent-weighted sum [..., :r] re-expands through W_UV
            attn = torch.einsum("nhr,hrv->nhv", attn[..., :r], params["mla_wuv"][l])
        o = linear(params, "wo", l, attn.reshape(N, H * Dv))
        if cfg.attn_bias:
            o = o + params["bo"][l]
        x = x + o
        h = rms_norm(x, params["mlp_norm"][l], cfg.rms_eps)
        if cfg.is_moe:
            q8 = "moe_wi_q" in params  # int8 expert banks: plain products, no K2/K4
            y, cnt, drop = moe_block(
                cfg, h, params["router"][l], params["moe_wi_q" if q8 else "moe_wi"][l],
                params["moe_wo_q" if q8 else "moe_wo"][l],
                eplb=(eplb[0][l], eplb[1][l]) if eplb[0] is not None else None,
                matmul_impl=moe_matmul_impl, token_mask=valid,
                dispatch_impl=moe_dispatch_impl, rows=moe_rows,
                wi_scale=params["moe_wi_scale"][l] if q8 else None,
                wo_scale=params["moe_wo_scale"][l] if q8 else None)
            if cfg.moe_num_shared_experts:
                y = y + swiglu_layer(params, "shared_wi", "shared_wo", l, h)
            counts.append(cnt)
            dropped.append(drop)
        else:
            y = swiglu_layer(params, "wi", "wo_mlp", l, h)
        x = x + y
    if counts:
        expert_counts, n_dropped = torch.stack(counts), torch.stack(dropped).sum()
    else:
        expert_counts = torch.zeros((L, 0), dtype=torch.int32, device=x.device)
        n_dropped = torch.zeros((), dtype=torch.int32, device=x.device)
    return (rms_norm(x, params["final_norm"], cfg.rms_eps), cache, expert_counts,
            n_dropped.to(torch.int32))


def unembed(cfg: ModelConfig, params: dict[str, torch.Tensor],
            hidden: torch.Tensor) -> torch.Tensor:
    """hidden [..., D] → logits [..., vocab] in f32 (a plain product); on
    ``unembed_q`` (int8 weight-only) the product times ``unembed_scale``, in
    f32, as the reference's."""
    if "unembed_q" in params:
        logits = torch.matmul(hidden.float(), params["unembed_q"].float())
        return logits * params["unembed_scale"].float()
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return torch.matmul(hidden.float(), w.float())


def forward(
    cfg: ModelConfig,
    params: dict[str, torch.Tensor],
    cache: torch.Tensor,
    tokens: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T] (-1 pad)
    page_tables: torch.Tensor,  # [B, max_pages]
    kv_lens: torch.Tensor,  # [B] cache length AFTER this step's tokens
    with_hidden: bool = False,
) -> tuple[torch.Tensor, ...]:
    """[B, T]-shaped convenience wrapper over ``forward_core``.

    Row b's valid tokens (position >= 0) must be its newest ones, in order,
    ending at ``kv_lens[b] - 1``. They are packed flat with ``cu_q_lens`` as the
    kernel takes them by a stable sort on the device (valid tokens first, in
    row order; the padding after ``cu_q_lens[B]``), with no host read. Padding
    rows come back as zero hidden states. Returns (logits [B, T, vocab],
    cache[, hidden])."""
    B, T = tokens.shape
    dev = tokens.device
    valid = (positions >= 0).reshape(-1)
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    cu = torch.zeros((B + 1,), dtype=torch.int32, device=dev)
    cu[1:] = valid.view(B, T).sum(1).cumsum(0)
    seq_slots = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(T)
    packed, cache, _, _ = forward_core(
        cfg, params, cache, tokens.reshape(-1)[order], positions.reshape(-1)[order],
        seq_slots[order], page_tables, kv_lens, cu_q_lens=cu,
        num_seqs=torch.full((1,), B, dtype=torch.int32, device=dev))
    hidden = torch.where(valid[:, None], packed.new_zeros(packed.shape).index_copy_(
        0, order, packed), 0)
    logits = unembed(cfg, params, hidden).reshape(B, T, -1)
    if with_hidden:
        return logits, cache, hidden.reshape(B, T, -1)
    return logits, cache
