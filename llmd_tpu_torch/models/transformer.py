"""Dense GQA decoder over a paged KV cache (the GQA half of
``llmd_tpu/models/transformer.py``), in PyTorch.

Layout and semantics follow the reference so parity tests compare like with
like:

- Parameters are a dict of stacked tensors with the reference's names and
  shapes (``wq [L, D, H, Dh]``, ``wi [L, D, 2F]`` fused gate+up, ...).
- The KV cache is ONE flat pool ``[L*P, page_size, 2*Hk, Dh]`` with the layer
  folded into the page dimension (layer ``l``'s page ``p`` at row ``l*P + p``)
  and K/V interleaved per head (K at plane 2h, V at 2h+1). Unlike the
  reference, the head dim is NOT padded to 128 lanes: that padding is a TPU
  tile rule, and the packed layout that wins it back has no use here.
- ``forward_core`` runs a flat mixed batch (prefill chunks + decode tokens,
  described by ``cu_q_lens``/``num_seqs``) through the layers in a Python
  loop — the counterpart of the reference's ``lax.scan`` — and writes K/V
  into the pool IN PLACE (the reference's donated-buffer update).
- Attention is the kernel's wrapper ``ops/paged_attention.paged_attention``
  (the CUDA kernel for CUDA tensors, its plain version for CPU tensors). Any
  impl with the same uniform signature can be passed instead; only the
  kernel-vs-plain checks do.

Serves dense GQA configs only: MoE, MLA, vision towers, qk-norm/bias
checkpoints, LoRA and int8 weights raise ``NotImplementedError`` naming the
ROADMAP Queue A item that brings them.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from llmd_tpu_torch.models.config import ModelConfig
from llmd_tpu_torch.ops.paged_attention import paged_attention

DENSE_KEYS = ("embed", "final_norm", "attn_norm", "mlp_norm", "wq", "wk", "wv",
              "wo", "wi", "wo_mlp")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for architectures this slice of the port does not serve."""
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE is ROADMAP Queue A item 8")
    if cfg.is_mla:
        raise NotImplementedError(f"{cfg.name}: MLA is ROADMAP Queue A item 9")
    if cfg.mm_tokens > 0 or cfg.has_vision:
        raise NotImplementedError(f"{cfg.name}: vision is ROADMAP Queue A item 12")
    if cfg.qk_norm or cfg.attn_bias:
        raise NotImplementedError(
            f"{cfg.name}: qk_norm/attn_bias checkpoints are ROADMAP Queue A item 6")


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    L, D, H, Hk, Dh = (cfg.num_layers, cfg.hidden_size, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    Fi = cfg.intermediate_size
    shapes = {
        "embed": (cfg.vocab_size, D), "final_norm": (D,),
        "attn_norm": (L, D), "mlp_norm": (L, D),
        "wq": (L, D, H, Dh), "wk": (L, D, Hk, Dh), "wv": (L, D, Hk, Dh),
        "wo": (L, H, Dh, D),
        "wi": (L, D, 2 * Fi),  # fused gate+up (SwiGLU)
        "wo_mlp": (L, Fi, D),
    }
    if not cfg.tie_embeddings:
        shapes["unembed"] = (D, cfg.vocab_size)
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
    scales = {"embed": 0.02, "wq": D ** -0.5, "wk": D ** -0.5, "wv": D ** -0.5,
              "wo": (H * Dh) ** -0.5, "wi": D ** -0.5, "wo_mlp": Fi ** -0.5,
              "unembed": D ** -0.5}
    params: dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        if name.endswith("norm"):
            params[name] = torch.ones(shape, dtype=dt, device=device)
            continue
        w = torch.randn(shape, generator=generator, device=gen_dev,
                        dtype=torch.float32) * scales[name]
        params[name] = w.to(device=device, dtype=dt)
    return params


def params_from_numpy(cfg: ModelConfig, np_params: dict,
                      device: "torch.device | str" = "cpu") -> dict[str, torch.Tensor]:
    """The reference's param dict (numpy arrays, ``llmd_tpu`` ``init_params``
    layout) as this package's tensors. bf16 arrays come out of JAX as
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects: every array
    goes through float32, then to the config's dtype."""
    check_supported(cfg)
    if any(k.startswith("lora_") for k in np_params):
        raise NotImplementedError("LoRA params are ROADMAP Queue A item 12")
    shapes = param_shapes(cfg)
    extra = sorted(set(np_params) - set(shapes))
    if extra:
        raise NotImplementedError(
            f"params {extra} are not served by the dense slice "
            "(int8 weights are ROADMAP Queue A item 6)")
    out: dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        a = np.array(np_params[name], dtype=np.float32)  # a writable copy
        if a.shape != shape:
            raise ValueError(f"param {name}: shape {a.shape} != {shape}")
        out[name] = torch.from_numpy(a).to(device=device, dtype=cfg.torch_dtype)
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


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, num_pages: int, page_size: int,
               dtype: Optional[torch.dtype] = None,
               device: "torch.device | str | None" = None) -> torch.Tensor:
    """[L*P, page_size, 2*Hk, Dh] flat pool: layer l's page p at row l*P + p;
    K at plane 2h, V at 2h+1; unpadded head dim."""
    return torch.zeros(
        (cfg.num_layers * num_pages, page_size, 2 * cfg.num_kv_heads, cfg.head_dim),
        dtype=dtype if dtype is not None else cfg.torch_dtype, device=device)


def _write_rows(flat_cache: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                slots: torch.Tensor) -> None:
    n, hk, d = k.shape
    kv = torch.stack([k, v], dim=2).reshape(n, 2 * hk, d).to(flat_cache.dtype)
    flat_cache.index_copy_(0, slots.long(), kv)


def write_kv(flat_cache: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             slots: torch.Tensor) -> torch.Tensor:
    """Write new tokens' K/V into flat cache slots, in place.

    flat_cache: [S, 2*Hk, D] (the pool viewed as token slots); k/v: [N, Hk, D];
    slots: [N] global slot ids. Slot -1 marks padding and is dropped."""
    keep = (slots >= 0).nonzero().squeeze(1)
    _write_rows(flat_cache, k[keep], v[keep], slots[keep])
    return flat_cache


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward_core(
    cfg: ModelConfig,
    params: dict[str, torch.Tensor],
    cache: torch.Tensor,  # [L*P, ps, 2*Hk, Dh] flat layer-folded pool (updated in place)
    tokens: torch.Tensor,  # [N] flat mixed batch
    positions: torch.Tensor,  # [N] (-1 pad)
    seq_slots: torch.Tensor,  # [N] owning batch row (page lookup / masks)
    page_tables: torch.Tensor,  # [B, max_pages] int32 (-1 unmapped)
    kv_lens: torch.Tensor,  # [B] cache length AFTER this step's tokens
    cu_q_lens: Optional[torch.Tensor] = None,  # [B+1] (kernel path)
    num_seqs: Optional[torch.Tensor] = None,  # [1] (kernel path)
    attn_impl: Callable = paged_attention,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run a flat mixed batch through the model, writing K/V into the pool.

    Returns (hidden [N, D] final-normed, cache). Callers unembed only the rows
    they need. The padding-row filter for the KV write costs one host sync per
    call (``nonzero``), shared by all layers."""
    check_supported(cfg)
    N = tokens.shape[0]
    Ptot, ps, HkC, Dh = cache.shape
    L, D, H, Hk = cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads
    P = Ptot // L  # pages per layer
    B = page_tables.shape[0]
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)  # [N, D]

    # global slot ids of the new tokens: page_table[seq, pos // ps] * ps + pos % ps
    valid = positions >= 0
    b = seq_slots.long().clamp(0, B - 1)
    pos0 = torch.where(valid, positions, 0).long()
    safe_page = torch.where(page_tables >= 0, page_tables, 0).long()[b, pos0 // ps]
    rows = valid.nonzero().squeeze(1)
    row_slots = (safe_page * ps + pos0 % ps)[rows]
    flat = cache.view(Ptot * ps, HkC, Dh)
    cos, sin = rope_tables(positions, Dh, cfg.rope_theta)
    scale = Dh ** -0.5

    for l in range(L):
        h = rms_norm(x, params["attn_norm"][l], cfg.rms_eps)
        q = (h @ params["wq"][l].reshape(D, H * Dh)).view(N, H, Dh)
        k = (h @ params["wk"][l].reshape(D, Hk * Dh)).view(N, Hk, Dh)
        v = (h @ params["wv"][l].reshape(D, Hk * Dh)).view(N, Hk, Dh)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # this layer's slice of the pool: slots/pages shifted by the layer offset
        _write_rows(flat, k[rows], v[rows], row_slots + l * (P * ps))
        pt_l = torch.where(page_tables >= 0, page_tables + l * P, -1)
        attn = attn_impl(q, cache, pt_l, positions, seq_slots, kv_lens,
                         cu_q_lens=cu_q_lens, num_seqs=num_seqs, scale=scale)
        x = x + attn.reshape(N, H * Dh) @ params["wo"][l].reshape(H * Dh, D)
        h = rms_norm(x, params["mlp_norm"][l], cfg.rms_eps)
        x = x + swiglu(h, params["wi"][l], params["wo_mlp"][l])
    return rms_norm(x, params["final_norm"], cfg.rms_eps), cache


def unembed(cfg: ModelConfig, params: dict[str, torch.Tensor],
            hidden: torch.Tensor) -> torch.Tensor:
    """hidden [..., D] → logits [..., vocab] in f32 (a plain product)."""
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
    ending at ``kv_lens[b] - 1``: they are packed flat with ``cu_q_lens`` as the
    kernel takes them (one host sync to find them). Padding rows come back as
    zero hidden states. Returns (logits [B, T, vocab], cache[, hidden])."""
    B, T = tokens.shape
    dev = tokens.device
    valid = positions >= 0
    rows = valid.reshape(-1).nonzero().squeeze(1)
    cu = torch.zeros((B + 1,), dtype=torch.int32, device=dev)
    cu[1:] = valid.sum(1).cumsum(0)
    seq_slots = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(T)[rows]
    packed, cache = forward_core(
        cfg, params, cache, tokens.reshape(-1)[rows], positions.reshape(-1)[rows],
        seq_slots, page_tables, kv_lens, cu_q_lens=cu,
        num_seqs=torch.tensor([B], dtype=torch.int32, device=dev))
    hidden = packed.new_zeros((B * T, packed.shape[-1]))
    hidden[rows] = packed
    logits = unembed(cfg, params, hidden).reshape(B, T, -1)
    if with_hidden:
        return logits, cache, hidden.reshape(B, T, -1)
    return logits, cache
