"""Attention choice of the engine's step programs (port of
``llmd_tpu/engine/programs.py::select_decode_attn_impl``; the reference's
step-program registry is ROADMAP Queue A item 13)."""

from __future__ import annotations

from typing import Callable

from llmd_tpu_torch.ops.mla_decode import mla_paged_attention_latent


def select_decode_attn_impl(engine, unified_attn: Callable) -> Callable:
    """Attention impl of the decode program. GQA models share the unified
    impl (K1 serves both programs). MLA models take the latent decode
    kernel K3 (``mla_paged_attention_latent``): the decode batch is exactly
    its shape, one query row per sequence over the single-plane latent pool,
    while the unified program keeps ``unified_attn`` (K1 on that pool). The
    kernel runs for CUDA tensors and its plain version for CPU tensors, so
    there is no mode to pick and no fallback."""
    if not engine.model_cfg.is_mla:
        return unified_attn
    return mla_paged_attention_latent
