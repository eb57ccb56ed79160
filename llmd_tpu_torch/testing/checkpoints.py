"""HF-format checkpoints written from a param dict (the port's counterpart of
``llmd_tpu/testing/checkpoints.py::make_hf_checkpoint``), with numpy, torch
and the standard library: no ``transformers``, no ``safetensors`` package.

``write_hf_checkpoint`` is the inverse of ``models/hf_loader.load_params``:
``config.json`` of the Llama family (``LlamaForCausalLM``, or
``Qwen2ForCausalLM`` / ``Qwen3ForCausalLM`` for configs with q/k/v biases or
q/k norms), HF tensor names in HF ``[out, in]`` orientation, one
``model.safetensors`` or shards of at most ``max_shard_bytes`` with a
``model.safetensors.index.json``. No tokenizer is written.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional

import torch

from llmd_tpu_torch.models.config import ModelConfig
from llmd_tpu_torch.models.safetensors_io import write_file


def _architecture(cfg: ModelConfig) -> tuple[str, str]:
    if cfg.is_moe or cfg.is_mla or cfg.has_vision:
        raise ValueError(f"{cfg.name}: only dense GQA configs have an HF Llama-family layout")
    if cfg.qk_norm:
        return "Qwen3ForCausalLM", "qwen3"
    if cfg.attn_bias:
        return "Qwen2ForCausalLM", "qwen2"
    return "LlamaForCausalLM", "llama"


def hf_config(cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """The ``config.json`` that ``hf_loader.config_from_hf`` reads back as
    ``cfg`` (name aside)."""
    arch, family = _architecture(cfg)
    return {
        "architectures": [arch], "model_type": family,
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
        "max_position_embeddings": cfg.max_position,
        "tie_word_embeddings": cfg.tie_embeddings, "attention_bias": cfg.attn_bias,
        "hidden_act": "silu", "torch_dtype": str(dtype).removeprefix("torch."),
    }


def hf_tensors(cfg: ModelConfig, params: dict[str, torch.Tensor]
               ) -> Iterator[tuple[str, torch.Tensor]]:
    """(HF name, tensor) pairs of ``params`` in HF orientation."""
    D, H, Hk, Dh = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Fi = cfg.intermediate_size
    yield "model.embed_tokens.weight", params["embed"]
    for l in range(cfg.num_layers):
        pre = f"model.layers.{l}."
        yield pre + "input_layernorm.weight", params["attn_norm"][l]
        yield pre + "post_attention_layernorm.weight", params["mlp_norm"][l]
        yield pre + "self_attn.q_proj.weight", params["wq"][l].reshape(D, H * Dh).T
        yield pre + "self_attn.k_proj.weight", params["wk"][l].reshape(D, Hk * Dh).T
        yield pre + "self_attn.v_proj.weight", params["wv"][l].reshape(D, Hk * Dh).T
        yield pre + "self_attn.o_proj.weight", params["wo"][l].reshape(H * Dh, D).T
        if cfg.attn_bias:
            yield pre + "self_attn.q_proj.bias", params["bq"][l].reshape(-1)
            yield pre + "self_attn.k_proj.bias", params["bk"][l].reshape(-1)
            yield pre + "self_attn.v_proj.bias", params["bv"][l].reshape(-1)
            yield pre + "self_attn.o_proj.bias", params["bo"][l]
        if cfg.qk_norm:
            yield pre + "self_attn.q_norm.weight", params["q_norm"][l]
            yield pre + "self_attn.k_norm.weight", params["k_norm"][l]
        yield pre + "mlp.gate_proj.weight", params["wi"][l][:, :Fi].T
        yield pre + "mlp.up_proj.weight", params["wi"][l][:, Fi:].T
        yield pre + "mlp.down_proj.weight", params["wo_mlp"][l].T
    yield "model.norm.weight", params["final_norm"]
    if not cfg.tie_embeddings:
        yield "lm_head.weight", params["unembed"].T


def write_hf_checkpoint(out_dir: str, cfg: ModelConfig, params: dict[str, torch.Tensor],
                        *, dtype: Optional[torch.dtype] = None,
                        max_shard_bytes: Optional[int] = None) -> str:
    """Write ``params`` (plain weights of a dense GQA ``cfg``, on any device)
    as an HF checkpoint in ``out_dir``, stored in ``dtype`` (default the
    params' own); ``max_shard_bytes`` splits the tensors over shards with an
    index. Returns ``out_dir``."""
    dtype = dtype or params["embed"].dtype
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config(cfg, dtype), f, indent=1)
    tensors = [(n, t.to(dtype)) for n, t in hf_tensors(cfg, params)]
    if max_shard_bytes is None:
        write_file(os.path.join(out_dir, "model.safetensors"), tensors)
        return out_dir
    shards: list[list] = [[]]
    size = 0
    for name, t in tensors:
        nbytes = t.numel() * t.element_size()
        if shards[-1] and size + nbytes > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append((name, t))
        size += nbytes
    weight_map, total = {}, 0
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        write_file(os.path.join(out_dir, fname), shard)
        for name, t in shard:
            weight_map[name] = fname
            total += t.numel() * t.element_size()
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=1)
    return out_dir
