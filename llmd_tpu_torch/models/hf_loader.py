"""HF checkpoint loading (port of ``llmd_tpu/models/hf_loader.py``):
``config.json`` → ``ModelConfig``, safetensors → the stacked param dict of
``models/transformer.py``.

Per-layer HF ``[out, in]`` projections become matmul-ready stacked leaves:
``wq [L, D, H, Dh]``, ``wo [L, H, Dh, D]``, the fused SwiGLU ``wi =
concat(gate.T, up.T) [L, D, 2F]``, ``wo_mlp [L, F, D]``; ``unembed`` is
``lm_head.T [D, V]`` unless the embeddings are tied.

Architectures (``config.json`` ``architectures[0]``):
``LlamaForCausalLM`` / ``MistralForCausalLM`` (GQA, SwiGLU, optional tied
embeddings), ``Qwen2ForCausalLM`` (q/k/v biases) and ``Qwen3ForCausalLM``
(per-head q/k RMSNorm, an explicit ``head_dim``). Single-file
``model.safetensors`` and sharded ``model.safetensors.index.json``
checkpoints. Tensors are read by ``models/safetensors_io`` (the format
itself; no ``safetensors`` package) and cast to the target dtype; a
checkpoint's values come out bit-equal to the reference loader's.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from llmd_tpu_torch.models.config import ModelConfig
from llmd_tpu_torch.models.safetensors_io import SafetensorsFile

_ARCH_FAMILY = {
    "LlamaForCausalLM": "llama",
    "MistralForCausalLM": "llama",
    "Qwen2ForCausalLM": "qwen2",
    "Qwen3ForCausalLM": "qwen3",
}


def is_hf_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, "config.json"))


def config_from_hf(path: str, dtype: str = "bfloat16") -> ModelConfig:
    """Translate an HF ``config.json`` into a ``ModelConfig``; scaled RoPE
    and sliding windows are refused (they would load and give wrong
    logits)."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    archs = hf.get("architectures") or []
    arch = archs[0] if archs else "LlamaForCausalLM"
    family = _ARCH_FAMILY.get(arch)
    if family is None:
        raise ValueError(f"unsupported architecture {arch!r}; supported: {sorted(_ARCH_FAMILY)}")
    scaling = hf.get("rope_scaling")
    if scaling and scaling.get("rope_type", scaling.get("type", "default")) != "default":
        raise ValueError(f"unsupported rope_scaling {scaling!r} in {path}; only default "
                         "RoPE is implemented")
    if hf.get("sliding_window") is not None and hf.get("use_sliding_window", True):
        raise ValueError(f"unsupported sliding_window={hf['sliding_window']} in {path}; "
                         "full attention only")
    D = int(hf["hidden_size"])
    H = int(hf["num_attention_heads"])
    return ModelConfig(
        name=os.path.basename(os.path.normpath(path)) or arch,
        vocab_size=int(hf["vocab_size"]),
        hidden_size=D,
        intermediate_size=int(hf["intermediate_size"]),
        num_layers=int(hf["num_hidden_layers"]),
        num_heads=H,
        num_kv_heads=int(hf.get("num_key_value_heads", H)),
        head_dim=int(hf.get("head_dim") or D // H),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_eps=float(hf.get("rms_norm_eps", 1e-6)),
        max_position=int(hf.get("max_position_embeddings", 32768)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        dtype=dtype,
        qk_norm=family == "qwen3",
        # an explicit attention_bias on any family; qwen2's default is True
        attn_bias=bool(hf.get("attention_bias", family == "qwen2")),
    )


class _TensorSource:
    """Tensor-by-name reads over a single-file or index-sharded checkpoint."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._files: dict[str, SafetensorsFile] = {}
        index = os.path.join(path, "model.safetensors.index.json")
        if os.path.isfile(index):
            with open(index) as f:
                self._where = dict(json.load(f)["weight_map"])
        else:
            single = os.path.join(path, "model.safetensors")
            if not os.path.isfile(single):
                raise FileNotFoundError(
                    f"no model.safetensors or model.safetensors.index.json in {path}")
            self._where = dict.fromkeys(self._file("model.safetensors").keys(),
                                        "model.safetensors")

    def _file(self, fname: str) -> SafetensorsFile:
        if fname not in self._files:
            self._files[fname] = SafetensorsFile(os.path.join(self.path, fname))
        return self._files[fname]

    def names(self) -> list[str]:
        return list(self._where)

    def get(self, name: str) -> torch.Tensor:
        fname = self._where.get(name)
        if fname is None:
            raise KeyError(f"tensor {name!r} not in checkpoint {self.path}")
        return self._file(fname).get(name)


def load_params(path: str, cfg: Optional[ModelConfig] = None,
                dtype: Optional[str] = None) -> dict[str, torch.Tensor]:
    """The checkpoint's weights as the stacked param dict, on the host in the
    config's dtype (the engine moves them to its device)."""
    if cfg is None:
        cfg = config_from_hf(path, dtype=dtype or "bfloat16")
    dt = cfg.torch_dtype
    src = _TensorSource(path)
    D, H, Hk, Dh = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L, Fi = cfg.num_layers, cfg.intermediate_size

    def g(name: str) -> torch.Tensor:
        return src.get(name)

    def layer(l: int, name: str) -> torch.Tensor:
        return g(f"model.layers.{l}.{name}")

    def stack(fn) -> torch.Tensor:
        return torch.stack([fn(l).to(dt) for l in range(L)])

    p: dict[str, torch.Tensor] = {
        "embed": g("model.embed_tokens.weight").to(dt),
        "final_norm": g("model.norm.weight").to(dt),
        "attn_norm": stack(lambda l: layer(l, "input_layernorm.weight")),
        "mlp_norm": stack(lambda l: layer(l, "post_attention_layernorm.weight")),
        "wq": stack(lambda l: layer(l, "self_attn.q_proj.weight").T.reshape(D, H, Dh)),
        "wk": stack(lambda l: layer(l, "self_attn.k_proj.weight").T.reshape(D, Hk, Dh)),
        "wv": stack(lambda l: layer(l, "self_attn.v_proj.weight").T.reshape(D, Hk, Dh)),
        "wo": stack(lambda l: layer(l, "self_attn.o_proj.weight").T.reshape(H, Dh, D)),
        "wi": stack(lambda l: torch.cat([layer(l, "mlp.gate_proj.weight").T,
                                         layer(l, "mlp.up_proj.weight").T], dim=-1)),
        "wo_mlp": stack(lambda l: layer(l, "mlp.down_proj.weight").T),
    }
    if cfg.qk_norm:
        p["q_norm"] = stack(lambda l: layer(l, "self_attn.q_norm.weight"))
        p["k_norm"] = stack(lambda l: layer(l, "self_attn.k_norm.weight"))
    if cfg.attn_bias:
        p["bq"] = stack(lambda l: layer(l, "self_attn.q_proj.bias").reshape(H, Dh))
        p["bk"] = stack(lambda l: layer(l, "self_attn.k_proj.bias").reshape(Hk, Dh))
        p["bv"] = stack(lambda l: layer(l, "self_attn.v_proj.bias").reshape(Hk, Dh))
        # llama-style attention_bias puts a bias on o_proj too; qwen2 does not
        p["bo"] = (stack(lambda l: layer(l, "self_attn.o_proj.bias"))
                   if "model.layers.0.self_attn.o_proj.bias" in set(src.names())
                   else torch.zeros((L, D), dtype=dt))
    if not cfg.tie_embeddings:
        p["unembed"] = g("lm_head.weight").T.to(dt)
    if tuple(p["wi"].shape[1:]) != (D, 2 * Fi):
        raise ValueError(f"mlp shape mismatch: fused gate/up is {tuple(p['wi'].shape)}, "
                         f"config expects [L, {D}, {2 * Fi}]")
    return {k: v.contiguous() for k, v in p.items()}


def load_model(path: str, dtype: str = "bfloat16") -> tuple[ModelConfig, dict[str, torch.Tensor]]:
    """(ModelConfig, stacked params on the host) from an HF checkpoint dir."""
    cfg = config_from_hf(path, dtype=dtype)
    return cfg, load_params(path, cfg)
