"""Vision tower for multimodal serving (port of ``llmd_tpu/models/vision.py``):
pixels to the embedding rows that prefill writes over media placeholders.

The encode (E) stage of the E/PD and E/P/D topologies. Each media item
becomes a fixed ``cfg.mm_tokens`` rows of the language model's width:

- patchify (a reshape and one product), add the learned position table;
- a pre-norm transformer (RMSNorm, full attention over the patches, a GELU
  MLP of width 4D), its weights stacked on the layer axis and run in a
  Python loop, as the reference's ``lax.scan``;
- mean-pool consecutive patch groups into ``mm_tokens`` rows and project them
  to ``hidden_size``.

No Pallas kernel is involved in the reference (its attention is an f32
``einsum`` and a softmax in XLA), so this is plain torch products; no
library attention is called, since the reference's f32 scores are what parity
holds to. Where a result would silently differ from the reference's:
pixels are cast to the model dtype before the patchify transpose
``(0, 1, 3, 2, 4, 5)``; RMSNorm normalises in f32 and casts back before the
weight multiply; q/k/v are the thirds of the ``3D`` product; scores are f32
and the softmax is cast to v's dtype; ``jax.nn.gelu``'s default is the tanh
approximation; the output is cast to the model dtype.

Media bytes to pixels: arbitrary payloads (no image codec ships) seed numpy's
``default_rng`` with their sha256, so distinct media give distinct pixels and
the pixels are bit-equal to the reference's.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F

from llmd_tpu_torch.models.config import ModelConfig


def n_patches(cfg: ModelConfig) -> int:
    return (cfg.vision_image_size // cfg.vision_patch) ** 2


def vision_param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The reference's leaves, the per-layer ones stacked on L."""
    D, L, P = cfg.vision_hidden, cfg.vision_layers, cfg.vision_patch
    return {
        "v_patch": (P * P * 3, D), "v_pos": (n_patches(cfg), D),
        "v_norm1": (L, D), "v_qkv": (L, D, 3 * D), "v_out": (L, D, D),
        "v_norm2": (L, D), "v_mlp_in": (L, D, 4 * D), "v_mlp_out": (L, 4 * D, D),
        "v_final_norm": (D,), "v_proj": (D, cfg.hidden_size),
    }


def init_vision_params(cfg: ModelConfig, generator: torch.Generator,
                       device: "torch.device | str | None" = None) -> dict[str, torch.Tensor]:
    """Random-init tower params at the reference's scales (norm weights ones),
    drawn from ``generator`` on its device, then moved to ``device``."""
    D, P = cfg.vision_hidden, cfg.vision_patch
    dt = cfg.torch_dtype
    device = torch.device(device) if device is not None else generator.device
    scale = {"v_patch": (P * P * 3) ** -0.5, "v_pos": 0.02, "v_qkv": D ** -0.5,
             "v_out": D ** -0.5, "v_mlp_in": D ** -0.5, "v_mlp_out": (4 * D) ** -0.5,
             "v_proj": D ** -0.5}
    out = {}
    for k, shape in vision_param_shapes(cfg).items():
        if k in scale:
            w = torch.randn(shape, generator=generator, device=generator.device) * scale[k]
        else:
            w = torch.ones(shape)
        out[k] = w.to(device=device, dtype=dt)
    return out


def vision_params_from_numpy(cfg: ModelConfig, np_params: dict,
                             device: "torch.device | str" = "cpu") -> dict[str, torch.Tensor]:
    """Reference-layout numpy leaves (``v_patch`` ... ``v_proj``) as tensors
    of the model dtype on ``device``."""
    shapes = vision_param_shapes(cfg)
    if set(np_params) != set(shapes):
        raise ValueError(f"vision params {sorted(np_params)} != {sorted(shapes)}")
    out = {}
    for k, shape in shapes.items():
        a = np.array(np_params[k], np.float32)  # a writable copy
        if a.shape != shape:
            raise ValueError(f"vision param {k}: shape {a.shape} != {shape}")
        out[k] = torch.from_numpy(a).to(device=device, dtype=cfg.torch_dtype)
    return out


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    v = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps)).to(x.dtype) * w


def encode_images(cfg: ModelConfig, params: dict[str, torch.Tensor],
                  pixels: torch.Tensor) -> torch.Tensor:
    """[N, S, S, 3] pixels in [0, 1] -> [N, mm_tokens, hidden_size] in the
    model dtype, N independent media items in one batch."""
    N = pixels.shape[0]
    P, S, D, H = cfg.vision_patch, cfg.vision_image_size, cfg.vision_hidden, cfg.vision_heads
    hd = D // H
    T = n_patches(cfg)
    x = pixels.to(cfg.torch_dtype).reshape(N, S // P, P, S // P, P, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(N, T, P * P * 3)
    x = x @ params["v_patch"] + params["v_pos"]
    for l in range(cfg.vision_layers):
        h = _rms(x, params["v_norm1"][l])
        q, k, v = (t.reshape(N, T, H, hd).transpose(1, 2)
                   for t in (h @ params["v_qkv"][l]).split(D, dim=-1))
        s = torch.einsum("nhqd,nhkd->nhqk", q.float(), k.float()) * hd ** -0.5
        a = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("nhqk,nhkd->nhqd", a, v).transpose(1, 2).reshape(N, T, D)
        x = x + o @ params["v_out"][l]
        h = _rms(x, params["v_norm2"][l])
        x = x + F.gelu(h @ params["v_mlp_in"][l], approximate="tanh") @ params["v_mlp_out"][l]
    x = _rms(x, params["v_final_norm"])
    # pool consecutive patch groups into the fixed mm_tokens rows
    x = x.reshape(N, cfg.mm_tokens, T // cfg.mm_tokens, D).mean(dim=2)
    return (x @ params["v_proj"]).to(cfg.torch_dtype)


def vision_flops(cfg: ModelConfig) -> float:
    """Multiply-add operations x 2 of one image through the tower."""
    T, D, P = n_patches(cfg), cfg.vision_hidden, cfg.vision_patch
    per_layer = 2 * T * D * (3 * D + D + 8 * D) + 2 * 2 * T * T * D
    return (2 * T * P * P * 3 * D + cfg.vision_layers * per_layer
            + 2 * cfg.mm_tokens * D * cfg.hidden_size)


# ---------------------------------------------------------------------------
# Media bytes -> pixels and identity
# ---------------------------------------------------------------------------


def mm_content_hash(data: bytes) -> bytes:
    """Stable media identity: the encode workers' LRU key."""
    return hashlib.sha256(data).digest()[:16]


def bytes_to_pixels(cfg: ModelConfig, data: bytes) -> np.ndarray:
    """Deterministic bytes -> [S, S, 3] float32 pixels in [0, 1]: the
    payload's sha256 seeds numpy's ``default_rng`` (bit-equal to the
    reference's pixels). A real decoder would slot in here."""
    S = cfg.vision_image_size
    seed = int.from_bytes(hashlib.sha256(data).digest()[:8], "little", signed=False)
    return np.random.default_rng(seed).random((S, S, 3), dtype=np.float32)
