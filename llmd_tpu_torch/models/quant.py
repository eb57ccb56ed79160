"""Weight-only int8 quantization (port of ``llmd_tpu/models/quant.py``).

Symmetric per-output-channel int8: ``s = amax / 127`` over the contracted
axes (1 where a channel is all zero), ``q = clip(round(w / s), -127, 127)``.
``torch.round`` rounds half to even, as ``jnp.round`` does, so ``q`` is
bit-equal to the reference's. With a per-OUTPUT-channel scale,
``x @ (q * s) == (x @ q) * s``, so the forward multiplies the product by
the scale (``models/transformer.linear``).

Quantized: the dense per-layer projections (wq/wk/wv/wo, wi/wo_mlp), the MoE
expert banks and shared experts (per-expert per-output-channel scales), and
the unembedding (``embed.T`` under ``tie_embeddings``: ``embed`` stays as it
is, the gather table, and an int8 copy serves the logits). Kept: norms,
biases, the router, embed, and MLA's latent projections (only MLA's ``wo``
is quantized, as in the reference).

On the card the product converts the int8 weight to the activation dtype
before a cuBLAS GEMM, so it reads the int8 bytes and writes and re-reads a
converted copy: no streaming int8 kernel yet (PERF.md, ROADMAP).
"""

from __future__ import annotations

import torch

# key -> the axes of the stacked [L, ...] weight that its matmul contracts;
# the scale lives on the remaining axes. Expert banks contract the axis after
# the experts axis: per-expert per-output-channel scales.
CONTRACT_AXES: dict[str, tuple[int, ...]] = {
    "wq": (1,),            # [L, D, H, Dh]
    "wk": (1,),
    "wv": (1,),
    "wo": (1, 2),          # [L, H, Dh, D]
    "wi": (1,),            # [L, D, 2F]
    "wo_mlp": (1,),        # [L, F, D]
    "moe_wi": (2,),        # [L, E, D, 2Fe]
    "moe_wo": (2,),        # [L, E, Fe, D]
    "shared_wi": (1,),     # [L, D, 2Fs]
    "shared_wo": (1,),     # [L, Fs, D]
}

QUANTIZABLE_LAYER_KEYS = ("wq", "wk", "wv", "wo", "wi", "wo_mlp",
                          "moe_wi", "moe_wo", "shared_wi", "shared_wo")


def quantize_one(w: torch.Tensor, contract: tuple[int, ...]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, float32 scale over the non-contracted axes)."""
    wf = w.float()
    amax = wf.abs().amax(dim=contract, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    for ax in sorted(contract, reverse=True):
        scale = scale.squeeze(ax)
    return q, scale


def quantize_params(cfg, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Replace each quantizable leaf ``<key>`` by ``<key>_q`` (int8) and
    ``<key>_scale`` (float32), and add ``unembed_q``/``unembed_scale`` from
    ``unembed`` (or ``embed.T`` under ``tie_embeddings``). Returns a new dict;
    ``params`` is not changed."""
    out = dict(params)
    for key in QUANTIZABLE_LAYER_KEYS:
        if key not in out:
            continue
        out[key + "_q"], out[key + "_scale"] = quantize_one(out.pop(key), CONTRACT_AXES[key])
    src = params["embed"].T if cfg.tie_embeddings else out.pop("unembed", None)
    if src is not None:
        out["unembed_q"], out["unembed_scale"] = quantize_one(src, (0,))
    return out


def dequantize_params(params: dict[str, torch.Tensor], dtype: torch.dtype
                      ) -> dict[str, torch.Tensor]:
    """Each ``<key>_q`` / ``<key>_scale`` pair as the plain weight
    ``q * s`` in ``dtype`` (the scale broadcast over the contracted axes);
    ``unembed_q`` becomes ``unembed``. The int8 forward and the plain forward
    on these weights compute the same function."""
    out = {k: v for k, v in params.items() if not k.endswith(("_q", "_scale"))}
    for key in [k[:-2] for k in params if k.endswith("_q")]:
        q, s = params[key + "_q"], params[key + "_scale"]
        contract = CONTRACT_AXES.get(key, (0,))
        for ax in sorted(contract):
            s = s.unsqueeze(ax)
        out[key] = (q.float() * s.float()).to(dtype)
    return out
