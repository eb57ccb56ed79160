"""Batched sampler: greedy / temperature / top-k / top-p (port of
``llmd_tpu/engine/sampling.py``).

Per-row parameters arrive as tensors so a mixed batch (greedy + sampled rows)
is one call. Draws come from an explicit ``torch.Generator``; its numbers differ
from ``jax.random``'s, so sampled streams are held to distributional checks,
while greedy is bitwise the reference's argmax over float32.
:func:`sample_tokens_biased` adds a grammar or ``logit_bias`` bias first.
"""

from __future__ import annotations

import torch


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token per row: argmax over float32 logits (int32)."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def sample_tokens(
    logits: torch.Tensor,  # [B, V]
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B] (0 = greedy)
    top_k: torch.Tensor,  # [B] int (0 = disabled)
    top_p: torch.Tensor,  # [B] (1.0 = disabled)
    top_k_max: int = 64,
    draw_rows: "tuple[int, torch.Tensor] | None" = None,
) -> torch.Tensor:
    """Sampled token ids [B] (int32), the reference's algorithm: the top
    ``top_k_max`` candidates once, per-row k masking inside them, top-p over
    the sorted candidates (keep until the mass is reached, first always kept),
    then one categorical draw. The draw is the exponential race: the argmax
    of ``p / E`` with E ~ Exp(1) per candidate picks candidate i with
    probability p_i / sum(p), as ``torch.multinomial`` draws one sample, but
    without multinomial's host read of its input check, so a CUDA graph
    captures it (with ``generator`` registered, each replay draws anew).

    ``draw_rows = (n, index [B])``: these rows are rows ``index`` of a batch
    of ``n`` split over a mesh; the draws are the whole batch's, these rows'
    taken, so every rank's generator stays in step with the others' and a
    row draws what it draws unsplit."""
    logits = logits.float()
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    temp = temperature.float().clamp(min=1e-6)[:, None]
    scaled = logits / temp
    topv, topi = torch.topk(scaled, min(top_k_max, V), dim=-1)  # sorted, [B, K]
    K = topv.shape[1]
    ranks = torch.arange(K, device=logits.device)[None, :]
    k_eff = torch.where(top_k > 0, top_k.clamp(max=K), K)[:, None]
    topv = topv.masked_fill(ranks >= k_eff, float("-inf"))
    probs = torch.softmax(topv, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = ((cum - probs) < top_p.float()[:, None]) | (ranks == 0)
    probs = torch.where(keep & (ranks < k_eff), probs, 0.0)
    if draw_rows is None:
        race = torch.empty_like(probs).exponential_(generator=generator)
    else:
        n, index = draw_rows
        race = probs.new_empty((n, K)).exponential_(generator=generator)[index]
    # a zero-probability candidate never wins, even against a draw of 0
    choice = torch.argmax(torch.where(probs > 0, probs / race, -1.0), dim=-1, keepdim=True)
    sampled = torch.gather(topi, 1, choice)[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def sample_tokens_biased(
    logits: torch.Tensor,  # [B, V]
    bias: torch.Tensor,  # [B, V] float32 additive (0 allow / -1e9 ban / logit_bias)
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    top_k_max: int = 64,
    draw_rows: "tuple[int, torch.Tensor] | None" = None,
) -> torch.Tensor:
    """:func:`sample_tokens` on ``logits.float() + bias``: the grammar-mask
    and ``logit_bias`` path (reference ``sample_tokens_biased``). The same
    sampler and the same generator, so an all-zero bias gives bitwise the
    unbiased tokens (and draws the same random numbers)."""
    return sample_tokens(logits.float() + bias, generator, temperature, top_k, top_p,
                         top_k_max, draw_rows)


def apply_penalties(
    logits: torch.Tensor,  # [B, V]
    output_mask: torch.Tensor,  # [B, V] bool: token appeared in the output
    presence: torch.Tensor,  # [B]
    frequency_counts: torch.Tensor,  # [B, V] float
    frequency: torch.Tensor,  # [B]
    repetition: torch.Tensor,  # [B] (1.0 = off)
) -> torch.Tensor:
    """Presence, frequency and repetition penalties (reference
    ``apply_penalties``). As in the reference, nothing calls it: the engine
    accepts the penalty fields and does not act on them."""
    logits = logits - presence[:, None] * output_mask
    logits = logits - frequency[:, None] * frequency_counts
    rep = repetition[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    return torch.where(output_mask, penalized, logits)
