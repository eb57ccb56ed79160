"""The speculative verify programs (port of the reference's nested ``_verify``
and ``_verify_masked``, ``llmd_tpu/engine/engine.py:525`` and :550).

A verify step packs, for each decode-ready sequence, its last committed token
followed by its prompt-lookup draft, as one short chunk of a flat mixed batch,
and runs it through ``forward_core`` like the unified program. Unlike the
unified program it unembeds every packed row: row j of a sequence's chunk
predicts the token after chunk position j, so the engine accepts the draft's
longest prefix that matches these greedy tokens, plus one bonus token.

- :func:`verify`: the greedy token at every packed row.
- :func:`verify_masked`: each row's greedy token under its grammar's bias at
  its automaton state (:class:`~llmd_tpu_torch.engine.decode_program.
  MaskTables`), and the state after that token, so the engine adopts the
  state at the last accepted position and a rejected tail rolls the
  automaton back for free. The state a row masks with depends only on the
  input tokens (position 0: the state after the committed history; position
  j: that state advanced through draft[0..j-1]), so :func:`verify_states`
  computes them on the host from the grammar's transition table, where the
  reference runs a scalar ``lax.scan`` over the packed rows; only the gather
  of the bias, the argmax and the gather of the next state run on the
  device.

Both run eagerly (so does the unified program). They pack exactly their real
rows; the capacity-einsum MoE path is told where they sit in the reference's
static verify batch (``moe_rows``). Under LoRA every packed row carries its
sequence's adapter slot (``batch["lora"]``, the reference's ``lora_tok``).
Under a mesh both run on every rank through the engine's ``verify`` op (the
masked one with its table bases and entry states, over tables the
``mask_stage`` op staged on every rank); the logits are gathered over tp
before the bias and the argmax. With dp or sp > 1 each rank runs its part of
the packed rows (``parallel/rows.flat_plan``; its rows' table bases and entry
states, which the host derived from the input tokens alone) and the greedy
tokens (and next states) are all-gathered over the split.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from llmd_tpu_torch.engine.decode_program import MaskTables
from llmd_tpu_torch.engine.sampling import greedy_tokens
from llmd_tpu_torch.models.config import ModelConfig
from llmd_tpu_torch.models.transformer import forward_core, unembed
from llmd_tpu_torch.ops.grouped_gemm import grouped_gemm


def verify(cfg: ModelConfig, params: dict[str, torch.Tensor], cache: torch.Tensor,
           batch: dict[str, torch.Tensor], *, attn_impl: Callable,
           moe_dispatch_impl: Optional[Callable], moe_rows, lora_scale: float = 1.0,
           moe_matmul_impl: Callable = grouped_gemm, mesh=None, split=None
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(greedy [N] int32, cache, expert counts, dropped copies) for the
    packed batch ``batch`` (``tokens``, ``positions``, ``seq_slots``,
    ``page_tables``, ``kv_lens``, ``cu_q_lens``, ``num_seqs``, and under
    LoRA ``lora``, each row's adapter slot, scaled by ``lora_scale``);
    ``moe_matmul_impl``: the einsum dispatch's expert products; ``mesh``:
    this rank's ``RankMesh`` (``forward_core``'s); ``split``: the batch is
    this rank's part of a split step (``forward_core``'s ``rows``), and the
    greedy tokens come back for every part's rows."""
    hidden, cache, cnt, drop = _forward(cfg, params, cache, batch, attn_impl,
                                        moe_dispatch_impl, moe_rows, lora_scale,
                                        moe_matmul_impl, mesh, split)
    return _gathered(split, greedy_tokens(unembed(cfg, params, hidden, mesh))), cache, cnt, drop


def verify_masked(cfg: ModelConfig, params: dict[str, torch.Tensor], cache: torch.Tensor,
                  batch: dict[str, torch.Tensor], tables: MaskTables,
                  table_rows: torch.Tensor, states: torch.Tensor, *, attn_impl: Callable,
                  moe_dispatch_impl: Optional[Callable], moe_rows, lora_scale: float = 1.0,
                  moe_matmul_impl: Callable = grouped_gemm, mesh=None, split=None):
    """:func:`verify` with the grammar bias: row i takes its argmax over
    ``logits + tables.bias[table_rows[i] + states[i]]`` (float32) and its
    next state is ``tables.next[table_rows[i] + states[i], greedy]``.
    ``table_rows`` [N] is each row's grammar slot times the padded state
    count (0 for unconstrained rows: the zero no-op grammar, whose zero bias
    leaves the argmax bitwise unmasked), ``states`` [N] from
    :func:`verify_states`. Returns (greedy [N] int32, next states [N] int32,
    cache, expert counts, dropped copies)."""
    hidden, cache, cnt, drop = _forward(cfg, params, cache, batch, attn_impl,
                                        moe_dispatch_impl, moe_rows, lora_scale,
                                        moe_matmul_impl, mesh, split)
    rows = (table_rows + states).long()
    greedy = torch.argmax(unembed(cfg, params, hidden, mesh).float() + tables.bias[rows], dim=-1)
    return (_gathered(split, greedy.to(torch.int32)), _gathered(split, tables.next[rows, greedy]),
            cache, cnt, drop)


def verify_states(chunks: Sequence[tuple[Sequence[int], int, Optional[np.ndarray]]]
                  ) -> np.ndarray:
    """The automaton state each packed row masks with, in packing order:
    ``chunks`` is one (draft, state after the committed history, transition
    table ``[S, V]`` or None for a row without a grammar) per sequence, whose
    chunk is its last committed token then its draft. Position 0 masks with
    the entry state, position j with it advanced through draft[0..j-1]; a
    row without a grammar stays at state 0 (the reference's zero next table
    for logit_bias and unconstrained rows)."""
    out = []
    for draft, state, nxt in chunks:
        out.append(state if nxt is not None else 0)
        for tok in draft:
            if nxt is not None:
                state = int(nxt[state, tok])
            out.append(state if nxt is not None else 0)
    return np.asarray(out, np.int32)


def _gathered(split, t: torch.Tensor) -> torch.Tensor:
    return t if split is None else split.gather(t)


def _forward(cfg, params, cache, batch, attn_impl, moe_dispatch_impl, moe_rows, lora_scale,
             moe_matmul_impl, mesh, split):
    return forward_core(cfg, params, cache, batch["tokens"], batch["positions"],
                        batch["seq_slots"], batch["page_tables"], batch["kv_lens"],
                        cu_q_lens=batch["cu_q_lens"], num_seqs=batch["num_seqs"],
                        attn_impl=attn_impl, moe_dispatch_impl=moe_dispatch_impl,
                        moe_matmul_impl=moe_matmul_impl,
                        moe_rows=moe_rows, lora_indices=batch.get("lora"),
                        lora_scale=lora_scale, mesh=mesh, rows=split)
