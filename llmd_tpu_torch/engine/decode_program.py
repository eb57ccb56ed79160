"""The engine's decode program: ``k`` decode iterations over a static batch of
one row per slot (port of ``_decode_multi``, ``llmd_tpu/engine/engine.py:612``).

The batch has ``B = max_batch_size`` rows in slot order, whatever the number
of live sequences. An idle slot carries position -1, kv length 1, an empty
page table and a budget of 0: its K/V writes go to the pool's dump row and
no one reads its outputs. Each iteration runs ``forward_core`` → ``unembed``
→ ``sample_tokens`` and feeds the sampled tokens back; a row whose budget
(``steps_left``) is spent freezes (token 0, position and kv length held), so
a call may run past the end of a sequence, as the pipelined dispatch needs.

The program reads no device value on the host, so on the card it is
captured once into a CUDA graph (``engine/cuda_graph.py``) and replayed once
per call; on the CPU (the tests) it runs eagerly. It holds its inputs in
:class:`DecodeBuffers`, allocated once: the host fills them for a call, and
:func:`run_chained` writes the call's last tokens, positions and kv lengths
back into them, so a chained call starts where the previous one ended.

The masked variant (port of ``_decode_multi_masked``, reference :660) serves
grammar-constrained and ``logit_bias`` rows: each iteration gathers every
row's bias at its automaton state from the staged tables
(:class:`MaskTables`), samples through ``sample_tokens_biased`` and advances
the state through the transition table for rows with budget left. The state
joins the chain point (``DecodeBuffers.fsm``), so a chained call starts from
the previous call's state, as the reference keeps its automaton on the
device. The tables live in two static buffers indexed by a per-row base
(``DecodeBuffers.table_rows`` = grammar slot x padded state count), so one
captured graph serves every table shape.

Under a mesh with dp > 1 each dp rank's buffers hold its block of the
slots (``parallel/rows.block_plan``: ``ceil(B / dp)`` rows, the last block
padded with idle slots), the rank's chain point its own slots'; each
iteration all-gathers the new K/V rows over dp inside ``forward_core``, and
the call's sampled tokens are all-gathered over dp at its end, so the
collectives are captured with the rest of the program. Every rank holds the
same tables; the engine's ``mask_stage`` op stages a plan's tables on every
rank and its ``decode`` op carries a masked chain start's bases and entry
states (each rank takes its block), so a worker captures the masked program
at the same command as rank 0 (the collectives inside it pair), and the
bias, applied to the logits gathered over tp, is the whole vocabulary's on
every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from llmd_tpu_torch.engine.sampling import sample_tokens, sample_tokens_biased
from llmd_tpu_torch.models.config import ModelConfig
from llmd_tpu_torch.models.transformer import forward_core, unembed
from llmd_tpu_torch.ops.grouped_gemm import grouped_gemm

# per-row inputs the host packs, with their dtypes and idle-slot values
# (``lora``: the row's adapter slot, 0 the null adapter)
PACKED = {"tokens": (torch.int32, 0), "positions": (torch.int32, -1),
          "page_tables": (torch.int32, -1), "kv_lens": (torch.int32, 1),
          "steps_left": (torch.int32, 0), "temperature": (torch.float32, 0.0),
          "top_k": (torch.int32, 0), "top_p": (torch.float32, 1.0),
          "lora": (torch.int32, 0)}


@dataclasses.dataclass
class DecodeBuffers:
    """The decode program's static inputs, one row per slot: what the host
    packs (:data:`PACKED`) and the batch layout (every row a sequence of one
    query token)."""

    tokens: torch.Tensor  # [B] int32
    positions: torch.Tensor  # [B] int32 (-1 idle)
    page_tables: torch.Tensor  # [B, max_pages] int32 (-1 unmapped)
    kv_lens: torch.Tensor  # [B] int32 (1 idle)
    steps_left: torch.Tensor  # [B] int32 budget of this call (0 idle)
    temperature: torch.Tensor  # [B] float32
    top_k: torch.Tensor  # [B] int32
    top_p: torch.Tensor  # [B] float32
    lora: torch.Tensor  # [B] int32 adapter slot (0 = none)
    seq_slots: torch.Tensor  # [B] arange
    cu_q_lens: torch.Tensor  # [B + 1] arange
    num_seqs: torch.Tensor  # [1] = B
    # the masked program's: each row's automaton state (the chain point) and
    # its grammar's first table row (slot x S_pad; 0 = the zero no-op
    # grammar of unconstrained rows), uploaded at a masked chain's start
    fsm: torch.Tensor  # [B] int32
    table_rows: torch.Tensor  # [B] int32

    @classmethod
    def allocate(cls, batch: int, max_pages: int, device: torch.device) -> "DecodeBuffers":
        bufs = {name: torch.full((batch, max_pages) if name == "page_tables" else (batch,),
                                 idle, dtype=dt, device=device)
                for name, (dt, idle) in PACKED.items()}
        zeros = lambda: torch.zeros((batch,), dtype=torch.int32, device=device)  # noqa: E731
        return cls(**bufs, seq_slots=torch.arange(batch, dtype=torch.int32, device=device),
                   cu_q_lens=torch.arange(batch + 1, dtype=torch.int32, device=device),
                   num_seqs=torch.full((1,), batch, dtype=torch.int32, device=device),
                   fsm=zeros(), table_rows=zeros())

    def idle(self) -> None:
        """Every slot idle (nothing written to a real pool row)."""
        for name, (_, idle) in PACKED.items():
            getattr(self, name).fill_(idle)
        self.fsm.zero_()
        self.table_rows.zero_()


@dataclasses.dataclass
class MaskTables:
    """The staged grammar tables of the masked programs, in two static
    buffers of ``max_elems // V`` rows of ``V``: ``bias`` (float32, rows as
    ``TokenGrammar.fill_bias`` writes them) and ``next`` (int32 state
    transitions). Row ``g * S_pad + s`` holds grammar slot g at state s of a
    staged ``[G_pad, S_pad, V]`` pair; slot 0 is the zero no-op grammar.
    ``staged`` is the key of the tables in the buffers."""

    bias: torch.Tensor  # [R, V] float32
    next: torch.Tensor  # [R, V] int32
    staged: Optional[tuple] = None

    @classmethod
    def allocate(cls, max_elems: int, vocab: int, device: torch.device) -> "MaskTables":
        rows = max(1, max_elems // vocab)
        return cls(torch.zeros((rows, vocab), dtype=torch.float32, device=device),
                   torch.zeros((rows, vocab), dtype=torch.int32, device=device))


@dataclasses.dataclass
class DecodeOutputs:
    toks_out: torch.Tensor  # [k, B] int32 sampled tokens (0 where frozen), every slot's
    last_toks: torch.Tensor  # [B] the chain point (this rank's slots): tokens,
    pos_out: torch.Tensor  # [B] positions
    lens_out: torch.Tensor  # [B] and kv lengths after the call
    counts: torch.Tensor  # [L, E] int32 expert counts summed over k ([L, 0] dense)
    drops: torch.Tensor  # int32 scalar: dropped routed copies summed over k
    fsm_out: Optional[torch.Tensor] = None  # [B] automaton states (masked program)


def decode_program(cfg: ModelConfig, params: dict[str, torch.Tensor], cache: torch.Tensor,
                   buf: DecodeBuffers, k: int, generator: torch.Generator, *,
                   attn_impl: Callable, moe_dispatch_impl: Optional[Callable],
                   tables: Optional[MaskTables] = None,
                   lora_scale: float = 1.0,
                   moe_matmul_impl: Callable = grouped_gemm, mesh=None, split=None,
                   moe_rows=None, draw: Optional[tuple] = None) -> DecodeOutputs:
    """``k`` decode iterations of the static batch (the reference's
    ``_decode_multi``): each samples every row with its own temperature /
    top-k / top-p (temperature 0 is the exact argmax) and advances the rows
    with budget left. The budget is counted down on the device, so no
    iteration index is needed. K/V go into ``cache`` in place. ``buf`` is
    read, not written. With ``tables`` it is the masked program
    (``_decode_multi_masked``): each row samples on its logits plus its
    grammar's bias row at its state, and rows with budget left step their
    state through the transition table; frozen rows hold theirs. With the
    LoRA bank in ``params`` each row runs its adapter slot (``buf.lora``)
    times ``lora_scale``. ``mesh``: this rank's ``RankMesh``; its
    collectives (tp all-reduces, the logits' all-gather, the EP exchange)
    are captured with the rest of the program. ``split`` (a
    ``parallel/rows.RowSplit`` over dp): ``buf`` holds this rank's block of
    the slots, ``moe_rows`` their slot ids in the static batch, ``draw`` the
    sampler's ``draw_rows`` (every slot's draws, this block's taken); the
    call's tokens come back all-gathered, every slot's."""
    toks, pos, lens, steps = buf.tokens, buf.positions, buf.kv_lens, buf.steps_left
    st = buf.fsm
    out, counts, drops = [], None, None
    for _ in range(k):
        hidden, cache, cnt, drop = forward_core(
            cfg, params, cache, toks, pos, buf.seq_slots, buf.page_tables, lens,
            cu_q_lens=buf.cu_q_lens, num_seqs=buf.num_seqs, attn_impl=attn_impl,
            moe_dispatch_impl=moe_dispatch_impl, moe_matmul_impl=moe_matmul_impl,
            lora_indices=buf.lora, lora_scale=lora_scale, mesh=mesh, rows=split,
            moe_rows=moe_rows)
        counts = cnt if counts is None else counts + cnt
        drops = drop if drops is None else drops + drop
        logits = unembed(cfg, params, hidden, mesh)
        act = steps > 0  # rows freeze once their budget is spent
        if tables is None:
            nxt = sample_tokens(logits, generator, buf.temperature, buf.top_k, buf.top_p,
                                draw_rows=draw)
        else:
            rows = (buf.table_rows + st).long()
            nxt = sample_tokens_biased(logits, tables.bias[rows], generator,
                                       buf.temperature, buf.top_k, buf.top_p, draw_rows=draw)
            st = torch.where(act, tables.next[rows, nxt.long()], st)
        nxt = torch.where(act, nxt, 0)
        pos = torch.where(act, pos + 1, pos)
        lens = torch.where(act, lens + 1, lens)
        steps = steps - act.to(steps.dtype)
        out.append(nxt)
        toks = nxt
    toks_out = torch.stack(out)
    if split is not None:  # every dp block's tokens, in slot order
        toks_out = split.gather(toks_out.T.contiguous()).T
    return DecodeOutputs(toks_out, toks, pos, lens, counts, drops.to(torch.int32),
                         st if tables is not None else None)


def run_chained(program: Callable[[], DecodeOutputs], buf: DecodeBuffers,
                drops: bool, counts: bool) -> torch.Tensor:
    """One call of ``program`` that leaves its chain point in ``buf`` (the
    next call's tokens, positions and kv lengths) and returns what the host
    reads of it, as one int32 vector: ``toks_out`` [k*B], then the dropped
    copies [1] if ``drops`` (a MoE model) and the expert counts [L*E] if
    ``counts`` (EPLB); the masked program also leaves its automaton states.
    This is the function the engine captures."""
    o = program()
    buf.tokens.copy_(o.last_toks)
    buf.positions.copy_(o.pos_out)
    buf.kv_lens.copy_(o.lens_out)
    if o.fsm_out is not None:
        buf.fsm.copy_(o.fsm_out)
    parts = [o.toks_out.reshape(-1)]
    if drops:
        parts.append(o.drops.reshape(1))
    if counts:
        parts.append(o.counts.reshape(-1).to(torch.int32))
    return torch.cat(parts)
