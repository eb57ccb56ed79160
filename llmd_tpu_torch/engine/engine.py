"""LLMEngine: continuous batching over the paged PyTorch model (port of the main
path of ``llmd_tpu/engine/engine.py``).

Two step programs, routed inline by ``step()``:

- ``unified`` (reference ``_step_unified``): decode rows plus prefill chunks of
  several sequences packed into one flat token batch under the
  ``max_num_batched_tokens`` budget; only each sequence's last row is
  unembedded, and sequences whose prompt completes sample their first token.
  Runs while any sequence is prefilling.
- ``decode`` (reference ``_step_decode`` / ``_decode_multi``): up to
  ``decode_steps`` decode iterations per host round trip, sampled tokens fed
  back on the device. Each row carries a ``steps_left`` budget (max_tokens /
  max_model_len) and freezes once it is spent; the call runs only as many
  iterations as the largest budget (the host knows every budget, so steps no
  row can use are never launched). Tokens past a stop token are dropped
  when the results are applied.

Attention: the unified program runs K1's wrapper (``paged_attention``), the
decode program what ``programs.select_decode_attn_impl`` picks: K1 again for
GQA models, the latent decode kernel K3 for MLA models (whose pool is the
single-plane latent pool, which K1 also serves for the unified program).

Also carried over: admission with prefix-cache reuse (chained block hashes),
chunked prefill across sequences, preemption by recompute when pages run out,
the tight-pool degrade of a multi-step decode to one unified step, and for MoE
models the dispatch choice (``_select_moe_dispatch``), the dropped-copy count
and EPLB (redundant expert slots re-placed every ``step_interval`` steps that
routed tokens, from a sliding window of expert loads).

The loop is synchronous: every step ends with one host read of its sampled
tokens (and, for MoE, of the step's dropped count and expert loads in the same
copy). The reference's pipelined chain, pack overlap, deferred prefill sample
and CUDA-graph replay are later work (ROADMAP). Batches are packed without
padding rows: a unified step carries exactly its real tokens, a decode call
exactly its active sequences. The capacity-einsum MoE path is told where each
row sits in the reference's padded batch (``forward_core(moe_rows=...)``), so
its capacity, and with it its drops, follow the reference's.

Entry point device: a CUDA card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from llmd_tpu_torch.core.kv_events import KVEvent, block_keys_for_tokens
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine.config import EngineConfig
from llmd_tpu_torch.engine.kv_manager import PageAllocator, Sequence
from llmd_tpu_torch.engine.programs import select_decode_attn_impl
from llmd_tpu_torch.engine.sampling import greedy_tokens, sample_tokens
from llmd_tpu_torch.models.config import ModelConfig
from llmd_tpu_torch.models.transformer import (
    SORTED_DISPATCH,
    check_supported,
    forward_core,
    init_cache,
    init_params,
    unembed,
)
from llmd_tpu_torch.ops.paged_attention import paged_attention
from llmd_tpu_torch.parallel.eplb import ExpertLoadTracker, rebalance


def resolve_device(device: "torch.device | str | None" = None) -> torch.device:
    """The card by default; the CPU only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "LLMEngine runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


@dataclass
class EngineOutput:
    request_id: str
    new_token_ids: list[int]
    finished: bool
    finish_reason: Optional[str] = None
    num_cached_prompt_tokens: int = 0
    prompt_len: int = 0


@dataclass
class EngineStats:
    num_waiting: int = 0
    num_running: int = 0
    kv_utilization: float = 0.0
    total_prefill_tokens: int = 0
    total_decode_tokens: int = 0
    # tokens produced by decode calls only (excludes decode rows riding a
    # unified step, whose wall lands in time_prefill_steps): the numerator
    # that matches time_decode_steps
    decode_tokens_fused: int = 0
    total_preemptions: int = 0
    attn_backend: str = ""  # kernel provenance
    moe_backend: str = ""  # expert-GEMM provenance
    moe_dispatch: str = ""  # "sorted" | "einsum" | "n/a (dense model)"
    moe_dropped_tokens: int = 0  # routed copies dropped past capacity (einsum)
    eplb_rebalances: int = 0  # expert-placement recomputes
    # wall time inside each program; every step ends in a host read of its
    # sampled tokens, so these include the device time
    time_prefill_steps: float = 0.0
    time_decode_steps: float = 0.0
    n_unified_steps: int = 0
    n_decode_calls: int = 0
    n_decode_iterations: int = 0  # forward passes run by decode calls


class LLMEngine:
    """Single-device engine instance."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        engine_cfg: EngineConfig,
        params: Optional[dict[str, torch.Tensor]] = None,
        event_sink: Optional[Callable[[list[KVEvent]], None]] = None,
        seed: int = 0,
        device: "torch.device | str | None" = None,
    ) -> None:
        self.device = resolve_device(device)
        check_supported(model_cfg)
        engine_cfg.check_served()
        self.model_cfg = model_cfg
        self.cfg = engine_cfg
        self.alloc = PageAllocator(engine_cfg.num_pages, engine_cfg.page_size,
                                   enable_prefix_caching=engine_cfg.enable_prefix_caching,
                                   event_sink=event_sink)
        self.waiting: deque[Sequence] = deque()
        self.running: list[Optional[Sequence]] = [None] * engine_cfg.max_batch_size
        self.seqs: dict[str, Sequence] = {}
        self.stats = EngineStats()
        self._outputs: list[EngineOutput] = []
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(model_cfg, gen, self.device)
        else:
            params = {k: v.to(device=self.device, dtype=model_cfg.torch_dtype)
                      for k, v in params.items()}
        self.params = params
        self.cache = init_cache(model_cfg, engine_cfg.num_pages, engine_cfg.page_size,
                                device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # attention of each program is a kernel's wrapper: the CUDA kernel on
        # the card, its plain version for CPU tensors
        self._attn = {"unified": paged_attention}
        self._attn["decode"] = select_decode_attn_impl(self, self._attn["unified"])
        on_card = self.device.type == "cuda"
        if model_cfg.is_mla:
            self.attn_backend = ("cuda_paged_attention_latent+cuda_mla_latent_decode"
                                 if on_card else
                                 "torch_reference_latent+torch_mla_latent_decode "
                                 "(cpu tensors)")
        else:
            self.attn_backend = ("cuda_paged_attention" if on_card
                                 else "torch_reference (cpu tensors)")
        self.stats.attn_backend = self.attn_backend
        self._moe_dispatch_impl = self._select_moe_dispatch()
        self.stats.moe_backend = self.moe_backend
        self.stats.moe_dispatch = self.moe_dispatch
        self._eplb = None
        if engine_cfg.eplb is not None and model_cfg.is_moe:
            self._init_eplb()

    def _select_moe_dispatch(self) -> Optional[Callable]:
        """The MoE token dispatch (reference ``_select_moe_dispatch``, one
        device, no environment override): ``auto`` and ``sorted`` give the
        drop-free sorted path (expert GEMMs through K2), ``einsum`` the
        capacity path (K4). Returns the dispatch_impl, None for einsum."""
        if not self.model_cfg.is_moe:
            self.moe_dispatch = self.moe_backend = "n/a (dense model)"
            return None
        self.moe_dispatch = "einsum" if self.cfg.moe_dispatch == "einsum" else "sorted"
        if self.device.type != "cuda":
            self.moe_backend = "torch_reference (cpu tensors)"
        else:
            self.moe_backend = ("cuda_ragged_grouped_gemm" if self.moe_dispatch == "sorted"
                                else "cuda_grouped_gemm")
        return SORTED_DISPATCH if self.moe_dispatch == "sorted" else None

    # ----------------------------------------------------------------- EPLB
    # Physical slot weights and replica tables live beside the logical params
    # and are re-gathered every step_interval steps that routed tokens.
    def _init_eplb(self) -> None:
        e = self.cfg.eplb
        E, L = self.model_cfg.moe_num_experts, self.model_cfg.num_layers
        self._eplb = e
        self._eplb_slots = E + e.num_redundant_experts  # one EP rank
        self._eplb_tracker = ExpertLoadTracker(L, E, e.window_size)
        self._eplb_steps = 0
        self._eplb_active = False  # set when a forward actually routed tokens
        self._eplb_rebalance()

    def _eplb_rebalance(self) -> None:
        """Recompute the placement from the windowed loads and gather the
        physical slot weights on the device (``index_select``)."""
        s2e, slots, counts = rebalance(self._eplb_tracker.loads(), self._eplb_slots, 1)
        L, S = s2e.shape
        E = self.model_cfg.moe_num_experts
        rows = self._tensor((np.arange(L)[:, None] * E + s2e).reshape(-1).astype(np.int64))
        phys = {}
        for name in ("moe_wi", "moe_wo"):
            w = self.params[name]  # [L, E, ...]
            phys[name] = w.reshape(L * E, *w.shape[2:]).index_select(0, rows).view(
                L, S, *w.shape[2:])
        self._eplb_params = {**phys, "eplb_replica_slots": self._tensor(slots),
                             "eplb_replica_counts": self._tensor(counts)}
        self.stats.eplb_rebalances += 1

    def _run_params(self) -> dict[str, torch.Tensor]:
        """Params seen by the forward: base weights, plus the physical expert
        weights and replica tables under EPLB."""
        if self._eplb is None:
            return self.params
        return {**self.params, **self._eplb_params}

    def _eplb_tick(self) -> None:
        # count only steps that routed tokens
        if not self._eplb_active:
            return
        self._eplb_active = False
        self._eplb_steps += 1
        if self._eplb_steps % self._eplb.step_interval == 0:
            self._eplb_rebalance()

    def _forward(self, program: str, *args, moe_rows, **kw):
        return forward_core(self.model_cfg, self._run_params(), self.cache, *args,
                            attn_impl=self._attn[program],
                            moe_dispatch_impl=self._moe_dispatch_impl,
                            moe_rows=moe_rows, **kw)

    def _read_back(self, tokens: Optional[torch.Tensor], cnt: torch.Tensor,
                   drop: torch.Tensor) -> np.ndarray:
        """The step's one host read: its tokens and, for a MoE model, its
        dropped-copy count and (under EPLB) its expert loads, in one copy.
        Records the MoE numbers; returns the tokens as int64."""
        parts = [tokens.reshape(-1).long()] if tokens is not None else []
        moe = self.model_cfg.is_moe
        if moe:
            parts.append(drop.reshape(1).long())
            if self._eplb is not None:
                parts.append(cnt.reshape(-1).long())
        if not parts:
            return np.zeros((0,), np.int64)
        host = torch.cat(parts).cpu().numpy()
        n = 0 if tokens is None else tokens.numel()
        if moe:
            self.stats.moe_dropped_tokens += int(host[n])
            if self._eplb is not None:
                self._eplb_tracker.record(host[n + 1:].reshape(cnt.shape))
                self._eplb_active = True
        return host[:n]

    # ------------------------------------------------------------ requests
    def add_request(self, request_id: str, token_ids: list[int],
                    sampling: Optional[SamplingParams] = None) -> None:
        sampling = sampling or SamplingParams()
        if not token_ids:
            raise ValueError("empty prompt")
        if len(token_ids) >= self.cfg.max_model_len:
            token_ids = token_ids[: self.cfg.max_model_len - 1]
        ps = self.cfg.page_size
        if (len(token_ids) + 1 + ps - 1) // ps > self.alloc.num_pages:
            raise ValueError(
                f"prompt needs more KV pages than the pool "
                f"({len(token_ids)} tokens, {self.alloc.num_pages} pages × {ps})")
        bad = [t for t in token_ids if not 0 <= t < self.model_cfg.vocab_size]
        if bad:
            raise ValueError(f"token ids out of vocab range: {bad[:4]}")
        seq = Sequence(request_id=request_id, token_ids=list(token_ids),
                       prompt_len=len(token_ids), max_tokens=sampling.max_tokens,
                       sampling=sampling, arrival_time=time.monotonic())
        self.seqs[request_id] = seq
        self.waiting.append(seq)

    def abort(self, request_id: str) -> None:
        seq = self.seqs.pop(request_id, None)
        if seq is None:
            return
        if seq.slot >= 0:
            self.running[seq.slot] = None
        try:
            self.waiting.remove(seq)
        except ValueError:
            pass
        self._free_seq(seq)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.running)

    # ------------------------------------------------------- scheduling core
    def _free_seq(self, seq: Sequence) -> None:
        for pid in seq.pages:
            self.alloc.release(pid)
        seq.pages = []

    def _try_admit(self) -> None:
        """Move waiting → running while slots + pages allow; reuse cached prefixes."""
        alloc, ps = self.alloc, self.cfg.page_size
        while self.waiting:
            slot = next((i for i, s in enumerate(self.running) if s is None), None)
            if slot is None:
                return
            seq = self.waiting[0]
            if seq.pages:
                self._free_seq(seq)  # a waiting seq owns nothing
            keys = block_keys_for_tokens(seq.token_ids[: seq.prompt_len], ps)
            hit_pages = alloc.match_prefix(keys) if self.cfg.enable_prefix_caching else []
            # never reuse the whole prompt — the last token's logits must be computed
            hit_pages = hit_pages[: max(0, (seq.prompt_len - 1) // ps)]
            need_new = ((min(seq.prompt_len + 1, self.cfg.max_pages_per_seq * ps)
                         + ps - 1) // ps - len(hit_pages))
            # acquire_cached pulls hit pages out of the evictable LRU, so they
            # stop counting toward num_free: budget num_free minus those pages
            hits_in_lru = sum(1 for pid in hit_pages
                              if (info := alloc.pages.get(pid)) is not None
                              and info.refs == 0)
            if need_new > alloc.num_pages:
                # can never fit (prompt + generated tokens outgrew the pool)
                self.waiting.popleft()
                seq.finished, seq.finish_reason = True, "length"
                self.seqs.pop(seq.request_id, None)
                self._outputs.append(EngineOutput(
                    request_id=seq.request_id, new_token_ids=[], finished=True,
                    finish_reason="length", prompt_len=seq.prompt_len))
                continue
            if alloc.num_free - hits_in_lru < need_new:
                return  # head-of-line blocks; FCFS admission
            for pid in hit_pages:
                alloc.acquire_cached(pid)
            seq.pages = list(hit_pages)
            seq.block_hashes = keys[: len(hit_pages)]
            seq.num_computed = len(hit_pages) * ps
            seq.num_cached_prompt = seq.num_computed
            seq.slot = slot
            self.running[slot] = seq
            self.waiting.popleft()

    def _ensure_pages(self, seq: Sequence, upto_tokens: int) -> bool:
        need = (upto_tokens + self.cfg.page_size - 1) // self.cfg.page_size
        while len(seq.pages) < need:
            pid = self.alloc.allocate()
            if pid is None:
                return False
            seq.pages.append(pid)
        return True

    def _finish_if_outgrew_pool(self, seq: Sequence) -> None:
        """A running seq whose next token needs more pages than the whole pool
        can never be scheduled again: finish it with 'length'."""
        ps = self.cfg.page_size
        if (len(seq.token_ids) + ps - 1) // ps <= self.alloc.num_pages:
            return  # transient pressure: another seq's retirement frees pages
        self._retire(seq, "length")
        self._outputs.append(EngineOutput(
            request_id=seq.request_id, new_token_ids=[], finished=True,
            finish_reason="length", num_cached_prompt_tokens=seq.num_cached_prompt,
            prompt_len=seq.prompt_len))

    def _preempt_one(self, exclude: Optional[Sequence] = None) -> bool:
        """Evict the most recently arrived running seq back to waiting
        (recompute semantics). ``exclude`` is the seq being scheduled:
        evicting it would only reset it to token zero."""
        victims = [s for s in self.running if s is not None and s is not exclude]
        if not victims:
            return False
        victim = max(victims, key=lambda s: s.arrival_time)
        self.running[victim.slot] = None
        victim.slot = -1
        self._free_seq(victim)
        victim.num_computed = 0
        victim.block_hashes = []
        victim.num_cached_prompt = 0
        self.waiting.appendleft(victim)
        self.stats.total_preemptions += 1
        return True

    def _prefill_target(self, seq: Sequence) -> int:
        """Tokens to process chunk-wise before decode takes over: the whole
        prompt when fresh; through len-1 after a preemption (the decode path
        then feeds the last token)."""
        if len(seq.token_ids) == seq.prompt_len:
            return seq.prompt_len
        return len(seq.token_ids) - 1

    def _prefilling_seqs(self) -> list[Sequence]:
        cands = [s for s in self.running
                 if s is not None and s.num_computed < self._prefill_target(s)]
        return sorted(cands, key=lambda s: s.arrival_time)

    def _decode_ready(self) -> list[Sequence]:
        return [s for s in self.running
                if s is not None and s.num_computed == len(s.token_ids) - 1
                and s.num_computed >= s.prompt_len]

    # --------------------------------------------------------------- stepping
    def step(self) -> list[EngineOutput]:
        """One engine iteration: admit, then the unified program while any
        sequence is prefilling, the decode program otherwise."""
        self._outputs = []
        self._try_admit()
        with torch.no_grad():
            if self._prefilling_seqs():
                self._step_unified()
            else:
                self._step_decode()
        if self._eplb is not None:
            self._eplb_tick()
        st = self.stats
        st.num_waiting = len(self.waiting)
        st.num_running = sum(1 for s in self.running if s is not None)
        st.kv_utilization = self.alloc.num_active / max(1, self.cfg.num_pages)
        return self._outputs

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sample(self, logits: torch.Tensor, seqs: list[Sequence]) -> torch.Tensor:
        """Tokens for ``logits`` rows (one per seq in order), int32 on device."""
        if all(s.sampling.temperature <= 0.0 for s in seqs):
            return greedy_tokens(logits)
        temp = self._tensor(np.array([s.sampling.temperature for s in seqs], np.float32))
        tk = self._tensor(np.array([s.sampling.top_k for s in seqs], np.int64))
        tp = self._tensor(np.array([s.sampling.top_p for s in seqs], np.float32))
        return sample_tokens(logits, self._gen, temp, tk, tp)

    def _step_unified(self) -> None:
        """Pack decode tokens + prefill chunks (across sequences) into the flat
        token budget and run ONE forward."""
        t0 = time.perf_counter()
        budget = self.cfg.batched_tokens
        B = self.cfg.max_batch_size
        # decode rows first (keeps TPOT low while prompts stream in), then
        # prefill chunks oldest-first
        plan: list[tuple[Sequence, int, bool]] = []  # (seq, q_len, is_decode)
        for s in self._decode_ready():
            if len(plan) >= B:
                break
            if s.slot < 0 or budget <= 0:
                continue  # preempted while packing an earlier row
            if not self._ensure_pages(s, len(s.token_ids)):
                if not self._preempt_one(exclude=s) or s.slot < 0:
                    self._finish_if_outgrew_pool(s)
                    continue
                if not self._ensure_pages(s, len(s.token_ids)):
                    continue
            plan.append((s, 1, True))
            budget -= 1
        for s in self._prefilling_seqs():
            if len(plan) >= B:
                break
            if s.slot < 0:
                continue  # preempted while packing decode rows
            n = min(self.cfg.prefill_chunk, self._prefill_target(s) - s.num_computed,
                    budget)
            if n <= 0:
                continue
            if not self._ensure_pages(s, s.num_computed + n):
                if not self._preempt_one(exclude=s) or s.slot < 0:
                    self._finish_if_outgrew_pool(s)
                    continue
                if not self._ensure_pages(s, s.num_computed + n):
                    continue
            plan.append((s, n, False))
            budget -= n
        plan = [(s, n, d) for (s, n, d) in plan if s.slot >= 0]
        if not plan:
            return

        nb = len(plan)
        N = sum(n for _, n, _ in plan)
        toks = np.zeros((N,), np.int32)
        pos = np.zeros((N,), np.int32)
        sids = np.zeros((N,), np.int32)
        pts = np.full((nb, self.cfg.max_pages_per_seq), -1, np.int32)
        lens = np.ones((nb,), np.int32)
        cu = np.zeros((nb + 1,), np.int32)
        off = 0
        for i, (s, n, is_decode) in enumerate(plan):
            start = len(s.token_ids) - 1 if is_decode else s.num_computed
            toks[off : off + n] = s.token_ids[start : start + n]
            pos[off : off + n] = np.arange(start, start + n)
            sids[off : off + n] = i
            pts[i, : len(s.pages)] = s.pages
            lens[i] = start + n
            off += n
            cu[i + 1] = off

        # the reference runs its unified program on batched_tokens rows, real
        # rows first: row i of this batch is its row i
        hidden, self.cache, cnt, drop = self._forward(
            "unified", self._tensor(toks), self._tensor(pos), self._tensor(sids),
            self._tensor(pts), self._tensor(lens), cu_q_lens=self._tensor(cu),
            num_seqs=self._tensor(np.array([nb], np.int32)),
            moe_rows=(torch.arange(N, device=self.device), self.cfg.batched_tokens))

        sample_rows: list[tuple[int, Sequence]] = []  # (plan row, seq)
        for i, (s, n, is_decode) in enumerate(plan):
            if is_decode:
                s.num_computed = len(s.token_ids)
                s.maybe_commit_blocks(self.alloc)
                self.stats.total_decode_tokens += 1
                sample_rows.append((i, s))
            else:
                s.num_computed += n
                s.maybe_commit_blocks(self.alloc)
                self.stats.total_prefill_tokens += n
                if len(s.token_ids) == s.prompt_len and s.num_computed == s.prompt_len:
                    sample_rows.append((i, s))  # prompt complete: first token
        sampled = None
        if sample_rows:
            last = self._tensor(cu[[i + 1 for i, _ in sample_rows]] - 1)
            logits = unembed(self.model_cfg, self.params, hidden[last.long()])
            sampled = self._sample(logits, [s for _, s in sample_rows])
        sampled = self._read_back(sampled, cnt, drop).tolist()
        for (_, s), tok in zip(sample_rows, sampled):
            self._apply_token(s, tok)
        self.stats.time_prefill_steps += time.perf_counter() - t0
        self.stats.n_unified_steps += 1

    def _apply_token(self, s: Sequence, tok: int) -> None:
        s.token_ids.append(tok)
        finished, reason = self._check_finish(s, tok)
        if finished:
            self._retire(s, reason)
        self._outputs.append(EngineOutput(
            request_id=s.request_id, new_token_ids=[tok], finished=finished,
            finish_reason=reason, num_cached_prompt_tokens=s.num_cached_prompt,
            prompt_len=s.prompt_len))

    def _step_decode(self) -> None:
        """Fused multi-step decode: up to ``decode_steps`` iterations, tokens
        fed back on the device, one host read at the end."""
        t0 = time.perf_counter()
        active = self._decode_ready()
        if not active:
            return
        k = max(1, self.cfg.decode_steps)
        # k iterations write KV for positions len-1 .. len+k-2 → len+k-1 slots.
        # If the pool can't cover that horizon, degrade to a single unified
        # step (decode rows only) rather than preempting.
        ok = all(self._ensure_pages(s, min(len(s.token_ids) + k - 1,
                                            self.cfg.max_model_len))
                 for s in active if s.slot >= 0)
        if not ok:
            self._step_unified()
            return
        active = [s for s in active if s.slot >= 0]
        if not active:
            return

        nb = len(active)
        toks = np.zeros((nb,), np.int32)
        pos = np.zeros((nb,), np.int32)
        pts = np.full((nb, self.cfg.max_pages_per_seq), -1, np.int32)
        lens = np.ones((nb,), np.int32)
        steps_left = np.zeros((nb,), np.int32)
        for j, s in enumerate(active):
            n_tok = len(s.token_ids)
            toks[j] = s.token_ids[-1]
            pos[j] = n_tok - 1
            pts[j, : len(s.pages)] = s.pages
            lens[j] = n_tok
            steps_left[j] = max(0, min(s.max_tokens - (n_tok - s.prompt_len),
                                       self.cfg.max_model_len - n_tok, k))
        n_iter = max(1, int(steps_left.max()))
        tok_d, pos_d, lens_d = self._tensor(toks), self._tensor(pos), self._tensor(lens)
        pts_d, steps_d = self._tensor(pts), self._tensor(steps_left)
        slots_d = torch.arange(nb, dtype=torch.int32, device=self.device)
        cu_d = torch.arange(nb + 1, dtype=torch.int32, device=self.device)
        ns_d = torch.tensor([nb], dtype=torch.int32, device=self.device)
        # the reference's decode batch has a row per slot, in slot order
        moe_rows = (self._tensor(np.array([s.slot for s in active], np.int64)),
                    self.cfg.max_batch_size)
        out, cnt, drop = [], 0, 0
        for i in range(n_iter):
            hidden, self.cache, cnt_i, drop_i = self._forward(
                "decode", tok_d, pos_d, slots_d, pts_d, lens_d, cu_q_lens=cu_d,
                num_seqs=ns_d, moe_rows=moe_rows)
            cnt, drop = cnt + cnt_i, drop + drop_i
            nxt = self._sample(unembed(self.model_cfg, self.params, hidden), active)
            act = i < steps_d  # rows freeze once their budget is spent
            nxt = torch.where(act, nxt, 0)
            pos_d = torch.where(act, pos_d + 1, pos_d)
            lens_d = torch.where(act, lens_d + 1, lens_d)
            out.append(nxt)
            tok_d = nxt
        # [n_iter, nb] (the host sync)
        toks_out = self._read_back(torch.stack(out), cnt, drop).reshape(n_iter, nb)

        for j, s in enumerate(active):
            kept: list[int] = []
            finished, reason = False, None
            for t in toks_out[: steps_left[j], j].tolist():
                kept.append(t)
                s.token_ids.append(t)
                finished, reason = self._check_finish(s, t)
                if finished:
                    break  # tokens past a stop are dropped
            # the newest token's KV is not written yet → computed = len - 1
            s.num_computed = len(s.token_ids) - 1
            s.maybe_commit_blocks(self.alloc)
            self.stats.total_decode_tokens += len(kept)
            self.stats.decode_tokens_fused += len(kept)
            if finished:
                self._retire(s, reason)
            self._outputs.append(EngineOutput(
                request_id=s.request_id, new_token_ids=kept, finished=finished,
                finish_reason=reason, num_cached_prompt_tokens=s.num_cached_prompt,
                prompt_len=s.prompt_len))
        st = self.stats
        st.time_decode_steps += time.perf_counter() - t0
        st.n_decode_calls += 1
        st.n_decode_iterations += n_iter

    def _retire(self, seq: Sequence, reason: Optional[str]) -> None:
        """Free slot + pages, drop from the live map."""
        seq.finished = True
        seq.finish_reason = reason
        if seq.slot >= 0:
            self.running[seq.slot] = None
            seq.slot = -1
        self._free_seq(seq)
        self.seqs.pop(seq.request_id, None)

    def _check_finish(self, seq: Sequence, tok: int) -> tuple[bool, Optional[str]]:
        sp: SamplingParams = seq.sampling
        if not sp.ignore_eos and tok in (sp.stop_token_ids or ()):
            return True, "stop"
        if seq.num_generated >= seq.max_tokens:
            return True, "length"
        if len(seq.token_ids) >= self.cfg.max_model_len:
            return True, "length"
        return False, None

    # ------------------------------------------------------------ convenience
    def generate(self, prompts: list[list[int]],
                 sampling: Optional[SamplingParams] = None) -> dict[str, list[int]]:
        """Blocking batch generation (tests/bench); request_id → generated ids."""
        for i, p in enumerate(prompts):
            self.add_request(f"req-{i}", p, sampling)
        done: dict[str, list[int]] = {f"req-{i}": [] for i in range(len(prompts))}
        while self.has_work():
            for out in self.step():
                done[out.request_id].extend(out.new_token_ids)
        return done
