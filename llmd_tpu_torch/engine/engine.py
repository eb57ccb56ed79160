"""LLMEngine: continuous batching over the paged PyTorch model (port of
``llmd_tpu/engine/engine.py``).

Step programs, held in a ``ProgramRegistry`` (``engine/programs.py``) that
``step()`` routes through (registration order is priority: ``unified``,
``verify``, ``decode``; the masked variants are dispatched by them):

- ``unified`` (reference ``_step_unified``): decode rows plus prefill chunks of
  several sequences packed into one flat token batch under the
  ``max_num_batched_tokens`` budget; only each sequence's last row is
  unembedded, and sequences whose prompt completes sample their first token.
  Runs while any sequence is prefilling.
- ``decode`` (reference ``_step_decode`` / ``_decode_multi``): the decode
  program (``engine/decode_program.py``), ``decode_steps`` iterations over a
  static batch of one row per slot, sampled tokens fed back on the device.
  Each row carries a ``steps_left`` budget (max_tokens / max_model_len) and
  freezes once it is spent; idle slots ride along at position -1. On the
  card the program is captured once into a CUDA graph at the first decode
  call (``engine/cuda_graph.py``) and replayed once per call; the
  constructor's ``decode_graph=False`` runs the same program eagerly (on the
  CPU it always runs eagerly).
- ``verify`` / ``verify_masked`` (reference ``_verify`` / ``_verify_masked``,
  ``engine/verify_program.py``), with ``spec_mode="ngram"``: each
  decode-ready greedy row's last token and its prompt-lookup draft
  (``engine/spec.py``) packed as a short chunk; the longest draft prefix that
  matches the greedy tokens is accepted with one bonus token, and the pages
  grown for a rejected tail go back to the free list. Sampled rows never
  draft (temperature fallback); a row whose probe finds nothing is disarmed
  until fresh tokens land for it (``Sequence.spec_armed``). Eager.
- ``decode_masked`` (reference ``_decode_multi_masked``): the decode program
  for batches with grammar-constrained or ``logit_bias`` rows, the bias and
  the automaton step on the device from tables staged once a chain
  (``_plan_chain_masks``, ``_mask_tables``), captured lazily as a second
  graph at its first call. Batches it cannot express (a row with a grammar
  and a bias, tables past ``structured_table_max_elems``,
  ``structured_fused_decode`` off) degrade to one-token unified steps, which
  sample with a host-built bias (``_build_bias``), as in the reference.

- ``embed`` (reference ``_embed``): one sequence's prefill chunk at
  ``prefill_chunk`` width (padding rows at position -1) through the model,
  returning the float32 sum of its valid rows' final hidden states; it has no
  eligibility predicate: ``embed()`` (``/v1/embeddings``) drives it eagerly
  on the engine's stream, over pages borrowed from the allocator.

Multi-adapter LoRA (``EngineConfig.lora``, ``models/lora.py``; GQA models):
the adapter bank lives beside the params (``_run_params``) and is written in
place by ``load_lora_adapter`` / ``unload_lora_adapter`` (zero the slot, then
copy into it), so the captured decode graphs, which hold its address, read
the adapters loaded after their capture. Every program takes each token's
adapter slot: the unified and verify packs per token, the decode programs per
row (``PACKED["lora"]``), the embed program per chunk. The registry's
running / waiting counts follow admission, preemption, retirement and abort,
as the reference's; block hashes chain the adapter's generation-scoped key
(``_lora_hash_key``: name and a digest of the loaded weights).

Multimodal (``mm_tokens`` > 0): ``add_request(mm_items=)`` takes one
(identity, ``[mm_tokens, hidden]`` rows) pair per media item, whose
placeholders the prompt must carry (the reference's checks and messages).
The identities fold into every block key of the sequence (admission's prefix
lookup, the committed blocks, hence the offload tiers, the connector, the KV
events and P/D). A unified step that carries media prefill rows builds the
``mm_embeds`` / ``mm_mask`` buffers the forward writes over the placeholder
embeddings: row j of a chunk takes item ``occ // k``, row ``occ % k``, where
``occ`` counts the placeholders before it, so a chunk boundary inside an
image and a recompute after preemption give the reference's rows. Decode,
verify and the masked programs carry no media rows.

Structured outputs (``llmd_tpu_torch/structured``): admission compiles the
request's grammar through the process-wide cache (a tokenizer is needed);
each constrained ``Sequence`` carries its automaton cursor, re-synced from its
tokens, so preemption needs nothing more, and a violation or a truncated
generation counts in ``structured_violations``.

Attention: the unified program runs K1's wrapper (``paged_attention``), the
decode program what ``programs.select_decode_attn_impl`` picks: K1 again for
GQA models, the latent decode kernel K3 for MLA models (whose pool is the
single-plane latent pool, which K1 also serves for the unified program).

Also carried over: admission with prefix-cache reuse (chained block hashes),
chunked prefill across sequences, preemption by recompute when pages run out,
the tight-pool degrade of a multi-step decode to one unified step, and for MoE
models the dispatch choice (``_select_moe_dispatch``), the dropped-copy count
and EPLB (redundant expert slots re-placed every ``step_interval`` steps that
routed tokens, from a sliding window of expert loads, gathered in place into
buffers allocated once, so a captured graph reads the new placement).

The reference's pipelined dispatch (``_step_decode``, ``_decode_dispatch``,
``_decode_process``): with ``pipeline_decode`` the host launches call N+1
chained on call N's device-resident tokens, positions and kv lengths and
reads N's tokens while N+1 runs, up to ``pipeline_depth`` calls in flight,
while the batch's membership is unchanged (any change flushes first). With
``pack_overlap`` a chained call uploads only ``steps_left``, and the page
tables when a row grew a page, from pinned host buffers rotated over
``pipeline_depth + 1`` sets. Each call's tokens (and MoE drops and expert
counts) come back by one non-blocking copy into a pinned ring slot and a CUDA
event, which ``_decode_process`` waits on. With ``pipeline_prefill_sample`` a
unified step without decode rows defers reading its sampled first tokens to
the next step the same way. A MoE model's unified step still reads its
dropped copies and expert loads back at once, as the reference does. The
unified program packs exactly its real tokens; the capacity-einsum MoE path
is told where each row sits in the reference's padded batch
(``forward_core(moe_rows=...)``), so its capacity, and with it its drops,
follow the reference's.

Accounting, as the reference's: ``EngineStats`` (with the reference's spec
and structured fields) splits each program's wall
into host pack, device and post-processing (``instrument`` waits for the
unified program's outputs before stamping its device time; a decode call's
device time is the wait for its results), each ``Sequence`` keeps its
``first_token_time``, and the utilization ledger (``obs/costmodel.py``, on
unless ``LLMD_UTIL_LEDGER=0``) records each dispatch's analytic cost, wall
and goodput classes. The port's unified program runs exactly its real
tokens, so its dispatches carry no padding class; the decode program's
``B x k`` slot-steps do. The ledger's compile count is the decode programs'
CUDA-graph captures; ``programs`` counts each program's dispatches and
completions, and every drain asserts that they balance.

int8 weight-only (``quantize_weights="int8"``): the params are quantized at
construction (``models/quant.py``); EPLB regathers int8 banks and their
scales by the same slot map.

Metrics: ``self.registry`` holds the reference's engine families
(``obs/metrics.py``), moved at the reference's sites from numbers the host
already holds: the decode program's are counted when a call's readback is
processed, never inside the program, so a graph's warm-up and capture count
nothing and a replay adds no device work. The server renders the registry at
``/metrics``.

Observability (reference ``engine.py:220-265``, its record sites and probes):
``self.flight`` (``obs/events.py``) records each request's timeline at the
reference's sites (arrival, structured_compile, admitted, prefill_start /
prefill_end, chain_dispatch, first_token, decode, spec_draft / spec_verify,
structured_mask, preempted, kv_reload, retired / aborted; chain_retire and
kv_offload as system events); every retired timeline feeds
``request_phase_seconds`` (``obs/attribution.py``) and, unless
``LLMD_DECISION_LEDGER=0``, the engine's decision counters
(``obs/decisions.py``). A request's ``trace_ctx`` keys its record, puts its
trace id on the ``step_duration`` exemplars and, when sampled, parents one
``engine.step`` span a step. All of it is host work: a replayed decode call
launches what it did before. The step phases enter
``torch.profiler.record_function`` under the reference's names while a
``/debug/profile`` capture is open (``obs/device.profile_phase``). The
sampled phase probes (``_run_phase_probes``) add ``step_duration`` samples
of phase ``attn`` and, on the sorted MoE dispatch, ``moe_dispatch`` /
``moe_experts`` / ``moe_combine``.

The KV data plane, at the reference's sites: with ``cpu_offload_pages`` or
``offload_fs_path`` the allocator's evict hook and a proactive drain
(``_offload_drain``, the oldest LRU pages demoted in one gather a step) feed
the CPU/FS tiers (``kv/offload.py``); with ``kv_connector`` an external
engine (``kv/connector_api.py``) is consulted past them and receives each
retired request's blocks on a one-thread executor; with
``LLMD_KV_DURABLE_STORE`` set, evicted and demoted blocks are also queued to
the durable store (``kv/writeback.py``). Admission walks HBM, then CPU/FS
(``_reload_offloaded``, ``stats.total_offload_loads``), then the connector
(``_load_from_connector``). Every reload and inject writes the pool in place
on the engine's stream, so the captured decode programs read the new pages.

Entry point device: a CUDA card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from llmd_tpu_torch.core.kv_events import KVEvent, block_keys_for_tokens
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.disagg.transfer import drain_staged, gather_pages, stage_pages
from llmd_tpu_torch.engine.config import EngineConfig
from llmd_tpu_torch.engine.cuda_graph import CapturedProgram
from llmd_tpu_torch.engine.decode_program import (
    PACKED, DecodeBuffers, MaskTables, decode_program, run_chained)
from llmd_tpu_torch.engine.kv_manager import PageAllocator, Sequence
from llmd_tpu_torch.engine.programs import ProgramRegistry, select_decode_attn_impl
from llmd_tpu_torch.engine.sampling import greedy_tokens, sample_tokens, sample_tokens_biased
from llmd_tpu_torch.engine.spec import propose_ngram_draft
from llmd_tpu_torch.engine.verify_program import verify, verify_masked, verify_states
from llmd_tpu_torch.kv.connector_api import build_kv_connector
from llmd_tpu_torch.kv.dtypes import to_host
from llmd_tpu_torch.kv.fs_backend import FSKVBackend
from llmd_tpu_torch.kv.offload import KVOffloadConnector
from llmd_tpu_torch.kv.writeback import DurableStoreClient, DurableStoreConfig, WritebackQueue
from llmd_tpu_torch.models.config import ModelConfig
from llmd_tpu_torch.models.lora import (
    LoRARegistry, adapter_digest, init_lora_params, lora_dims, make_adapter_weights)
from llmd_tpu_torch.models.quant import quantize_params
from llmd_tpu_torch.models.transformer import (
    SORTED_DISPATCH,
    check_supported,
    forward_core,
    init_cache,
    init_params,
    unembed,
)
from llmd_tpu_torch.obs.attribution import attach_phase_exporter
from llmd_tpu_torch.obs.costmodel import (
    UtilLedger, attach_util_exporter, util_ledger_enabled)
from llmd_tpu_torch.obs.decisions import attach_decision_exporter, decisions_enabled
from llmd_tpu_torch.obs.device import profile_phase
from llmd_tpu_torch.obs.events import FlightRecorder
from llmd_tpu_torch.obs.metrics import Registry, register_engine_metrics
from llmd_tpu_torch.obs.tracing import global_tracer
from llmd_tpu_torch.ops.moe_dispatch import (
    combine_stage, dispatch_stage, experts_scaled, experts_stage, pick_block_size)
from llmd_tpu_torch.ops.paged_attention import paged_attention
from llmd_tpu_torch.parallel.eplb import ExpertLoadTracker, balance_ratio, rebalance
from llmd_tpu_torch.structured import (
    NEG_BIAS, StructuredState, compile_grammar, parse_logit_bias, structured_spec)


def resolve_device(device: "torch.device | str | None" = None) -> torch.device:
    """The card by default; the CPU only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on a CUDA device by default and none is "
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
    total_offload_loads: int = 0  # blocks pulled back from the CPU/FS tiers
    attn_backend: str = ""  # kernel provenance
    kv_cache_dtype: str = ""  # "fp8" | the model dtype's name: pool dtype provenance
    moe_backend: str = ""  # expert-GEMM provenance
    moe_dispatch: str = ""  # "sorted" | "einsum" | "n/a (dense model)"
    moe_dropped_tokens: int = 0  # routed copies dropped past capacity (einsum)
    eplb_rebalances: int = 0  # expert-placement recomputes
    # wall time of each program as the host sees it: a unified step's (its
    # deferred sample, if any, lands in the next step's); a decode call's
    # dispatch (pack, uploads, launch) plus its processing (waiting for its
    # results, applying them)
    time_prefill_steps: float = 0.0
    time_decode_steps: float = 0.0
    time_spec_steps: float = 0.0  # wall of speculative verify steps
    time_host_pack: float = 0.0  # unified packs and full packs of decode calls
    time_pack_overlap: float = 0.0  # chained packs, while earlier calls run
    # a unified step's forward (waited for under ``instrument``) and a decode
    # call's wait for its results; the decode share apart
    time_device: float = 0.0
    time_device_decode: float = 0.0
    time_postprocess: float = 0.0  # host output handling after the device
    n_unified_steps: int = 0
    n_decode_calls: int = 0  # decode calls processed
    n_decode_dispatches: int = 0  # decode calls launched (== calls at quiesce)
    n_chained_dispatches: int = 0  # of those, chained on an in-flight call
    n_decode_iterations: int = 0  # forward passes run by decode calls (k each)
    decode_graph_captures: int = 0  # both decode programs' captures
    decode_graph_replays: int = 0
    decode_graph_capture_s: float = 0.0
    # Speculative decoding (spec_mode="ngram"): prompt-lookup drafts verified
    # by the verify programs; the constrained share (grammar or logit_bias
    # rows) apart, and with spec_structured_crosscheck the device / host FSM
    # state disagreements (must stay 0)
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_rejected: int = 0
    n_spec_verify_steps: int = 0
    spec_drafted_constrained: int = 0
    spec_accepted_constrained: int = 0
    spec_fsm_crosscheck_mismatches: int = 0
    # Structured outputs: constrained requests admitted, host bias builds
    # of unified steps, tokens outside the grammar (0; a truncated
    # constrained generation counts 1 at retirement), the host's mask wall
    # (bias builds and table stagings) and the masked chains' table stagings
    structured_requests: int = 0
    structured_mask_builds: int = 0
    structured_violations: int = 0
    time_mask_build: float = 0.0
    structured_chain_stages: int = 0


def _constrained(s: Sequence) -> bool:
    """The row needs the biased sampler: a grammar or a logit_bias."""
    return s.structured is not None or bool(s.logit_bias)


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


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
        decode_graph: bool = True,
        tokenizer: Optional[object] = None,
    ) -> None:
        """``decode_graph``: on a CUDA device, capture the decode programs
        into CUDA graphs and replay them (default); False runs the same
        programs eagerly, for comparison. A CPU engine always runs them
        eagerly. ``tokenizer``: the vocabulary that structured requests'
        grammars are lifted onto (a structured request without one is
        refused at ``add_request``)."""
        self.device = resolve_device(device)
        check_supported(model_cfg)
        engine_cfg.check_served()
        self.model_cfg = model_cfg
        self.cfg = engine_cfg
        self.tokenizer = tokenizer
        self.alloc = PageAllocator(engine_cfg.num_pages, engine_cfg.page_size,
                                   enable_prefix_caching=engine_cfg.enable_prefix_caching,
                                   event_sink=event_sink)
        self.waiting: deque[Sequence] = deque()
        self.running: list[Optional[Sequence]] = [None] * engine_cfg.max_batch_size
        self.seqs: dict[str, Sequence] = {}
        self.stats = EngineStats()
        self._outputs: list[EngineOutput] = []
        # the step loop's metric families; the server renders them at /metrics
        self.registry = Registry()
        self.metrics = register_engine_metrics(self.registry)
        self._init_observability()
        # the step programs (registration order = routing priority); the
        # masked variants have no run hook: a routable program dispatches them
        self.programs = ProgramRegistry(
            on_dispatch=lambda name: self.metrics.program_dispatches.labels(program=name).inc())
        reg = self.programs.register
        reg("unified", eligible=LLMEngine._unified_eligible, run=LLMEngine._run_unified_program)
        reg("verify", eligible=lambda eng: eng.cfg.spec_mode == "ngram",
            run=LLMEngine._run_verify_program)
        reg("verify_masked")
        reg("decode", eligible=lambda eng: True, run=LLMEngine._run_decode_program)
        reg("decode_masked")
        reg("embed")
        self.metrics.cache_config.labels(
            block_size=engine_cfg.page_size, num_gpu_blocks=engine_cfg.num_pages).set(1)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(model_cfg, gen, self.device)
        else:  # int8 leaves and their float32 scales keep their dtypes
            params = {k: v.to(device=self.device) if k.endswith(("_q", "_scale"))
                      else v.to(device=self.device, dtype=model_cfg.torch_dtype)
                      for k, v in params.items()}
        if engine_cfg.quantize_weights == "int8" and "unembed_q" not in params:
            params = quantize_params(model_cfg, params)
        self.quantization = engine_cfg.quantize_weights
        self.params = params
        fp8 = engine_cfg.kv_cache_dtype == "fp8"
        self.cache = init_cache(model_cfg, engine_cfg.num_pages, engine_cfg.page_size,
                                dtype=torch.float8_e4m3fn if fp8 else None,
                                device=self.device)
        self.stats.kv_cache_dtype = ("fp8" if fp8
                                     else str(model_cfg.torch_dtype).removeprefix("torch."))
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
        # no launch-config tune table yet: the reference's "none"
        self.metrics.attn_backend_info.labels(backend=self.attn_backend, tune="none").set(1)
        self._moe_dispatch_impl = self._select_moe_dispatch()
        self.stats.moe_backend = self.moe_backend
        self.stats.moe_dispatch = self.moe_dispatch
        self._eplb = None
        if engine_cfg.eplb is not None and model_cfg.is_moe:
            self._init_eplb()
        self._init_lora()
        # the pipelined dispatch: in-flight decode calls and the deferred
        # prefill sample; all copies are ordered on the engine's stream
        self._stream = torch.cuda.current_stream(self.device) if on_card else None
        self._pending_decode: list[dict] = []
        self._pending_sample: Optional[dict] = None
        self._decode_graph = decode_graph and on_card
        # the decode programs, plain and masked, each built at its first use
        self._decode_fn: Optional[Callable[[], torch.Tensor]] = None
        self._decode_masked_fn: Optional[Callable[[], torch.Tensor]] = None
        self._decode_bufs: Optional[DecodeBuffers] = None
        self._pack_bufs: list[dict[str, torch.Tensor]] = []
        self._result_ring: list[torch.Tensor] = []
        # the masked programs' staged tables (allocated at the first masked
        # call) and an LRU of their host arrays, keyed by the participating
        # constraints and the padded shape; an entry keeps its grammars alive
        # so an id-keyed slot is never reused by another grammar
        self._mask_buffers: Optional[MaskTables] = None
        self._mask_tab_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._init_phase_probes()
        self.util = None
        if util_ledger_enabled():
            self.util = UtilLedger(
                model_cfg, device_kind=torch.cuda.get_device_name(self.device)
                if on_card else "", quantize_weights=engine_cfg.quantize_weights,
                kv_cache_dtype=engine_cfg.kv_cache_dtype)
            attach_util_exporter(self.util, self.metrics)
        self._init_kv_plane(event_sink)

    def _init_observability(self) -> None:
        """The reference constructor's observability (``engine/engine.py:
        220-265``): the process tracer, the always-on flight recorder (served
        at ``/debug/requests``), the phase exporter feeding
        ``request_phase_seconds`` and, unless ``LLMD_DECISION_LEDGER=0`` (read
        once), the engine's decision exporter chained after it. ``monitor``
        is the server's ``DeviceMonitor``, whose heartbeat the engine loop
        stamps."""
        self.tracer = global_tracer()
        self.flight = FlightRecorder.from_env(tracer=self.tracer)
        attach_phase_exporter(self.flight, self.metrics.request_phase)
        self._decisions_on = decisions_enabled()
        if self._decisions_on:
            attach_decision_exporter(self.flight, self.metrics)
        self.monitor = None

    def _init_kv_plane(self, event_sink) -> None:
        """The offload tiers, the external connector and the durable tier
        (reference constructor, ``engine/engine.py:266-322``)."""
        cfg = self.cfg
        self.offload = None
        if cfg.cpu_offload_pages > 0 or cfg.offload_fs_path:
            fs = FSKVBackend(cfg.offload_fs_path) if cfg.offload_fs_path else None
            self.offload = KVOffloadConnector(
                cfg.cpu_offload_pages, staging_blocks=cfg.offload_staging_blocks,
                fs_backend=fs, event_sink=event_sink, pages_per_layer=cfg.num_pages,
                metrics=self.metrics, flight=self.flight)
            self.alloc.evict_hook = lambda h, pid: self.offload.on_evict(self.cache, h, pid)
            store = self.offload.store
            self.metrics.offload_saves.set_function(lambda: store.saves)
            self.metrics.offload_loads.set_function(lambda: store.loads)
            self.metrics.offload_demotions.set_function(lambda: store.demotions)
            self.metrics.offload_cpu_blocks.set_function(lambda: len(store))
        # the out-of-tree connector: an external engine behind the native tiers;
        # one drain thread streams saves out in retirement order, off the step loop
        self.kv_connector = None
        self._connector_pool = None
        if cfg.kv_connector:
            self.kv_connector = build_kv_connector(cfg.kv_connector, cfg.kv_connector_params)
            self._connector_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="kv-connector")
        # the cluster-durable prefix tier: off unless LLMD_KV_DURABLE_STORE is set
        self.durable = None
        self.writeback = None
        durable_cfg = DurableStoreConfig.from_env()
        if durable_cfg.enabled:
            self.durable = DurableStoreClient(durable_cfg)
            self.writeback = WritebackQueue(self.durable, max_blocks=durable_cfg.queue_blocks)
            if self.offload is not None:
                # eviction and demotion tee their host bytes into the queue
                self.offload.writeback = self.writeback
            else:
                def _durable_evict(h: int, pid: int) -> None:
                    block = gather_pages(self.cache, [pid], self.cfg.num_pages)
                    self.writeback.offer([h], to_host(block))

                self.alloc.evict_hook = _durable_evict

    def compile_counts(self) -> dict[str, int]:
        """The ledger's compile count per program: CUDA-graph captures (the
        decode programs'; the unified and verify programs run eagerly)."""
        return self.programs.compile_counts()

    def _select_moe_dispatch(self) -> Optional[Callable]:
        """The MoE token dispatch (reference ``_select_moe_dispatch``, one
        device): ``sorted`` gives the drop-free sorted path (expert GEMMs
        through K2), ``einsum`` the capacity path (K4); ``auto`` takes
        ``LLMD_MOE_DISPATCH`` when set, else sorted. Returns the
        dispatch_impl, None for einsum."""
        if not self.model_cfg.is_moe:
            self.moe_dispatch = self.moe_backend = "n/a (dense model)"
            return None
        mode = self.cfg.moe_dispatch
        if mode == "auto":
            mode = os.environ.get("LLMD_MOE_DISPATCH", "") or "sorted"
        if mode not in ("sorted", "einsum"):
            raise ValueError(f"moe_dispatch must be auto|sorted|einsum, got {mode!r}")
        self.moe_dispatch = mode
        if self.device.type != "cuda":
            self.moe_backend = "torch_reference (cpu tensors)"
        elif "moe_wi_q" in self.params:  # the grouped GEMM kernels are bf16/f32
            self.moe_backend = "torch_bmm (int8 weights)"
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
        S = self._eplb_slots = E + e.num_redundant_experts  # one EP rank
        self._eplb_tracker = ExpertLoadTracker(L, E, e.window_size)
        self._eplb_steps = 0
        self._eplb_active = False  # set when a forward actually routed tokens
        # the physical slot weights and replica tables, allocated once and
        # re-gathered in place: a captured graph keeps reading these buffers.
        # The replica dim is padded to its most (one expert owning every
        # redundant slot), as the reference pads it (no new shapes).
        p, dev = self.params, self.device
        self._eplb_rmax = S - E + 1
        # int8 banks move with their per-expert scales by the same slot map
        self._eplb_banks = (("moe_wi_q", "moe_wo_q", "moe_wi_scale", "moe_wo_scale")
                            if "moe_wi_q" in p else ("moe_wi", "moe_wo"))
        self._eplb_params = {
            name: torch.empty((L, S, *p[name].shape[2:]), dtype=p[name].dtype, device=dev)
            for name in self._eplb_banks}
        self._eplb_params["eplb_replica_slots"] = torch.zeros(
            (L, E, self._eplb_rmax), dtype=torch.int32, device=dev)
        self._eplb_params["eplb_replica_counts"] = torch.zeros(
            (L, E), dtype=torch.int32, device=dev)
        self._eplb_s2e = self._eplb_counts = None  # the placement serving runs
        self._eplb_rebalance()

    def _eplb_rebalance(self) -> None:
        """Recompute the placement from the windowed loads and gather the
        physical slot weights on the device, in place (``index_select`` into
        the slot buffers). Calls already launched read the old placement
        first: the gather is ordered after them on the engine's stream."""
        loads = self._eplb_tracker.loads()
        # expert-load imbalance (max/mean routed tokens per EP rank, mean over
        # layers) under the outgoing placement and under the new one
        if self._eplb_s2e is not None:
            self.metrics.moe_ep_imbalance.labels(when="before").set(float(np.mean([
                balance_ratio(loads[l], self._eplb_s2e[l], self._eplb_counts[l], 1)
                for l in range(loads.shape[0])])))
        s2e, slots, counts = rebalance(loads, self._eplb_slots, 1)
        self.metrics.moe_ep_imbalance.labels(when="after").set(float(np.mean([
            balance_ratio(loads[l], s2e[l], counts[l], 1) for l in range(loads.shape[0])])))
        self._eplb_s2e, self._eplb_counts = s2e, counts
        L, S = s2e.shape
        E = self.model_cfg.moe_num_experts
        if slots.shape[2] < self._eplb_rmax:  # pad with the first replica (any is safe)
            pad = np.repeat(slots[:, :, :1], self._eplb_rmax - slots.shape[2], axis=2)
            slots = np.concatenate([slots, pad], axis=2)
        rows = self._tensor((np.arange(L)[:, None] * E + s2e).reshape(-1).astype(np.int64))
        ep = self._eplb_params
        for name in self._eplb_banks:
            w = self.params[name]  # [L, E, ...]
            torch.index_select(w.reshape(L * E, *w.shape[2:]), 0, rows,
                               out=ep[name].view(L * S, *w.shape[2:]))
        ep["eplb_replica_slots"].copy_(self._tensor(slots.astype(np.int32)))
        ep["eplb_replica_counts"].copy_(self._tensor(counts.astype(np.int32)))
        self.stats.eplb_rebalances += 1

    def _run_params(self) -> dict[str, torch.Tensor]:
        """Params seen by the forward: base weights, plus the physical expert
        weights and replica tables under EPLB, plus the LoRA adapter bank."""
        if self._eplb is None and not self._lora_params:
            return self.params
        return {**self.params, **(self._eplb_params if self._eplb is not None else {}),
                **self._lora_params}

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
                            moe_rows=moe_rows, lora_scale=self._lora_scale, **kw)

    # ----------------------------------------------------------------- LoRA
    # Dynamic adapter serving (reference engine.py:419-446, 1103-1192):
    # loading writes one slot of the fixed-shape bank in place, so no program
    # changes and the captured decode graphs read the new weights.
    def _init_lora(self) -> None:
        lcfg = self.cfg.lora
        self.lora_registry: Optional[LoRARegistry] = None
        self._lora_params: dict[str, torch.Tensor] = {}
        self._lora_keys: dict[str, str] = {}  # name -> "name@<weights digest>"
        self._lora_scale = 1.0
        if lcfg is None:
            return
        if self.model_cfg.is_mla:
            # the absorbed-attention branch applies no adapter delta: serving
            # would silently answer with the base model under adapter names
            raise ValueError(
                "LoRA adapters are not supported on MLA models (the absorbed-attention "
                "path has no adapter hook); remove EngineConfig.lora or use a GQA model")
        self.lora_registry = LoRARegistry(lcfg.max_adapters)
        # a displaced idle adapter's cached KV is invalid once its slot is reused
        self.lora_registry.on_evict = self._lora_forget
        self._lora_params = init_lora_params(self.model_cfg, lcfg, self.device)
        self._lora_scale = lcfg.scale

    def _lora_slot(self, seq: Sequence) -> int:
        return self.lora_registry.slot_of(seq.lora_id) if self.lora_registry else 0

    def _lora_hash_key(self, name: Optional[str]) -> Optional[str]:
        """The adapter term of block hashing: generation-scoped under LoRA
        serving, the plain name otherwise."""
        if name is None or self.lora_registry is None:
            return name
        return self._lora_keys.get(name, name)

    def _lora_forget(self, name: str) -> None:
        """Retire a name's KV: its cached pages go now; the dropped key keeps
        the offload tiers' copies from ever matching again."""
        self._lora_keys.pop(name, None)
        self.alloc.purge_lora(name)

    def _adapter_tensors(self, weights: dict) -> dict[str, torch.Tensor]:
        """``weights`` (numpy arrays or tensors, ``lora_A_<t> [L, Din, r]``,
        ``lora_B_<t> [L, r, Dout]``) checked and cast to the bank's dtype on
        the device. Raises KeyError for a leaf the bank lacks and ValueError
        for a shape or dtype it cannot take (a void-typed array, as numpy
        reads an ``ml_dtypes`` bfloat16 npz, is refused, not guessed at)."""
        L, r = self.model_cfg.num_layers, self.cfg.lora.rank
        dims_in, dims_out = lora_dims(self.model_cfg)
        out = {}
        for key, w in weights.items():
            if key not in self._lora_params:
                raise KeyError(f"unknown LoRA param {key!r}")
            t = key.rsplit("_", 1)[1]
            want = (L, dims_in[t], r) if key.startswith("lora_A_") else (L, r, dims_out[t])
            if not isinstance(w, torch.Tensor):
                a = np.asarray(w)
                if a.dtype.kind != "f":
                    raise ValueError(
                        f"LoRA param {key!r} has dtype {a.dtype} (a bfloat16 npz reads as "
                        "void without ml_dtypes): save the adapter as float32 or float16")
                w = torch.from_numpy(np.array(a))  # a writable copy
            if tuple(w.shape) != want:
                raise ValueError(f"LoRA param {key!r}: shape {tuple(w.shape)} != {want}")
            out[key] = w.to(device=self.device, dtype=self._lora_params[key].dtype)
        return out

    def _lora_write_slot(self, slot: int, weights: dict[str, torch.Tensor]) -> None:
        """Zero bank slot ``slot`` and copy ``weights`` into it, in place on
        the engine's stream (after every call already launched)."""
        with torch.no_grad(), self._on_stream():
            for key, bank in self._lora_params.items():
                view = bank[:, :, slot] if key.startswith("lora_A_") else bank[:, slot]
                view.zero_()
                if key in weights:
                    view.copy_(weights[key])

    def load_lora_adapter(self, name: str, weights: Optional[dict] = None,
                          seed: Optional[int] = None) -> int:
        """Install an adapter into a free slot; returns the slot. ``weights``
        maps ``lora_{A,B}_{target}`` to ``[L, ...]`` arrays (numpy or
        tensors); None draws a test double from ``seed`` (default: a seed
        derived from the name, so P/D peers agree on it)."""
        if self.lora_registry is None:
            raise RuntimeError("engine built without EngineConfig.lora")
        if self.lora_registry.has(name):
            if self.lora_registry.running.get(name) or self.lora_registry.waiting.get(name):
                # swapping weights under live sequences would mix two checkpoints
                raise RuntimeError(f"adapter {name!r} has in-flight requests")
            self._lora_forget(name)  # the old generation's KV must never match again
        if weights is None:
            import hashlib

            name_seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big")
            gen = torch.Generator(device=self.device).manual_seed(
                seed if seed is not None else name_seed)
            weights = make_adapter_weights(self.model_cfg, self.cfg.lora, gen)
        tensors = self._adapter_tensors(weights)
        slot = self.lora_registry.assign(name)
        self._lora_keys[name] = f"{name}@{adapter_digest(weights)}"
        self._lora_write_slot(slot, tensors)
        return slot

    def unload_lora_adapter(self, name: str) -> bool:
        if self.lora_registry is None:
            return False
        if self.lora_registry.running.get(name) or self.lora_registry.waiting.get(name):
            # freeing the slot mid-generation would switch live rows to the base model
            raise RuntimeError(f"adapter {name!r} has in-flight requests")
        slot = self.lora_registry.remove(name)
        if slot is None:
            return False
        self._lora_write_slot(slot, {})  # the null adapter again
        self._lora_forget(name)
        return True

    def _read_back(self, cnt: torch.Tensor, drop: torch.Tensor) -> None:
        """A MoE unified step's host read, as the reference's: its dropped
        copies and (under EPLB) its expert loads, in one copy."""
        parts = [drop.reshape(1).long()]
        if self._eplb is not None:
            parts.append(cnt.reshape(-1).long())
        self._record_moe(torch.cat(parts).cpu().numpy(), cnt.shape)

    def _record_moe(self, host: np.ndarray, cnt_shape) -> None:
        """Record ``host`` = [dropped copies, expert loads (EPLB only)...]."""
        self.stats.moe_dropped_tokens += int(host[0])
        self.metrics.moe_dropped_tokens.labels(path=self.moe_dispatch).inc(int(host[0]))
        if self._eplb is not None:
            self._eplb_tracker.record(host[1:].reshape(cnt_shape))
            self._eplb_active = True

    # ------------------------------------------------------------ requests
    def add_request(self, request_id: str, token_ids: list[int],
                    sampling: Optional[SamplingParams] = None,
                    lora_id: Optional[str] = None,
                    mm_items: Optional[list[tuple[bytes, np.ndarray]]] = None,
                    trace_ctx: Optional[object] = None) -> None:
        """Queue a request. ``trace_ctx``: the server's request span context;
        its trace id keys the flight record and the exemplars, and a sampled
        one parents the ``engine.step`` spans."""
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
        if lora_id and self.lora_registry is not None and not self.lora_registry.has(lora_id):
            # the server's 404: serving base weights under the name would also
            # poison the prefix cache under it
            raise ValueError(f"unknown LoRA adapter {lora_id!r}")
        mm_items = mm_items or []
        if mm_items:
            k = self.model_cfg.mm_tokens
            if k <= 0:
                raise ValueError("model has no vision tower (mm_tokens=0)")
            n_ph = sum(1 for t in token_ids if t == self.model_cfg.mm_placeholder_id)
            if n_ph != k * len(mm_items):
                raise ValueError(
                    f"{len(mm_items)} media items need {k * len(mm_items)} "
                    f"placeholder tokens, prompt has {n_ph}")
            for _, emb in mm_items:
                if emb.shape != (k, self.model_cfg.hidden_size):
                    raise ValueError(f"mm embedding shape {emb.shape} != "
                                     f"({k}, {self.model_cfg.hidden_size})")
        # Structured outputs: compile (or fetch) the token grammar before any
        # engine state changes, so a malformed spec raises ValueError (the
        # server's 400) without leaving a queued sequence behind
        logit_bias = parse_logit_bias(sampling.logit_bias)
        structured: Optional[StructuredState] = None
        compile_meta: Optional[tuple[str, bool, float]] = None
        spec = structured_spec(sampling)
        if spec is not None:
            if self.cfg.structured_mode == "off":
                raise ValueError("structured outputs are disabled (structured_mode='off')")
            if self.tokenizer is None:
                raise ValueError("structured request needs a tokenizer-equipped engine "
                                 "(LLMEngine(..., tokenizer=...))")
            kind, payload = spec
            tc0 = time.perf_counter()
            grammar, cache_hit = compile_grammar(kind, payload, self.tokenizer,
                                                 self.model_cfg.vocab_size)
            compile_s = time.perf_counter() - tc0
            structured = StructuredState(grammar, kind)
            compile_meta = (kind, cache_hit, compile_s)
            self.stats.structured_requests += 1
            m = self.metrics
            m.structured_requests.labels(kind=kind).inc()
            (m.structured_cache_hits if cache_hit else m.structured_cache_misses).inc()
            m.structured_compile_seconds.observe(compile_s)
        seq = Sequence(request_id=request_id, token_ids=list(token_ids),
                       prompt_len=len(token_ids), max_tokens=sampling.max_tokens,
                       sampling=sampling, lora_id=lora_id,
                       lora_key=self._lora_hash_key(lora_id), arrival_time=time.monotonic(),
                       structured=structured, logit_bias=logit_bias, mm_items=mm_items,
                       trace_ctx=trace_ctx)
        self.seqs[request_id] = seq
        self.waiting.append(seq)
        self.flight.start(request_id, model=self.model_cfg.name,
                          trace_id=getattr(trace_ctx, "trace_id", "") or "")
        self.flight.record(request_id, "arrival", prompt_len=len(token_ids), rank=0,
                           lora=lora_id)
        if compile_meta is not None:
            kind, cache_hit, compile_s = compile_meta
            self.flight.record(request_id, "structured_compile", kind=kind,
                               cache_hit=cache_hit, compile_ms=round(compile_s * 1e3, 3))
        if self.lora_registry is not None:
            self.lora_registry.on_waiting(lora_id)

    def abort(self, request_id: str) -> None:
        seq = self.seqs.pop(request_id, None)
        if seq is None:
            return
        self.flight.finish(request_id, event="aborted", status="aborted",
                           generated=seq.num_generated)
        if seq.slot >= 0:
            self.running[seq.slot] = None
            if self.lora_registry is not None:
                self.lora_registry.on_finished(seq.lora_id)
        elif self.lora_registry is not None and seq.lora_id:
            # aborted while queued: rewind the waiting count
            if self.lora_registry.waiting.get(seq.lora_id, 0) > 0:
                self.lora_registry.waiting[seq.lora_id] -= 1
        try:
            self.waiting.remove(seq)
        except ValueError:
            pass
        self._free_seq(seq)

    def has_work(self) -> bool:
        return (bool(self.waiting) or any(s is not None for s in self.running)
                or bool(self._pending_decode))

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
            keys = block_keys_for_tokens(seq.token_ids[: seq.prompt_len], ps, seq.lora_key,
                                         seq.mm_hashes())
            hit_pages = alloc.match_prefix(keys) if self.cfg.enable_prefix_caching else []
            # never reuse the whole prompt — the last token's logits must be computed
            max_reuse = max(0, (seq.prompt_len - 1) // ps)
            hit_pages = hit_pages[:max_reuse]
            # tiered continuation: blocks evicted from HBM may live on in CPU/FS
            n_offload = 0
            if self.offload is not None and len(hit_pages) < max_reuse:
                n_offload = self.offload.match_suffix(keys[len(hit_pages) : max_reuse])
            # ...and past the native tiers, the out-of-tree connector's engine
            n_conn = 0
            if self.kv_connector is not None and len(hit_pages) + n_offload < max_reuse:
                n_conn = self.kv_connector.get_num_matched_blocks(
                    keys[len(hit_pages) + n_offload : max_reuse])
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
                self.flight.finish(seq.request_id, event="retired", reason="length",
                                   generated=seq.num_generated)
                self._outputs.append(EngineOutput(
                    request_id=seq.request_id, new_token_ids=[], finished=True,
                    finish_reason="length", prompt_len=seq.prompt_len))
                continue
            if alloc.num_free - hits_in_lru < need_new:
                return  # head-of-line blocks; FCFS admission
            for pid in hit_pages:
                alloc.acquire_cached(pid)
            n_hbm = len(hit_pages)
            off_pages = self._reload_offloaded(seq, keys, n_hbm, n_offload)
            conn_pages: list[int] = []
            if n_conn > 0 and len(off_pages) == n_offload:
                conn_pages = self._load_from_connector(seq, keys, n_hbm + len(off_pages), n_conn)
            seq.pages = list(hit_pages) + off_pages + conn_pages
            n_cached = n_hbm + len(off_pages) + len(conn_pages)
            seq.block_hashes = keys[:n_cached]
            seq.num_computed = n_cached * ps
            seq.num_cached_prompt = seq.num_computed
            m = self.metrics
            m.prefix_cached_tokens.inc(seq.num_cached_prompt)
            m.prefix_prompt_tokens.inc(seq.prompt_len)
            m.prefix_hit_ratio.set(m.prefix_cached_tokens.value
                                   / max(1, m.prefix_prompt_tokens.value))
            seq.slot = slot
            self.running[slot] = seq
            self.waiting.popleft()
            self.flight.record(seq.request_id, "admitted", slot=slot, rank=0,
                               cached_tokens=seq.num_cached_prompt, pages=len(seq.pages))
            if self.lora_registry is not None:
                self.lora_registry.on_running(seq.lora_id)

    def _reload_offloaded(self, seq: Sequence, keys: list[int], n_hbm: int,
                          n_offload: int) -> list[int]:
        """Pull CPU/FS-tier blocks back into freshly allocated pages and
        re-index them (they emit BlockStored gpu again: resident now)."""
        pids = self._load_blocks(seq, keys, n_hbm, n_offload, lambda hashes, pids: (
            self.offload.load_into_cache(self.cache, hashes, pids, request_id=seq.request_id)))
        self.stats.total_offload_loads += len(pids)
        return pids

    def _load_from_connector(self, seq: Sequence, keys: list[int], start: int,
                             n_conn: int) -> list[int]:
        """Pull blocks from the out-of-tree connector's engine into fresh
        pages and commit them as prefix-cache entries."""
        return self._load_blocks(seq, keys, start, n_conn, lambda hashes, pids: (
            self.kv_connector.load_blocks(self.cache, hashes, pids, self.cfg.num_pages)))

    def _load_blocks(self, seq: Sequence, keys: list[int], start: int, n: int,
                     load: Callable) -> list[int]:
        """Allocate up to ``n`` pages, have ``load(hashes, pids)`` write the
        blocks of ``keys[start:]`` into them (in place; it returns the pool and
        how many it wrote), release the pages of a tail that vanished meanwhile
        and commit the rest under their keys."""
        if n <= 0:
            return []
        ps = self.cfg.page_size
        pids: list[int] = []
        for _ in range(n):
            pid = self.alloc.allocate()
            if pid is None:
                break
            pids.append(pid)
        if not pids:
            return []
        self.cache, n_loaded = load(keys[start : start + len(pids)], pids)
        for pid in pids[n_loaded:]:
            self.alloc.release(pid)
        pids = pids[:n_loaded]
        for i, pid in enumerate(pids):
            bi = start + i
            chunk = seq.token_ids[bi * ps : (bi + 1) * ps]
            self.alloc.commit_block(pid, keys[bi], chunk, keys[bi - 1] if bi > 0 else None,
                                    seq.lora_key)
        return pids

    def _offload_drain(self) -> None:
        """Keep the plain free list above the watermark by batch-demoting the
        oldest LRU pages (one gather a step), so evictions rarely hit the
        per-page on_evict backstop inside allocate()."""
        need = self.cfg.offload_watermark_pages - len(self.alloc.free)
        if need <= 0 or not self.alloc.lru:
            return
        n = min(need, self.cfg.offload_staging_blocks, len(self.alloc.lru))
        self.offload.demote_batch(self.cache, self.alloc.demote_lru(n))

    def _ensure_pages(self, seq: Sequence, upto_tokens: int) -> bool:
        need = (upto_tokens + self.cfg.page_size - 1) // self.cfg.page_size
        while len(seq.pages) < need:
            pid = self.alloc.allocate()
            if pid is None:
                self.metrics.kv_exhaustion.inc()
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
        evicting it would only reset it to token zero. A deferred prefill
        sample lands first: its sequence is idle and holds pages, and evicting
        it would drop its token."""
        self._flush_pending_sample()
        victims = [s for s in self.running if s is not None and s is not exclude]
        if not victims:
            return False
        victim = max(victims, key=lambda s: s.arrival_time)
        self.running[victim.slot] = None
        victim.slot = -1
        if self.lora_registry is not None:  # back to waiting: keep the counts true
            self.lora_registry.on_finished(victim.lora_id)
            self.lora_registry.on_waiting(victim.lora_id)
        self._free_seq(victim)
        victim.num_computed = 0
        victim.block_hashes = []
        victim.num_cached_prompt = 0
        self.waiting.appendleft(victim)
        self.stats.total_preemptions += 1
        self.metrics.preemptions.inc()
        self.flight.record(victim.request_id, "preempted", rank=0,
                           generated=victim.num_generated)
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
        """One engine iteration: admit, then run the first eligible step
        program of the registry: ``unified`` while any sequence is
        prefilling or a constrained row needs the unified degrade (after the
        decode calls in flight land), ``verify`` when ``spec_mode="ngram"``
        and drafts exist, ``decode`` otherwise (both after a deferred prefill
        sample lands)."""
        self._outputs = []
        with torch.no_grad(), self._on_stream():
            if self.offload is not None:
                self._offload_drain()
            self._try_admit()
            self.programs.route(self).run(self)
            if self._eplb is not None:
                self._eplb_tick()  # a rebalance is ordered after the calls in flight
        st = self.stats
        st.num_waiting = len(self.waiting)
        st.num_running = sum(1 for s in self.running if s is not None)
        st.kv_utilization = self.alloc.num_active / max(1, self.cfg.num_pages)
        m = self.metrics
        m.requests_waiting.set(st.num_waiting)
        m.requests_running.set(st.num_running)
        m.kv_usage.set(st.kv_utilization)
        m.batch_occupancy.labels(kind="running").observe(st.num_running)
        m.batch_occupancy.labels(kind="waiting").observe(st.num_waiting)
        return self._outputs

    # Eligibility predicates and run hooks of the routable programs;
    # ``route`` calls them unbound (``spec.eligible(engine)``).
    def _unified_eligible(self) -> bool:
        """The unified step serves prefill chunks, and is the one-token
        degrade of constrained rows the masked tables cannot express."""
        if self._prefilling_seqs():
            return True
        return (any(s is not None and _constrained(s) for s in self.running)
                and self._constrained_needs_unified())

    def _run_unified_program(self) -> None:
        self._flush_pending_decode()  # it reads the host's token state
        self._step_unified()

    def _run_verify_program(self) -> None:
        self._flush_pending_sample()  # first tokens land before a batch is built
        if not self._spec_try_verify():  # no draft: the decode program instead
            self._step_decode()

    def _run_decode_program(self) -> None:
        self._flush_pending_sample()
        self._step_decode()

    def _on_stream(self):
        """The engine's stream, whichever thread steps it."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device; on the card through pinned memory and a
        non-blocking copy, so the host never waits for the stream."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, t: torch.Tensor, host: Optional[torch.Tensor] = None):
        """Start the copy of ``t`` to the host: (host tensor, event to wait on
        before reading it; None on the CPU). ``host``: the pinned buffer to
        copy into (default a new one)."""
        if self.device.type == "cpu":
            return (t.clone() if host is None else host.copy_(t)), None
        if host is None:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return host, ev

    def _sample(self, logits: torch.Tensor, seqs: list[Sequence],
                bias: Optional[np.ndarray] = None) -> torch.Tensor:
        """Tokens for ``logits`` rows (one per seq in order), int32 on device;
        ``bias`` [rows, V] is added to the float32 logits first."""
        bias_t = self._tensor(bias) if bias is not None else None
        if all(s.sampling.temperature <= 0.0 for s in seqs):
            return greedy_tokens(logits if bias_t is None else logits.float() + bias_t)
        temp = self._tensor(np.array([s.sampling.temperature for s in seqs], np.float32))
        tk = self._tensor(np.array([s.sampling.top_k for s in seqs], np.int64))
        tp = self._tensor(np.array([s.sampling.top_p for s in seqs], np.float32))
        if bias_t is not None:
            return sample_tokens_biased(logits, bias_t, self._gen, temp, tk, tp)
        return sample_tokens(logits, self._gen, temp, tk, tp)

    @profile_phase("llmd.unified")
    def _step_unified(self) -> None:
        """Pack decode tokens + prefill chunks (across sequences) into the flat
        token budget and run ONE forward."""
        t0 = time.perf_counter()
        t0_ns = time.time_ns()
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
            # nothing schedulable: a deferred sample may be why (its rows hold
            # slots and pages until applied), so land it
            self._flush_pending_sample()
            return

        nb = len(plan)
        N = sum(n for _, n, _ in plan)
        toks = np.zeros((N,), np.int32)
        pos = np.zeros((N,), np.int32)
        sids = np.zeros((N,), np.int32)
        lora = np.zeros((N,), np.int32)
        pts = np.full((nb, self.cfg.max_pages_per_seq), -1, np.int32)
        lens = np.ones((nb,), np.int32)
        cu = np.zeros((nb + 1,), np.int32)
        # the media buffers only when this step carries media prefill rows:
        # row-aligned with the flat batch, mm_embeds[i] replaces the embedding
        # of toks[i] where mm_mask[i]
        media = any(s.mm_items and not is_decode for s, _, is_decode in plan)
        if media:
            mm_embeds = np.zeros((N, self.model_cfg.hidden_size), np.float32)
            mm_mask = np.zeros((N,), np.bool_)
        off = 0
        for i, (s, n, is_decode) in enumerate(plan):
            start = len(s.token_ids) - 1 if is_decode else s.num_computed
            toks[off : off + n] = s.token_ids[start : start + n]
            pos[off : off + n] = np.arange(start, start + n)
            sids[off : off + n] = i
            lora[off : off + n] = self._lora_slot(s)
            pts[i, : len(s.pages)] = s.pages
            lens[i] = start + n
            if media and s.mm_items and not is_decode:
                self._pack_media(s, start, toks[off : off + n], mm_embeds[off : off + n],
                                 mm_mask[off : off + n])
            off += n
            cu[i + 1] = off

        t1 = time.perf_counter()
        # a synchronous program: its outputs are consumed in this step
        self.programs.record_dispatch("unified")
        self.programs.record_complete("unified")
        # the reference runs its unified program on batched_tokens rows, real
        # rows first: row i of this batch is its row i
        hidden, self.cache, cnt, drop = self._forward(
            "unified", self._tensor(toks), self._tensor(pos), self._tensor(sids),
            self._tensor(pts), self._tensor(lens), cu_q_lens=self._tensor(cu),
            num_seqs=self._tensor(np.array([nb], np.int32)),
            moe_rows=(torch.arange(N, device=self.device), self.cfg.batched_tokens),
            lora_indices=self._tensor(lora) if self.lora_registry is not None else None,
            **({"mm_embeds": self._tensor(mm_embeds), "mm_mask": self._tensor(mm_mask)}
               if media else {}))
        if self.cfg.instrument and self._stream is not None:
            self._stream.synchronize()  # the program's outputs, before stamping t2
        t2 = time.perf_counter()
        if self.model_cfg.is_moe:
            self._read_back(cnt, drop)
        # goodput classes from the state before this step lands (reference
        # :1852-1864): a first chunk's cached prefix is saved work, and a
        # chunk of a sequence that already generated tokens recomputes
        # preempted work
        saved = recompute = 0
        for s, n, is_decode in plan:
            if not is_decode:
                if s.num_computed == s.num_cached_prompt and s.num_cached_prompt:
                    saved += s.num_cached_prompt
                if len(s.token_ids) > s.prompt_len:
                    recompute += n

        sample_rows: list[tuple[int, Sequence]] = []  # (plan row, seq)
        has_decode_rows = False
        for i, (s, n, is_decode) in enumerate(plan):
            if is_decode:
                s.num_computed = len(s.token_ids)
                s.maybe_commit_blocks(self.alloc)
                self.stats.total_decode_tokens += 1
                sample_rows.append((i, s))
                has_decode_rows = True
            else:
                if s.num_computed == s.num_cached_prompt:
                    # the first chunk of a (re)prefill: cached == computed
                    # holds only before any chunk lands
                    self.flight.record(s.request_id, "prefill_start",
                                       cached_tokens=s.num_cached_prompt)
                s.num_computed += n
                s.maybe_commit_blocks(self.alloc)
                self.stats.total_prefill_tokens += n
                if s.num_computed >= self._prefill_target(s):
                    self.flight.record(s.request_id, "prefill_end",
                                       prefill_tokens=s.num_computed)
                if len(s.token_ids) == s.prompt_len and s.num_computed == s.prompt_len:
                    sample_rows.append((i, s))  # prompt complete: first token
        # Pipelined sample read (reference :1894-1910): launch this step's
        # sampling, apply the PREVIOUS step's deferred sample while the device
        # runs, and defer this one; its rows are neither prefilling nor
        # decode-ready until applied. Steps with decode rows apply at once.
        rec = None
        if sample_rows:
            last = self._tensor(cu[[i + 1 for i, _ in sample_rows]] - 1)
            logits = unembed(self.model_cfg, self.params, hidden[last.long()])
            rec = self._sample_dispatch(sample_rows, logits, self._build_bias(
                [s for _, s in sample_rows], logits.shape[-1]))
        prev, self._pending_sample = self._pending_sample, None
        if prev is not None:
            self._sample_apply(prev)
        if rec is not None:
            if self.cfg.pipeline_prefill_sample and not has_decode_rows:
                self._pending_sample = rec
            else:
                self._sample_apply(rec)
        t3 = time.perf_counter()
        st = self.stats
        st.time_host_pack += t1 - t0
        st.time_device += t2 - t1
        st.time_postprocess += t3 - t2
        st.time_prefill_steps += t3 - t0
        st.n_unified_steps += 1
        n_dec = sum(1 for _, _, d in plan if d)
        n_pre = N - n_dec
        if n_dec:
            self.metrics.decode_tokens.inc(n_dec)
        if n_pre:
            self.metrics.prefill_tokens.inc(n_pre)
        self.metrics.step_duration.labels(phase="unified").observe(
            t3 - t0, exemplar=self._trace_exemplar([s for s, _, _ in plan]))
        if self.util is not None:
            # the program computes exactly its N real rows (no padding class);
            # KV reads ~ one pass over each row's resident KV, writes = N
            cost = self.util.cost("unified", slot_tokens=N, kv_read_tokens=int(lens.sum()),
                                  kv_write_tokens=N)
            self.util.record("unified", cost, t3 - t0, committed=N - recompute,
                             preempted_recompute=recompute, prefix_saved=saved,
                             compile_counts=self.compile_counts())
        self._emit_step_spans("unified", [s for s, _, _ in plan], t0_ns, nb, N)

    def _emit_step_spans(self, phase: str, seqs: list[Sequence], start_ns: int,
                         batch_size: int, n_tokens: int) -> None:
        """One ``engine.step`` child span per sampled sequence of the batch,
        parented on the request span carried in by ``add_request``: the step
        work nests under the server's ``engine.generate``."""
        for s in seqs:
            ctx = s.trace_ctx
            if ctx is None or not getattr(ctx, "sampled", False):
                continue
            span = self.tracer.start_span(
                "engine.step", parent=ctx,
                **{"llm_d.phase": phase, "llm_d.batch_size": batch_size,
                   "llm_d.step_tokens": n_tokens, "llm_d.request_id": s.request_id})
            span.start_ns = start_ns
            span.end()

    @staticmethod
    def _trace_exemplar(seqs) -> Optional[dict]:
        """OpenMetrics exemplar labels of the first traced sequence of a batch:
        a slow ``step_duration`` bucket links to a trace."""
        for s in seqs:
            ctx = s.trace_ctx
            if ctx is not None and getattr(ctx, "trace_id", ""):
                return {"trace_id": ctx.trace_id}
        return None

    def _pack_media(self, s: Sequence, start: int, toks: np.ndarray, embeds: np.ndarray,
                    mask: np.ndarray) -> None:
        """The media rows of ``s``'s prefill chunk starting at ``start``
        (``toks`` its tokens): placeholder occurrence ``occ`` of the prompt
        takes row ``occ % k`` of item ``occ // k``, ``occ`` counted from the
        prompt's start, so a chunk that begins inside an image continues it."""
        ph, k = self.model_cfg.mm_placeholder_id, self.model_cfg.mm_tokens
        occ = s.token_ids[:start].count(ph)
        hit = np.flatnonzero(toks == ph)
        item, row = np.divmod(occ + np.arange(len(hit)), k)
        for it in np.unique(item[item < len(s.mm_items)]):
            sel = item == it
            embeds[hit[sel]] = s.mm_items[it][1][row[sel]]
            mask[hit[sel]] = True

    @profile_phase("llmd.mask_build")
    def _build_bias(self, seqs: list[Sequence], vocab: int) -> Optional[np.ndarray]:
        """The host-built additive ``[rows, V]`` bias of a sample batch (one
        row per seq in order): each grammar row's allow-mask at its current
        automaton state plus any ``logit_bias`` entries. None when no row is
        constrained, which keeps the unbiased sampler."""
        if not any(_constrained(s) for s in seqs):
            return None
        t0 = time.perf_counter()
        bias = np.zeros((len(seqs), vocab), np.float32)
        for i, s in enumerate(seqs):
            st = s.structured
            if st is not None:
                self._count_violations(st.sync(s.token_ids, s.prompt_len))
                st.grammar.fill_bias(bias[i], st.state)
                self.stats.structured_mask_builds += 1
                self._log_first_mask(s)
            if s.logit_bias:
                row = bias[i]
                for tid, b in s.logit_bias.items():
                    if 0 <= tid < vocab:  # OpenAI semantics: -100 is an outright ban
                        row[tid] = NEG_BIAS if b <= -100.0 else row[tid] + b
        dt = time.perf_counter() - t0
        self.stats.time_mask_build += dt
        self.metrics.structured_mask_seconds.observe(dt)
        return bias

    def _log_first_mask(self, s: Sequence) -> None:
        """The ``structured_mask`` event of a constrained row's first mask
        (its timeline, not one event a step)."""
        st = s.structured
        if not st.mask_logged:
            st.mask_logged = True
            self.flight.record(s.request_id, "structured_mask", kind=st.kind,
                               n_allowed=int(len(st.grammar.allowed_ids(st.state))))

    def _count_violations(self, n: int) -> None:
        if n:
            self.stats.structured_violations += n
            self.metrics.structured_violations.inc(n)

    def _sample_dispatch(self, rows: list[tuple[int, Sequence]], logits: torch.Tensor,
                         bias: Optional[np.ndarray] = None) -> dict:
        """Sample ``logits`` (one row per entry of ``rows``; ``bias`` added
        first) on the device and start the copy of the tokens to the host;
        no wait here."""
        host, event = self._to_host(self._sample(logits, [s for _, s in rows], bias))
        self.programs.record_dispatch("sample")
        return {"host": host, "event": event, "rows": [(s, s.slot) for _, s in rows]}

    def _flush_pending_sample(self) -> None:
        rec, self._pending_sample = self._pending_sample, None
        if rec is not None:
            self._sample_apply(rec)

    def _sample_apply(self, rec: dict) -> None:
        """Wait for one dispatched sample's tokens and apply them."""
        if rec["event"] is not None:
            rec["event"].synchronize()
        self.programs.record_complete("sample")
        now = time.monotonic()
        for (s, slot), tok in zip(rec["rows"], rec["host"].tolist()):
            if s.finished or s.slot != slot or self.running[slot] is not s:
                continue  # aborted / preempted while the sample was in flight
            self._apply_token(s, tok, now)

    def _apply_token(self, s: Sequence, tok: int, now: float) -> None:
        s.token_ids.append(tok)
        if not s.spec_armed:
            s.spec_flips += 1
        s.spec_armed = True  # a fresh token landed: re-probe this row's drafter
        if s.structured is not None:
            self._count_violations(s.structured.sync(s.token_ids, s.prompt_len))
        self._first_token(s, now)
        finished, reason = self._check_finish(s, tok)
        if finished:
            self._retire(s, reason)
        self._outputs.append(EngineOutput(
            request_id=s.request_id, new_token_ids=[tok], finished=finished,
            finish_reason=reason, num_cached_prompt_tokens=s.num_cached_prompt,
            prompt_len=s.prompt_len))

    def _first_token(self, s: Sequence, now: float) -> None:
        """Stamp a sequence's first token (its ``first_token`` event)."""
        if s.first_token_time is None:
            s.first_token_time = now
            self.flight.record(s.request_id, "first_token",
                               ttft_ms=round((now - s.arrival_time) * 1e3, 3))

    # -------------------------------------------------------- speculation
    def _verify_nt(self) -> int:
        """The reference's static packed width of the verify programs: every
        draft is clamped to ``spec_tokens``, so ``max_batch_size *
        (spec_tokens + 1)`` rows hold the largest plan."""
        return min(self.cfg.batched_tokens,
                   self.cfg.max_batch_size * (self.cfg.spec_tokens + 1))

    def _spec_propose(self, s: Sequence, max_draft: int) -> list[int]:
        """Prompt-lookup draft of one decode-ready sequence, clamped so the
        verify step can land every accepted token plus the bonus token
        within max_tokens / max_model_len. A constrained row's draft is cut
        to its longest constraint-legal prefix."""
        k = min(self.cfg.spec_tokens, max_draft, s.max_tokens - s.num_generated - 1,
                self.cfg.max_model_len - len(s.token_ids) - 1)
        if k <= 0:
            return []
        draft = propose_ngram_draft(s.token_ids, k, self.cfg.spec_ngram_max,
                                    self.cfg.spec_ngram_min)[:k]
        if draft and _constrained(s):
            draft = self._spec_filter_draft(s, draft)
        return draft

    def _spec_filter_draft(self, s: Sequence, draft: list[int]) -> list[int]:
        """The longest prefix of ``draft`` that ``s``'s constraint allows: a
        grammar row walks its automaton from the synced state, a logit_bias
        row cuts at the first banned token. [] when spec_structured is off
        (constrained rows never draft)."""
        if not self.cfg.spec_structured:
            return []
        stt = s.structured
        if stt is not None:
            self._count_violations(stt.sync(s.token_ids, s.prompt_len))
            return draft[:stt.grammar.legal_prefix_len(stt.state, draft)]
        for i, t in enumerate(draft):
            if s.logit_bias.get(t, 0.0) <= -100.0:
                return draft[:i]
        return draft

    def _spec_try_verify(self) -> bool:
        """The decode path's speculation gate; True when a verify step ran
        in place of this step's decode call. The drafter probes the host's
        (possibly stale) view first, and only a probe that finds a draft
        pays for landing the decode calls in flight; drafts are then
        proposed again on the landed state."""
        active = self._decode_ready()
        if not active:
            return False
        # constrained rows ride only the masked verify program
        if any(_constrained(s) for s in active):
            if not (self.cfg.spec_structured and self._plan_chain_masks(active) is not None):
                return False
        # greedy acceptance equals sequential decoding only for greedy rows
        if any(s.sampling.temperature > 0.0 for s in active):
            return False
        probed = False
        for s in active:
            if s.spec_armed:
                if self._spec_propose(s, self.cfg.spec_tokens):
                    probed = True
                else:
                    s.spec_armed = False
                    s.spec_flips += 1
        if not probed:
            return False
        self._flush_pending_decode()
        active = [s for s in self._decode_ready() if s.slot >= 0]
        if not active:
            return True  # the flush retired or changed the batch: step done
        # every row gets its plain token; drafts share what is left
        spare = self._verify_nt() - len(active)
        plan: list[tuple[Sequence, list[int]]] = []
        for s in active:
            if len(plan) >= self.cfg.max_batch_size:
                break
            if s.slot < 0:
                continue  # preempted while packing an earlier row
            draft = self._spec_propose(s, max(0, spare)) if s.spec_armed else []
            if draft and not self._ensure_pages(s, len(s.token_ids) + len(draft)):
                draft = []  # shed the draft before shedding a sequence
            if not self._ensure_pages(s, len(s.token_ids)):
                if not self._preempt_one(exclude=s) or s.slot < 0:
                    self._finish_if_outgrew_pool(s)
                    continue
                if not self._ensure_pages(s, len(s.token_ids)):
                    continue
            plan.append((s, draft))
            spare -= len(draft)
        plan = [(s, d) for s, d in plan if s.slot >= 0]
        if any(_constrained(s) for s, _ in plan):
            # a constrained row may have become decode-ready in the flush: a
            # row the masked verify cannot express never rides the plain one
            if not (self.cfg.spec_structured
                    and self._plan_chain_masks([s for s, _ in plan]) is not None):
                return False
        if not any(d for _, d in plan):
            for s, _ in plan:  # no draft on the landed state: disarm until fresh tokens
                if s.spec_armed:
                    s.spec_armed = False
                    s.spec_flips += 1
            return False
        self._step_spec_verify(plan)
        return True

    @profile_phase("llmd.spec_verify")
    def _step_spec_verify(self, plan: list[tuple[Sequence, list[int]]]) -> None:
        """Pack each sequence's last token and draft as one chunk, run the
        verify program (the masked one when a row is constrained), accept
        the longest draft prefix matching the greedy tokens plus the bonus
        token, and release the pages grown for the rejected tail. The host's
        token state never holds an unverified draft token, so no page of one
        is ever committed."""
        t0 = time.perf_counter()
        t0_ns = time.time_ns()
        nb = len(plan)
        N = sum(1 + len(d) for _, d in plan)
        toks = np.zeros((N,), np.int32)
        pos = np.zeros((N,), np.int32)
        sids = np.zeros((N,), np.int32)
        lora = np.zeros((N,), np.int32)
        pts = np.full((nb, self.cfg.max_pages_per_seq), -1, np.int32)
        lens = np.ones((nb,), np.int32)
        cu = np.zeros((nb + 1,), np.int32)
        rows: list[tuple[Sequence, list[int], int, int]] = []
        off = 0
        for i, (s, draft) in enumerate(plan):
            start = len(s.token_ids) - 1
            n = 1 + len(draft)
            toks[off : off + n] = [s.token_ids[-1]] + draft
            pos[off : off + n] = np.arange(start, start + n)
            sids[off : off + n] = i
            lora[off : off + n] = self._lora_slot(s)
            pts[i, : len(s.pages)] = s.pages
            lens[i] = start + n
            if draft:
                s.spec_drafted += len(draft)
                self.stats.spec_drafted += len(draft)
                if _constrained(s):
                    self.stats.spec_drafted_constrained += len(draft)
                self.metrics.spec_drafted.inc(len(draft))
                self.flight.record(s.request_id, "spec_draft", drafted=len(draft))
            rows.append((s, draft, off, s.slot))
            off += n
            cu[i + 1] = off
        tm = time.perf_counter()
        # the mask staging's wall lands in time_mask_build, so the pack
        # split stops at tm
        mask = self._spec_stage_verify_masks(plan)
        prog = "verify" if mask is None else "verify_masked"
        t1 = time.perf_counter()
        self.programs.record_dispatch(prog)
        batch = {"tokens": toks, "positions": pos, "seq_slots": sids, "page_tables": pts,
                 "kv_lens": lens, "cu_q_lens": cu, "num_seqs": np.array([nb], np.int32)}
        if self.lora_registry is not None:
            batch["lora"] = lora
        batch = {k: self._tensor(v) for k, v in batch.items()}
        kw = dict(attn_impl=self._attn["unified"], moe_dispatch_impl=self._moe_dispatch_impl,
                  moe_rows=(torch.arange(N, device=self.device), self._verify_nt()),
                  lora_scale=self._lora_scale)
        if mask is None:
            greedy, self.cache, cnt, drop = verify(
                self.model_cfg, self._run_params(), self.cache, batch, **kw)
            out = greedy
        else:
            states = verify_states([(d, f, nx) for (_, d), f, nx in
                                    zip(plan, mask["fsm0"], mask["next"])])
            table_rows = np.repeat(mask["table_rows"], [1 + len(d) for _, d in plan])
            greedy, fsm_next, self.cache, cnt, drop = verify_masked(
                self.model_cfg, self._run_params(), self.cache, batch, mask["tables"],
                self._tensor(table_rows), self._tensor(states), **kw)
            out = torch.cat([greedy, fsm_next])
        # the designed sync point: acceptance needs the greedy tokens (and
        # the states after them) on the host
        host = out.cpu().numpy()
        g, fsm = host[:N], (host[N:] if mask is not None else None)
        self.programs.record_complete(prog)
        t2 = time.perf_counter()
        if self.model_cfg.is_moe:
            self._read_back(cnt, drop)
        now = time.monotonic()
        rej0 = self.stats.spec_rejected
        n_tokens = 0
        st = self.stats
        for s, draft, row0, slot in rows:
            if s.finished or s.slot != slot or self.running[slot] is not s:
                continue  # preempted while packing later rows
            kept: list[int] = []
            finished, reason = False, None
            # row j's greedy token continues chunk position j: accept drafts
            # while they match it, then the first divergence (the bonus token)
            for j in range(len(draft) + 1):
                t = int(g[row0 + j])
                kept.append(t)
                s.token_ids.append(t)
                finished, reason = self._check_finish(s, t)
                if finished or j >= len(draft) or draft[j] != t:
                    break
            accepted = sum(1 for j, t in enumerate(kept) if j < len(draft) and draft[j] == t)
            rejected = len(draft) - accepted
            s.num_computed = len(s.token_ids) - 1  # the newest token's KV is not written
            self._first_token(s, now)
            s.maybe_commit_blocks(self.alloc)
            self._spec_release_tail(s)
            constrained = _constrained(s)
            if fsm is not None and s.structured is not None:
                stt = s.structured
                dev_state = int(fsm[row0 + len(kept) - 1])
                if self.cfg.spec_structured_crosscheck:
                    # re-derive the state on the host and compare; a
                    # mismatch keeps the host's (and is a bug)
                    self._count_violations(stt.sync(s.token_ids, s.prompt_len))
                    if stt.state != dev_state:
                        st.spec_fsm_crosscheck_mismatches += 1
                else:
                    # the state after the last kept token is the automaton's:
                    # a rejected tail rolled back with the pages
                    stt.state = dev_state
                    stt.n_seen = len(s.token_ids) - s.prompt_len
            s.spec_accepted += accepted
            if not s.spec_armed:
                s.spec_flips += 1
            s.spec_armed = True  # fresh tokens landed for this row: re-probe
            st.spec_accepted += accepted
            st.spec_rejected += rejected
            if constrained:
                st.spec_accepted_constrained += accepted
            st.total_decode_tokens += len(kept)
            n_tokens += len(kept)
            if accepted:
                self.metrics.spec_accepted.inc(accepted)
            if rejected:
                self.metrics.spec_rejected.inc(rejected)
            if draft:
                self.flight.record(s.request_id, "spec_verify", drafted=len(draft),
                                   accepted=accepted, n_tokens=len(kept),
                                   constrained=constrained, generated=s.num_generated)
            else:
                self.flight.record(s.request_id, "decode", n_tokens=len(kept),
                                   generated=s.num_generated)
            if finished:
                self._retire(s, reason)
            self._outputs.append(EngineOutput(
                request_id=s.request_id, new_token_ids=kept, finished=finished,
                finish_reason=reason, num_cached_prompt_tokens=s.num_cached_prompt,
                prompt_len=s.prompt_len))
        t3 = time.perf_counter()
        st.time_host_pack += tm - t0
        st.time_device += t2 - t1
        st.time_postprocess += t3 - t2
        st.time_spec_steps += t3 - t0
        st.n_spec_verify_steps += 1
        if n_tokens:
            self.metrics.decode_tokens.inc(n_tokens)
        self.metrics.step_duration.labels(phase="spec_verify").observe(
            t3 - t0, exemplar=self._trace_exemplar([r[0] for r in rows]))
        if self.util is not None:
            # the program computes exactly its N packed rows: kept tokens
            # commit, rejected draft rows are the speculation's waste
            cost = self.util.cost(prog, slot_tokens=N, kv_read_tokens=int(lens.sum()),
                                  kv_write_tokens=N)
            self.util.record(prog, cost, t3 - t0, committed=n_tokens,
                             spec_rejected=self.stats.spec_rejected - rej0,
                             compile_counts=self.compile_counts())
        self._emit_step_spans("spec_verify", [r[0] for r in rows], t0_ns, nb, n_tokens)

    def _spec_release_tail(self, s: Sequence) -> None:
        """Give back the pages grown for rejected draft tokens: trim the
        page list to what the accepted length needs. Those pages hold no
        block hash (commits never cover unverified tokens), so they return
        to the free list."""
        ps = self.cfg.page_size
        need = max((len(s.token_ids) + ps - 1) // ps, len(s.block_hashes))
        while len(s.pages) > need:
            self.alloc.release(s.pages.pop())

    # ------------------------------------------------ masked programs' tables
    def _plan_chain_masks(self, active: list[Sequence]) -> Optional[dict]:
        """Table slots and the size gate of the masked programs. None when
        the batch's constrained rows cannot ride them and must degrade to
        unified steps: ``structured_fused_decode`` off, a row with a grammar
        AND a logit_bias (two bias sources, one table slot), or padded
        tables past ``structured_table_max_elems``. Tables are shared by
        grammar: G is 1 (the zero no-op grammar of unconstrained rows) +
        distinct grammars + one slot per logit_bias row."""
        if not self.cfg.structured_fused_decode:
            return None
        entries: list[tuple] = []  # table slot - 1 -> ("g", grammar) | ("b", items)
        rows: list[tuple] = []  # (seq, table slot) of the constrained rows
        gram_slot: dict[int, int] = {}
        key_parts: list[tuple] = []
        smax = 1
        for s in active:
            has_g, has_b = s.structured is not None, bool(s.logit_bias)
            if has_g and has_b:
                return None
            if has_g:
                g = s.structured.grammar
                gi = gram_slot.get(id(g))
                if gi is None:
                    gi = gram_slot[id(g)] = 1 + len(entries)
                    entries.append(("g", g))
                    smax = max(smax, g.n_states)
                rows.append((s, gi))
                key_parts.append((s.slot, "g", id(g)))
            elif has_b:
                items = tuple(sorted(s.logit_bias.items()))
                gi = 1 + len(entries)
                entries.append(("b", items))
                rows.append((s, gi))
                key_parts.append((s.slot, "b", items))
        if not rows:
            return None  # nothing constrained: the plain program serves it
        G_pad, S_pad = _pow2(1 + len(entries)), _pow2(smax)
        V = self.model_cfg.vocab_size
        if G_pad * S_pad * V > self.cfg.structured_table_max_elems:
            return None
        return {"entries": entries, "rows": rows, "key": tuple(key_parts),
                "G_pad": G_pad, "S_pad": S_pad, "V": V}

    def _constrained_needs_unified(self) -> bool:
        """True when this step's decode-ready constrained rows must take the
        unified degrade instead of the masked decode program."""
        active = self._decode_ready()
        if not any(_constrained(s) for s in active):
            return False
        return self._plan_chain_masks(active) is None

    def _mask_tables(self, plan: dict) -> MaskTables:
        """Stage a mask plan's dense ``[G_pad, S_pad, V]`` bias and next
        tables into the masked programs' static buffers (allocated at the
        first masked call); the host arrays are LRU-cached across chains and
        verify steps, and nothing is uploaded when the buffers already hold
        this plan's tables."""
        if self._mask_buffers is None:
            self._mask_buffers = MaskTables.allocate(self.cfg.structured_table_max_elems,
                                                     self.model_cfg.vocab_size, self.device)
        tables = self._mask_buffers
        key = (plan["key"], plan["G_pad"], plan["S_pad"])
        if tables.staged is not None and tables.staged[0] == key:
            return tables
        hit = self._mask_tab_cache.get(key)
        if hit is not None:
            self._mask_tab_cache.move_to_end(key)
        else:
            G_pad, S_pad, V = plan["G_pad"], plan["S_pad"], plan["V"]
            bias = np.zeros((G_pad, S_pad, V), np.float32)
            nxt = np.zeros((G_pad, S_pad, V), np.int32)
            pins = []
            for gi, (kind, payload) in enumerate(plan["entries"], start=1):
                if kind == "g":
                    pins.append(payload)
                    b, nx = payload.dense_tables()
                    bias[gi, : payload.n_states] = b
                    nxt[gi, : payload.n_states] = nx
                else:  # a logit_bias row: its state stays 0 (next stays 0)
                    row = bias[gi, 0]
                    for tid, bval in payload:
                        if 0 <= tid < V:  # OpenAI semantics: -100 is an outright ban
                            row[tid] = NEG_BIAS if bval <= -100.0 else row[tid] + bval
            hit = (bias.reshape(G_pad * S_pad, V), nxt.reshape(G_pad * S_pad, V), tuple(pins))
            self._mask_tab_cache[key] = hit
            while len(self._mask_tab_cache) > 8:
                self._mask_tab_cache.popitem(last=False)
        bias, nxt, pins = hit
        n = bias.shape[0]
        for dst, src in ((tables.bias, bias), (tables.next, nxt)):
            src_t = torch.from_numpy(src)
            if self.device.type == "cuda":
                src_t = src_t.pin_memory()
            dst[:n].copy_(src_t, non_blocking=True)
        tables.staged = (key, pins)
        return tables

    @profile_phase("llmd.chain_stage")
    def _stage_chain_masks(self, active: list[Sequence]) -> Optional[dict]:
        """Stage the tables of one masked chain, and each slot's table row
        and automaton entry state (``table_rows``, ``fsm0`` [B]). The wall
        lands in time_mask_build: one staging a chain, not a mask a step."""
        plan = self._plan_chain_masks(active)
        if plan is None:
            return None
        t0 = time.perf_counter()
        B = self.cfg.max_batch_size
        tables = self._mask_tables(plan)
        table_rows = np.zeros((B,), np.int32)
        fsm0 = np.zeros((B,), np.int32)
        for s, gi in plan["rows"]:
            table_rows[s.slot] = gi * plan["S_pad"]
            if s.structured is not None:  # a logit_bias row stays at state 0
                self._count_violations(s.structured.sync(s.token_ids, s.prompt_len))
                fsm0[s.slot] = s.structured.state
                self._log_first_mask(s)
        dt = time.perf_counter() - t0
        self.stats.time_mask_build += dt
        self.stats.structured_chain_stages += 1
        self.metrics.structured_mask_seconds.observe(dt)
        self.metrics.step_duration.labels(phase="chain_stage").observe(dt)
        return {"tables": tables, "table_rows": table_rows, "fsm0": fsm0}

    def _spec_stage_verify_masks(self, plan) -> Optional[dict]:
        """Mask staging of one masked verify step: the same tables as the
        chain's, and per PACKED ROW (plan order) the table row, the
        synced entry state and the grammar's host transition table (None
        for a row without a grammar), from which ``verify_states`` walks the
        drafts. None when no row of the plan is constrained."""
        seqs = [s for s, _ in plan]
        if not any(_constrained(s) for s in seqs):
            return None
        mplan = self._plan_chain_masks(seqs)
        if mplan is None:
            return None  # _spec_try_verify checks this before dispatch
        t0 = time.perf_counter()
        tables = self._mask_tables(mplan)
        slot_of = {id(s): gi for s, gi in mplan["rows"]}
        table_rows = np.zeros((len(plan),), np.int32)
        fsm0 = np.zeros((len(plan),), np.int32)
        nexts: list[Optional[np.ndarray]] = [None] * len(plan)
        for i, s in enumerate(seqs):
            gi = slot_of.get(id(s))
            if gi is None:
                continue  # an unconstrained row: the zero no-op grammar
            table_rows[i] = gi * mplan["S_pad"]
            stt = s.structured
            if stt is not None:
                self._count_violations(stt.sync(s.token_ids, s.prompt_len))
                fsm0[i] = stt.state
                nexts[i] = stt.grammar.dense_tables()[1]
        dt = time.perf_counter() - t0
        self.stats.time_mask_build += dt
        self.metrics.structured_mask_seconds.observe(dt)
        return {"tables": tables, "table_rows": table_rows, "fsm0": fsm0, "next": nexts}

    # ------------------------------------------------------------- decode
    def _step_decode(self) -> None:
        """Fused multi-step decode with the pipelined dispatch (reference
        ``_step_decode``): with ``pipeline_decode`` call N+1 is launched
        chained on call N's device-resident outputs and N's tokens are read
        while N+1 runs, while the batch's membership is unchanged; any change
        flushes the calls in flight first."""
        t0 = time.perf_counter()
        active = self._decode_ready()
        if not active:
            self._flush_pending_decode()
            return
        k = max(1, self.cfg.decode_steps)
        q = self._pending_decode
        off = sum(rec["k"] for rec in q)
        # The host knows every row's hard budget (max_tokens / max_model_len):
        # when the calls in flight already cover it for every row, one more
        # call could only compute frozen rows. Drain the oldest call instead.
        # (A stop token before the budget still speculates: that is the
        # pipeline's purpose.)
        if q:
            horizon = max(
                min(s.max_tokens - (len(s.token_ids) + off - s.prompt_len),
                    self.cfg.max_model_len - (len(s.token_ids) + off))
                for s in active)
            if horizon <= 0:
                self._decode_process(q.pop(0))
                return
        # k iterations write KV for positions len+off-1 .. len+off+k-2. If the
        # pool can't cover that horizon, flush and degrade to a single unified
        # step (decode rows only) rather than preempting.
        ok = all(self._ensure_pages(s, min(len(s.token_ids) + off + k - 1,
                                            self.cfg.max_model_len))
                 for s in active if s.slot >= 0)
        if not ok:
            self._flush_pending_decode()
            self._step_unified()
            return
        active = [s for s in active if s.slot >= 0]
        if not active:
            return
        if any(_constrained(s) for s in active) and self._plan_chain_masks(active) is None:
            # a preemption above took the batch out of the masked program's
            # reach: degrade like the pool-pressure path; a constrained row
            # never decodes unmasked
            self._flush_pending_decode()
            self._step_unified()
            return
        if q:
            same = ({(s.request_id, s.slot) for s in active}
                    == {(s.request_id, slot) for s, slot in q[-1]["rows"]})
            if same and self.cfg.pipeline_decode:
                q.append(self._decode_dispatch(active, k, chain=q[-1], wall_start=t0,
                                               off=off))
                # up to pipeline_depth calls in flight: the one queued behind
                # the running call keeps the device busy while the finished
                # call's tokens cross to the host
                if len(q) > max(1, self.cfg.pipeline_depth):
                    self._decode_process(q.pop(0))
                return
            self._flush_pending_decode()
            q = self._pending_decode
            active = [s for s in self._decode_ready() if s.slot >= 0]
            if not active:
                return
        rec = self._decode_dispatch(active, k, chain=None, wall_start=t0)
        if self.cfg.pipeline_decode:
            q.append(rec)
        else:
            self._decode_process(rec)

    def _flush_pending_decode(self) -> None:
        q, self._pending_decode = self._pending_decode, []
        for rec in q:
            self._decode_process(rec)
        if q:
            # one system event a chain teardown (the chain is batch-scoped,
            # and its lead row may have retired in this very drain: retired
            # stays the last event of every request's timeline)
            s, _slot = q[-1]["rows"][0]
            self.flight.record_system("chain_retire", calls=len(q), lead_request=s.request_id)

    def _pack_buf(self) -> dict[str, torch.Tensor]:
        """The host buffer set of the next dispatch (pinned on the card), one
        of ``pipeline_depth + 1`` sets taken in turn by dispatch count. A set
        is refilled only after the dispatch that uploaded from it has been
        processed: at most ``pipeline_depth`` calls are in flight when a call
        is packed, and processing a call waits for its event, recorded after
        its uploads, replay and readback on the engine's stream."""
        if not self._pack_bufs:
            B, maxp = self.cfg.max_batch_size, self.cfg.max_pages_per_seq
            pin = self.device.type == "cuda"
            self._pack_bufs = [
                {name: torch.empty((B, maxp) if name == "page_tables" else (B,),
                                   dtype=dt, pin_memory=pin)
                 for name, (dt, _) in PACKED.items()}
                for _ in range(max(1, self.cfg.pipeline_depth) + 1)]
        return self._pack_bufs[self.stats.n_decode_dispatches % len(self._pack_bufs)]

    def _result_slot(self) -> torch.Tensor:
        """The host buffer that the next dispatch's results are copied into
        (pinned on the card), one of ``pipeline_depth + 1`` taken in turn,
        reused only after the call that filled it was processed."""
        if not self._result_ring:
            k, B = max(1, self.cfg.decode_steps), self.cfg.max_batch_size
            n = k * B + (1 if self.model_cfg.is_moe else 0)
            if self._eplb is not None:
                n += self.model_cfg.num_layers * self.model_cfg.moe_num_experts
            self._result_ring = [
                torch.empty((n,), dtype=torch.int32, pin_memory=self.device.type == "cuda")
                for _ in range(max(1, self.cfg.pipeline_depth) + 1)]
        return self._result_ring[self.stats.n_decode_dispatches % len(self._result_ring)]

    def _decode_program(self, masked: bool = False) -> Callable[[], torch.Tensor]:
        """The decode program (``masked``: its masked variant) over the
        engine's static buffers, made at its first call: captured into a
        CUDA graph on the card unless ``decode_graph=False``, eager
        otherwise. The masked one reads the staged tables."""
        fn = self._decode_masked_fn if masked else self._decode_fn
        if fn is not None:
            return fn
        cfg = self.model_cfg
        if self._decode_bufs is None:
            self._decode_bufs = DecodeBuffers.allocate(
                self.cfg.max_batch_size, self.cfg.max_pages_per_seq, self.device)
        buf = self._decode_bufs
        k = max(1, self.cfg.decode_steps)
        tables = self._mask_buffers if masked else None

        def program():
            return run_chained(lambda: decode_program(
                cfg, self._run_params(), self.cache, buf, k, self._gen,
                attn_impl=self._attn["decode"],
                moe_dispatch_impl=self._moe_dispatch_impl, tables=tables,
                lora_scale=self._lora_scale), buf,
                drops=cfg.is_moe, counts=self._eplb is not None)

        fn = program
        if self._decode_graph:
            buf.idle()  # the warm-up runs write only the pool's dump row
            fn = CapturedProgram(program, self.device, self._gen)
            fn.capture()
            self.programs.record_capture("decode_masked" if masked else "decode")
            self.stats.decode_graph_captures += 1
            self.stats.decode_graph_capture_s += fn.seconds
        if masked:
            self._decode_masked_fn = fn
        else:
            self._decode_fn = fn
        return fn

    @profile_phase("llmd.decode_dispatch")
    def _decode_dispatch(self, active: list[Sequence], k: int, chain: Optional[dict],
                         wall_start: float, off: int = 0) -> dict:
        """Pack host state (plus the ``off`` tokens of the calls in flight) and
        launch one decode call chained on ``chain``; returns the in-flight
        record, whose results are not read here.

        Two pack regimes (reference ``_decode_dispatch``): a chain start (or
        ``pack_overlap`` off) packs every input from the host (a chained one
        keeps the device's tokens); a chained call with ``pack_overlap``
        keeps the device's tokens, positions and kv lengths and uploads only
        ``steps_left``, and the page tables when a row grew a page. A chain
        with constrained rows runs the masked program: its start stages the
        tables and uploads each slot's table row and entry state; a chained
        call keeps the device's states.

        Every ``_attn_probe_every``-th dispatch first runs the sampled phase
        probes (``_run_phase_probes``) on the engine's stream, ahead of this
        call's launch; ``_decode_process`` reads their times once this
        call's results are in."""
        if chain is not None:
            mask = chain["mask"]
        else:
            mask = (self._stage_chain_masks(active)
                    if any(_constrained(s) for s in active) else None)
            for s in active:
                self.flight.record(s.request_id, "chain_dispatch", k=k,
                                   masked=mask is not None)
        prog = "decode" if mask is None else "decode_masked"
        program = self._decode_program(masked=mask is not None)
        buf = self._decode_bufs
        host_t = self._pack_buf()
        host = {name: t.numpy() for name, t in host_t.items()}  # views of the same memory
        fast = chain is not None and self.cfg.pack_overlap
        steps = host["steps_left"]
        steps.fill(0)
        if fast:
            uploads = ["steps_left"]
            sig = chain["pages_sig"]
            for s in active:
                eff_len = len(s.token_ids) + off  # host view + in-flight tokens
                steps[s.slot] = max(0, min(s.max_tokens - (eff_len - s.prompt_len),
                                           self.cfg.max_model_len - eff_len, k))
            pages_sig = tuple(len(s.pages) for s in active)
            if pages_sig != sig:
                uploads.append("page_tables")
                host["page_tables"].fill(-1)
                for s in active:
                    host["page_tables"][s.slot, : len(s.pages)] = s.pages
        else:
            uploads = [n for n in PACKED if chain is None or n != "tokens"]
            for name in PACKED:
                if name != "steps_left":
                    host[name].fill(PACKED[name][1])
            for s in active:
                i = s.slot
                eff_len = len(s.token_ids) + off
                host["tokens"][i] = s.token_ids[-1]  # a chained call keeps the device's
                host["positions"][i] = eff_len - 1
                host["page_tables"][i, : len(s.pages)] = s.pages
                host["kv_lens"][i] = eff_len
                sp = s.sampling
                host["temperature"][i] = sp.temperature
                host["top_k"][i] = sp.top_k
                host["top_p"][i] = sp.top_p
                host["lora"][i] = self._lora_slot(s)
                steps[i] = max(0, min(s.max_tokens - (eff_len - s.prompt_len),
                                      self.cfg.max_model_len - eff_len, k))
            pages_sig = tuple(len(s.pages) for s in active)
        t1 = time.perf_counter()
        st = self.stats
        if fast:  # the device is still running the chain: this pack is hidden
            st.time_pack_overlap += t1 - wall_start
            self.metrics.step_duration.labels(phase="pack_overlap").observe(t1 - wall_start)
        else:
            st.time_host_pack += t1 - wall_start
            self.metrics.step_duration.labels(phase="pack").observe(t1 - wall_start)
        for name in uploads:
            getattr(buf, name).copy_(host_t[name], non_blocking=True)
        if chain is None and mask is not None:
            buf.table_rows.copy_(self._tensor(mask["table_rows"]), non_blocking=True)
            buf.fsm.copy_(self._tensor(mask["fsm0"]), non_blocking=True)
        probes = None
        if (st.n_decode_dispatches + 1) % self._attn_probe_every == 0:
            probes = self._run_phase_probes(active, k, off)
        readback = program()
        result, event = self._to_host(readback, self._result_slot())
        st.time_decode_steps += time.perf_counter() - wall_start
        st.n_decode_dispatches += 1
        st.n_decode_iterations += k
        if chain is not None:
            st.n_chained_dispatches += 1
        if self._decode_graph:
            st.decode_graph_replays += 1
        self.programs.record_dispatch(prog)
        self.metrics.step_duration.labels(phase="decode_dispatch").observe(
            time.perf_counter() - wall_start, exemplar=self._trace_exemplar(active))
        util_cost = None
        if self.util is not None:
            # the call computes k iterations over all B slots (idle and frozen
            # rows too), streaming the weights once an iteration; each live
            # row reads its resident KV every iteration
            util_cost = self.util.cost(
                prog, slot_tokens=self.cfg.max_batch_size * k, weight_passes=k,
                kv_read_tokens=k * sum(len(s.token_ids) + off for s in active),
                kv_write_tokens=int(steps.sum()))
        return {"rows": [(s, s.slot) for s in active], "k": k, "host": result,
                "event": event, "pages_sig": pages_sig, "util_cost": util_cost,
                "prog": prog, "mask": mask, "probes": probes}

    # ---------------------------------------------------- sampled phase probes
    # The reference's "attn" and MoE step-phase probes (engine.py:770-830,
    # 2725-2850): every _attn_probe_every decode dispatches, the decode
    # program's attention alone (K1, or K3 on MLA models) over the live pool,
    # layer 0's page tables and the live lengths with zero queries, and on
    # the sorted MoE dispatch its dispatch / experts (K2) / combine stages
    # against layer 0's live bank under uniform synthetic routing. Each time
    # x layers x k is observed into step_duration{phase=attn|moe_*}, directly
    # comparable with the decode_dispatch samples. The first run of a probe
    # is discarded; a failure turns that probe off and never stops serving.
    # On the card a probe runs eagerly on the engine's stream (never inside a
    # graph capture) between CUDA events, and its time is read when the
    # dispatch it preceded is processed: no device synchronisation is added
    # to the pipelined path. On the CPU it is timed by the host clock.
    def _init_phase_probes(self) -> None:
        cfg = self.model_cfg
        self._attn_probe_every = 64
        self._attn_probe_on = True
        self._attn_probe_warm = False
        self._attn_probe_scale = ((cfg.mla_qk_nope_dim + cfg.mla_rope_dim) ** -0.5
                                  if cfg.is_mla else cfg.head_dim ** -0.5)
        self._moe_probe_on = cfg.is_moe and self.moe_dispatch == "sorted"
        self._moe_probe_warm = False

    def _timed(self, fns: list) -> list:
        """Run ``fns`` in order, each after the previous one's output; the
        marks around them (CUDA events on the engine's stream, or host clock
        readings) and the last output."""
        cuda = self.device.type == "cuda"

        def mark():
            if not cuda:
                return time.perf_counter()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self._stream)
            return ev

        marks, out = [mark()], None
        for fn in fns:
            out = fn(out)
            marks.append(mark())
        return marks

    def _run_phase_probes(self, active: list[Sequence], k: int, off: int) -> Optional[list]:
        """Launch the probes at this dispatch's decode shape; returns
        [(phase, start mark, end mark, scale)] for ``_observe_probes``."""
        if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return None
        scale = self.model_cfg.num_layers * k
        out: list = []
        if self._attn_probe_on:
            try:
                fn = self._attn_probe_fn(active, off)
                if not self._attn_probe_warm:
                    fn(None)
                    self._attn_probe_warm = True
                t0, t1 = self._timed([fn])
                out.append(("attn", t0, t1, scale))
            except Exception:  # noqa: BLE001 — observability never takes down serving
                self._attn_probe_on = False
        if self._moe_probe_on:
            try:
                stages = self._moe_probe_fns()
                if not self._moe_probe_warm:
                    self._timed(stages)
                    self._moe_probe_warm = True
                marks = self._timed(stages)
                out += [(phase, a, b, scale) for phase, a, b in zip(
                    ("moe_dispatch", "moe_experts", "moe_combine"), marks, marks[1:])]
            except Exception:  # noqa: BLE001
                self._moe_probe_on = False
        return out

    def _attn_probe_fn(self, active: list[Sequence], off: int) -> Callable:
        """The decode program's attention at the dispatch's shape: zero
        queries, the live pool, layer 0's page tables (idle rows unmapped at
        kv length 1, as the program packs them) and the live lengths."""
        B, cfg, dev = self.cfg.max_batch_size, self.model_cfg, self.device
        pts = np.full((B, self.cfg.max_pages_per_seq), -1, np.int32)
        lens = np.ones((B,), np.int32)
        for s in active:
            pts[s.slot, : len(s.pages)] = s.pages
            lens[s.slot] = len(s.token_ids) + off
        pts_t, lens_t = self._tensor(pts), self._tensor(lens)
        q = torch.zeros((B, cfg.num_heads, self.cache.shape[-1]), dtype=cfg.torch_dtype,
                        device=dev)
        rows = torch.arange(B + 1, dtype=torch.int32, device=dev)
        num_seqs = self._tensor(np.array([B], np.int32))
        return lambda _: self._attn["decode"](
            q, self.cache, pts_t, lens_t - 1, rows[:B], lens_t,
            scale=self._attn_probe_scale, cu_q_lens=rows, num_seqs=num_seqs)

    def _moe_probe_fns(self) -> list:
        """The sorted dispatch's three stages at the decode batch against
        layer 0's live bank (the EPLB slot bank when EPLB runs; an int8 bank
        runs the scaled plain experts, as served), uniform routing."""
        p, cfg, dev = self._run_params(), self.model_cfg, self.device
        B, kk, dt = self.cfg.max_batch_size, cfg.moe_top_k, cfg.torch_dtype
        q8 = "moe_wi_q" in p
        wi, wo = (p["moe_wi_q"][0], p["moe_wo_q"][0]) if q8 else (p["moe_wi"][0], p["moe_wo"][0])
        S = wi.shape[0]
        x = torch.zeros((B, cfg.hidden_size), dtype=dt, device=dev)
        idx = (torch.arange(B * kk, dtype=torch.int32, device=dev) % S).reshape(B, kk)
        topw = torch.full((B, kk), 1.0 / kk, dtype=dt, device=dev)
        valid = torch.ones((B, 1), dtype=torch.int32, device=dev)
        bc = pick_block_size(B * kk, S, pallas=x.is_cuda and not q8)
        staged: list = []

        def dispatch(_):
            staged[:] = [dispatch_stage(x, idx, topw, valid, S, bc)]
            return staged[0]

        def experts(st):
            if q8:
                return experts_scaled(st[0], st[4], wi, wo, p["moe_wi_scale"][0],
                                      p["moe_wo_scale"][0])
            return experts_stage(st[0], st[4], st[5], wi, wo)

        def combine(ye):
            st = staged[0]
            return combine_stage(ye, st[1], st[2], st[3], B)

        return [dispatch, experts, combine]

    def _observe_probes(self, probes: Optional[list]) -> None:
        """Observe a dispatch's probe times once its results are in (on the
        card its events have completed by then)."""
        for phase, a, b, scale in probes or ():
            try:
                dt = (b - a) if isinstance(a, float) else a.elapsed_time(b) / 1e3
            except Exception:  # noqa: BLE001 — a bad reading turns the probe off
                if phase == "attn":
                    self._attn_probe_on = False
                else:
                    self._moe_probe_on = False
                continue
            self.metrics.step_duration.labels(phase=phase).observe(dt * scale)

    @profile_phase("llmd.decode_process")
    def _decode_process(self, rec: dict) -> None:
        """Wait for one in-flight decode call's results and apply them."""
        t1 = time.perf_counter()
        t1_ns = time.time_ns()
        if rec["event"] is not None:
            rec["event"].synchronize()
        self._observe_probes(rec["probes"])
        k, B = rec["k"], self.cfg.max_batch_size
        host = rec["host"].numpy().copy()
        t2 = time.perf_counter()
        now = time.monotonic()
        toks_out = host[: k * B].reshape(k, B)
        if self.model_cfg.is_moe:
            self._record_moe(host[k * B:], (self.model_cfg.num_layers,
                                            self.model_cfg.moe_num_experts))
        n_tokens = 0
        for s, slot in rec["rows"]:
            if s.finished or s.slot != slot or self.running[slot] is not s:
                continue  # aborted / preempted / replaced while in flight
            kept: list[int] = []
            finished, reason = False, None
            for t in toks_out[:, slot].tolist():
                kept.append(t)
                s.token_ids.append(t)
                finished, reason = self._check_finish(s, t)
                if finished:
                    break  # tokens past a stop are dropped
            # the newest token's KV is not written yet → computed = len - 1
            s.num_computed = len(s.token_ids) - 1
            if s.structured is not None:
                # the host automaton follows the landed tokens (the masked
                # program keeps them inside the grammar: no violation)
                self._count_violations(s.structured.sync(s.token_ids, s.prompt_len))
            self._first_token(s, now)
            s.maybe_commit_blocks(self.alloc)
            self.stats.total_decode_tokens += len(kept)
            self.stats.decode_tokens_fused += len(kept)
            if kept:
                if not s.spec_armed:
                    s.spec_flips += 1
                s.spec_armed = True  # fresh tokens landed: re-probe this row
            n_tokens += len(kept)
            # one progress event a decode call
            self.flight.record(s.request_id, "decode", n_tokens=len(kept),
                               generated=s.num_generated)
            if finished:
                self._retire(s, reason)
            self._outputs.append(EngineOutput(
                request_id=s.request_id, new_token_ids=kept, finished=finished,
                finish_reason=reason, num_cached_prompt_tokens=s.num_cached_prompt,
                prompt_len=s.prompt_len))
        t3 = time.perf_counter()
        st = self.stats
        st.time_device += t2 - t1
        st.time_device_decode += t2 - t1
        st.time_postprocess += t3 - t2
        st.time_decode_steps += t3 - t1
        st.n_decode_calls += 1
        self.programs.record_complete(rec["prog"])
        if n_tokens:
            self.metrics.decode_tokens.inc(n_tokens)
        self.metrics.step_duration.labels(phase="decode_process").observe(
            t3 - t1, exemplar=self._trace_exemplar([s for s, _ in rec["rows"]]))
        if rec["util_cost"] is not None:
            # kept tokens commit; the rest of the B x k slot-steps (idle
            # slots, steps past a stop or a budget, rows gone in flight) pad
            self.util.record(rec["prog"], rec["util_cost"], t3 - t1, committed=n_tokens,
                             compile_counts=self.compile_counts())
        self._emit_step_spans("decode", [s for s, _ in rec["rows"]], t1_ns,
                              len(rec["rows"]), n_tokens)

    def _retire(self, seq: Sequence, reason: Optional[str]) -> None:
        """Free slot + pages, drop from the live map."""
        seq.finished = True
        seq.finish_reason = reason
        if seq.structured is not None:
            # a constrained generation that ends before its grammar accepts
            # (max_tokens / max_model_len) does not parse: a violation
            fresh = seq.structured.sync(seq.token_ids, seq.prompt_len)
            self._count_violations(fresh + (0 if seq.structured.complete else 1))
        if seq.spec_drafted > 0:
            self.metrics.spec_acceptance.labels(
                constrained="yes" if _constrained(seq) else "no").observe(
                seq.spec_accepted / seq.spec_drafted)
        # the decision ledger's attributes ride the terminal event (None
        # values are dropped by the recorder: untouched levers add nothing)
        decision_attrs = {}
        if self._decisions_on:
            decision_attrs = dict(
                spec_drafted=seq.spec_drafted or None,
                spec_accepted=seq.spec_accepted if seq.spec_drafted else None,
                spec_flips=seq.spec_flips or None,
                cached_tokens=seq.num_cached_prompt or None)
        self.flight.finish(
            seq.request_id, event="retired", reason=reason or "",
            generated=seq.num_generated,
            ttft_ms=round((seq.first_token_time - seq.arrival_time) * 1e3, 3)
            if seq.first_token_time is not None else None,
            **decision_attrs)
        if seq.slot >= 0:
            self.running[seq.slot] = None
            seq.slot = -1
            if self.lora_registry is not None:
                self.lora_registry.on_finished(seq.lora_id)
        if self.kv_connector is not None and seq.block_hashes:
            self._connector_save(seq)
        self._free_seq(seq)
        self.seqs.pop(seq.request_id, None)

    def _connector_save(self, seq: Sequence) -> None:
        """The connector's save path: stage the committed blocks here (cheap,
        the P/D export's helper), drain them and hand them to the external
        engine on the connector thread, off the step loop. A failure never
        fails serving."""
        n, ps = len(seq.block_hashes), self.cfg.page_size
        with self._on_stream():
            parts = stage_pages(self.cache, seq.pages[:n], self.cfg.num_pages,
                                self.cfg.offload_staging_blocks)
        hashes = list(seq.block_hashes)
        chunks = [seq.token_ids[i * ps : (i + 1) * ps] for i in range(n)]
        rid, conn = seq.request_id, self.kv_connector

        def _drain() -> None:
            try:
                conn.save_blocks(hashes, chunks, drain_staged(parts))
            except Exception:  # noqa: BLE001 — the external engine is down: serving goes on
                pass
            try:
                conn.request_finished(rid)
            except Exception:  # noqa: BLE001
                pass

        self._connector_pool.submit(_drain)

    def _check_finish(self, seq: Sequence, tok: int) -> tuple[bool, Optional[str]]:
        sp: SamplingParams = seq.sampling
        if not sp.ignore_eos and tok in (sp.stop_token_ids or ()):
            return True, "stop"
        if seq.num_generated >= seq.max_tokens:
            return True, "length"
        if len(seq.token_ids) >= self.cfg.max_model_len:
            return True, "length"
        return False, None

    # ------------------------------------------------------------ embeddings
    def embed(self, token_ids: list[int], lora_id: Optional[str] = None) -> list[float]:
        """The mean-pooled, L2-normalised final hidden state of ``token_ids``
        (``/v1/embeddings``; reference ``embed``), under adapter ``lora_id``.

        Truncates to ``max_model_len - 1`` tokens and runs the embed program
        over chunks of ``prefill_chunk`` on pages borrowed from the allocator
        for the call (released in ``finally``); the chunks' sums accumulate
        on the host in float64. Eager, on the engine's stream, so a decode
        call still in flight is ordered before it. The caller serialises
        against the step loop (the server's ``run_locked``). The reference's
        ``rank`` argument picks a DP rank's pool; this engine has one."""
        if not token_ids:
            raise ValueError("empty input")
        bad = [t for t in token_ids if not 0 <= t < self.model_cfg.vocab_size]
        if bad:  # an embedding lookup past the table would fault the card
            raise ValueError(f"token ids out of vocab range: {bad[:4]}")
        token_ids = token_ids[: self.cfg.max_model_len - 1]
        chunk, ps = self.cfg.prefill_chunk, self.cfg.page_size
        slot = self.lora_registry.slot_of(lora_id) if self.lora_registry is not None else 0
        acc = np.zeros((self.model_cfg.hidden_size,), np.float64)
        pages: list[int] = []
        with torch.no_grad(), self._on_stream():
            try:
                for _ in range((len(token_ids) + ps - 1) // ps):
                    pid = self.alloc.allocate()  # may evict: its copy-out on this stream
                    if pid is None:
                        raise RuntimeError("no free KV pages for embedding request")
                    pages.append(pid)
                pt = np.full((1, self.cfg.max_pages_per_seq), -1, np.int32)
                pt[0, : len(pages)] = pages
                lora = np.full((chunk,), slot, np.int32)
                for start in range(0, len(token_ids), chunk):
                    n = min(chunk, len(token_ids) - start)
                    toks = np.zeros((chunk,), np.int32)
                    toks[:n] = token_ids[start : start + n]
                    pos = np.full((chunk,), -1, np.int32)
                    pos[:n] = np.arange(start, start + n)
                    h_sum = self._embed_program(toks, pos, pt, start + n, n, lora)
                    acc += h_sum.cpu().numpy().astype(np.float64)
            finally:
                for pid in pages:
                    self.alloc.release(pid)
        vec = acc / max(1, len(token_ids))
        norm = float(np.linalg.norm(vec))
        return (vec / norm if norm > 0 else vec).astype(float).tolist()

    def _embed_program(self, toks: np.ndarray, pos: np.ndarray, pt: np.ndarray,
                       kv_len: int, n: int, lora: np.ndarray) -> torch.Tensor:
        """The embed program (reference ``_embed``): one chunk of one
        sequence, padding rows at position -1, through ``forward_core``
        (K1 for its attention); the float32 sum [D] of the valid rows' final
        hidden states, on the device."""
        positions = self._tensor(pos)
        hidden, self.cache, _, _ = self._forward(
            "unified", self._tensor(toks), positions,
            torch.zeros((toks.shape[0],), dtype=torch.int32, device=self.device),
            self._tensor(pt), self._tensor(np.array([kv_len], np.int32)),
            cu_q_lens=self._tensor(np.array([0, n], np.int32)),
            num_seqs=self._tensor(np.array([1], np.int32)), moe_rows=None,
            lora_indices=self._tensor(lora) if self.lora_registry is not None else None)
        valid = (positions >= 0).to(torch.float32)[:, None]
        return (hidden.float() * valid).sum(dim=0)

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
        # every launched decode call was processed: a gap would mean an
        # in-flight record was dropped with its tokens
        assert (self.stats.n_decode_dispatches == self.stats.n_decode_calls
                and not self._pending_decode), (
            f"decode pipeline leak: dispatched {self.stats.n_decode_dispatches}, "
            f"processed {self.stats.n_decode_calls}, pending {len(self._pending_decode)}")
        # every program's dispatches were read back, the masked ones included
        assert self.programs.quiesced(), (
            f"program ledger leak at quiesce: {self.programs.counters()}")
        return done
