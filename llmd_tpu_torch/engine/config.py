"""Engine configuration (copy of ``llmd_tpu/engine/config.py``, same field names).

Every field of the reference exists so configs carry over unchanged, but this
slice of the port reads only the fields in :data:`SERVED`.
:meth:`EngineConfig.check_served` (called at engine construction) raises for
any other field set away from its default, so no option is silently ignored.
The reference's pipelined dispatch (``pipeline_decode``, ``pipeline_depth``,
``pack_overlap``, ``pipeline_prefill_sample``) is served, with the
reference's defaults (on, depth 2) and every value it takes, and so are
``instrument`` (wait for the unified program's outputs before stamping its
device time) and ``quantize_weights`` (``None`` or ``"int8"``). Speculative
decoding (``spec_mode`` ``off`` | ``ngram``, ``spec_tokens``,
``spec_ngram_max`` / ``_min``) and structured outputs (``structured_mode``
``auto`` | ``off``, ``structured_fused_decode``,
``structured_table_max_elems``, ``spec_structured``,
``spec_structured_crosscheck``) are served with the reference's validation,
and so is ``kv_cache_dtype`` (``None``: the model's dtype; ``"fp8"``: a
``float8_e4m3fn`` pool). The KV data plane's fields are served too: the
offload tiers (``cpu_offload_pages``, ``offload_staging_blocks``,
``offload_watermark_pages``, ``offload_fs_path``), the external connector
(``kv_connector``, ``kv_connector_params``) and ``role`` (``both`` |
``prefill`` | ``decode``; a tag the engine never reads, as in the
reference, where only the pool reads it). So is ``lora``: ``None`` or a
``models/lora.LoRAConfig``, multi-adapter LoRA serving on GQA models.
The kernel-selection modes are served with the reference's values:
``attn_impl`` ``auto`` | ``pallas`` | ``reference`` and ``moe_matmul``
``auto`` | ``pallas`` | ``einsum`` (``pallas`` names the port's CUDA
kernels), and so is ``attn_tune_file`` (K1's launch-config table,
``ops/attn_tune``). ``dp_ranks`` serves DP rank frontends over one engine,
and ``max_queue`` is taken and read nowhere, as in the reference. ``mesh``
(``parallel/mesh.MeshConfig``, re-exported here) and ``sp_ring_attention``
are served with the reference's defaults: a mesh of N > 1 devices runs N
rank processes (``parallel/launch.py``).
"""

from __future__ import annotations

from dataclasses import MISSING, dataclass, field, fields
from typing import Optional

from llmd_tpu_torch.models.lora import LoRAConfig
from llmd_tpu_torch.parallel.eplb import EPLBConfig
from llmd_tpu_torch.parallel.mesh import MeshConfig


@dataclass
class EngineConfig:
    # Paged KV cache (page_size is the reference's --block-size contract).
    page_size: int = 16
    num_pages: int = 512
    max_model_len: int = 2048
    # Continuous batching
    max_batch_size: int = 8  # decode slots
    prefill_chunk: int = 128  # per-sequence chunked-prefill cap per step
    # Flat token budget of the unified step (--max-num-batched-tokens); None =
    # max(prefill_chunk, max_batch_size).
    max_num_batched_tokens: "int | None" = None
    enable_prefix_caching: bool = True
    # Parallelism: the (dp, sp, ep, tp) mesh, one rank process a device
    # (parallel/launch.py). DP rank frontends over this engine: each rank
    # owns a queue, a slot range, a page partition and a token budget;
    # max_batch_size and num_pages must divide by dp_ranks, and the offload
    # tiers are single-rank.
    mesh: MeshConfig = field(default_factory=MeshConfig)
    dp_ranks: int = 1
    # Scheduling (read nowhere, as in the reference)
    max_queue: int = 1024
    # Multi-step decode: N decode iterations per host round trip.
    decode_steps: int = 1
    # Pipelined decode dispatch: launch call N+1 chained on call N's
    # device-resident outputs and read N's tokens while N+1 runs, with up to
    # pipeline_depth calls in flight (costs up to depth*decode_steps
    # speculative tokens per sequence at a stop token).
    pipeline_decode: bool = True
    pipeline_depth: int = 2
    # Defer reading a pure-prefill step's sampled first tokens to the next
    # step (steps with decode rows apply theirs at once).
    pipeline_prefill_sample: bool = True
    # KV offload tiers (kv/offload.py): CPU blocks, the reload width, the free
    # pages the proactive drain keeps, the shared FS tier's directory; and
    # the out-of-tree connector (kv/connector_api.py) by registered name
    cpu_offload_pages: int = 0
    offload_staging_blocks: int = 16
    offload_watermark_pages: int = 8
    offload_fs_path: "str | None" = None
    kv_connector: "str | None" = None
    kv_connector_params: "dict | None" = None
    # P/D role: both | prefill | decode (read by the pool, not the engine)
    role: str = "both"
    # Attention: "auto" = the CUDA kernels on a card (BuildError if they do
    # not build), their plain versions for CPU tensors; "pallas" = the CUDA
    # kernels, refused on the CPU; "reference" = the plain versions everywhere.
    attn_impl: str = "auto"
    # K1's launch-config table (ops/attn_tune JSON, written by the bench's
    # tuner); None: LLMD_ATTN_TUNE_FILE, else the launch-plan policy.
    attn_tune_file: "str | None" = None
    sp_ring_attention: bool = True
    # Wait for each unified step's outputs before stamping its device time
    # (EngineStats.time_device); off in serving.
    instrument: bool = False
    # MoE expert GEMMs: "auto" = the CUDA kernels (K2 / K4) on a card, their
    # plain versions for CPU tensors; "pallas" = the CUDA kernels, refused on
    # the CPU and with int8 weights; "einsum" = the plain products everywhere.
    moe_matmul: str = "auto"
    # MoE token dispatch: auto (= sorted) | sorted (drop-free, K2) | einsum
    # (capacity einsum, K4).
    moe_dispatch: str = "auto"
    # Weight-only quantization: None | "int8" (per-output-channel, at
    # construction; models/quant.py).
    quantize_weights: "str | None" = None
    # KV pool dtype: None = the model's; "fp8" stores pages as float8_e4m3fn
    # (writes clamp to +-448 first), halving decode's KV read stream; the
    # attention kernels read the fp8 pages themselves.
    kv_cache_dtype: "str | None" = None
    kv_layout: str = "auto"
    eplb: Optional[EPLBConfig] = None
    lora: "object | None" = None
    # Speculative decoding (engine/spec.py): "off" = plain decode, "ngram" =
    # prompt-lookup drafts verified through the verify program; greedy
    # acceptance keeps output identical to "off", and sampled rows
    # (temperature > 0) fall back to plain decode.
    spec_mode: str = "off"
    # Max draft tokens proposed (and verified) per sequence per verify step.
    spec_tokens: int = 4
    # Suffix n-gram match lengths tried by the drafter, longest first.
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    # Structured outputs: "auto" = compile grammars for requests that ask,
    # "off" = refuse structured requests at admission (ValueError -> 400).
    structured_mode: str = "auto"
    # A chained decode call keeps the device's tokens, positions and kv
    # lengths and uploads only steps_left (and page tables that grew).
    pack_overlap: bool = True
    # Constrained rows ride the masked decode program (bias gather, biased
    # sample and FSM step on the device) instead of degrading the batch to
    # one-token unified steps. A row with a grammar AND a logit_bias, or
    # tables past structured_table_max_elems (G_pad * S_pad * V elements),
    # still degrades.
    structured_fused_decode: bool = True
    structured_table_max_elems: int = 1 << 23
    # Constrained rows draft through the host automaton and verify through
    # the masked verify program; False: constrained rows never draft.
    spec_structured: bool = True
    # After every masked verify step, re-derive each constrained row's FSM
    # state on the host and count disagreements with the device's.
    spec_structured_crosscheck: bool = False

    @property
    def max_pages_per_seq(self) -> int:
        return (self.max_model_len + self.page_size - 1) // self.page_size

    @property
    def batched_tokens(self) -> int:
        if self.max_num_batched_tokens is not None:
            return max(self.max_num_batched_tokens, self.max_batch_size)
        return max(self.prefill_chunk, self.max_batch_size)

    def check_served(self) -> None:
        """Raise ValueError for a field this slice does not read that is set
        away from its default, or for a value of a read field the port does
        not take."""
        bad = []
        for f in fields(self):
            if f.name in SERVED:
                continue
            default = f.default_factory() if f.default is MISSING else f.default
            if getattr(self, f.name) != default:
                bad.append(f.name)
        if bad:
            raise ValueError(f"EngineConfig options {bad} are not served by the "
                             "port yet (see ROADMAP.md Queue A)")
        if self.kv_cache_dtype not in (None, "fp8"):
            raise ValueError(f"unknown kv_cache_dtype={self.kv_cache_dtype!r}"
                             " (supported: 'fp8')")
        if self.quantize_weights not in (None, "int8"):
            raise ValueError(f"unknown quantize_weights={self.quantize_weights!r} "
                             "(supported: 'int8')")
        if self.attn_impl not in ("auto", "pallas", "reference"):
            raise ValueError(f"attn_impl must be auto|pallas|reference, got "
                             f"{self.attn_impl!r}")
        if self.moe_matmul not in ("auto", "pallas", "einsum"):
            raise ValueError(f"moe_matmul must be auto|pallas|einsum, got "
                             f"{self.moe_matmul!r}")
        if self.dp_ranks < 1:
            raise ValueError(f"dp_ranks must be >= 1, got {self.dp_ranks}")
        if self.moe_dispatch not in ("auto", "sorted", "einsum"):
            raise ValueError(f"moe_dispatch must be auto|sorted|einsum, got "
                             f"{self.moe_dispatch!r}")
        if self.spec_mode not in ("off", "ngram"):
            raise ValueError(f"unknown spec_mode={self.spec_mode!r} "
                             "(supported: 'off', 'ngram')")
        if self.structured_mode not in ("auto", "off"):
            raise ValueError(f"unknown structured_mode={self.structured_mode!r} "
                             "(supported: 'auto', 'off')")
        if self.role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be both|prefill|decode, got {self.role!r}")
        if self.lora is not None and not isinstance(self.lora, LoRAConfig):
            raise ValueError("lora takes llmd_tpu_torch.models.lora.LoRAConfig, "
                             f"got {type(self.lora).__name__}")
        if not isinstance(self.mesh, MeshConfig):
            raise ValueError("mesh takes llmd_tpu_torch.parallel.mesh.MeshConfig, "
                             f"got {type(self.mesh).__name__}")
        if min(self.mesh.dp, self.mesh.ep, self.mesh.tp, self.mesh.sp) < 1:
            raise ValueError(f"mesh axis sizes must be >= 1, got {self.mesh}")
        if self.eplb is not None and not isinstance(self.eplb, EPLBConfig):
            raise ValueError("eplb takes llmd_tpu_torch.parallel.eplb.EPLBConfig, "
                             f"got {type(self.eplb).__name__}")


# The fields this slice of the port reads; every other one must keep its default.
SERVED = frozenset({
    "page_size", "num_pages", "max_model_len", "max_batch_size", "prefill_chunk",
    "max_num_batched_tokens", "enable_prefix_caching", "decode_steps", "attn_impl",
    "moe_matmul", "moe_dispatch", "eplb", "pipeline_decode", "pipeline_depth",
    "pack_overlap", "pipeline_prefill_sample", "instrument", "quantize_weights",
    "kv_cache_dtype",
    "spec_mode", "spec_tokens", "spec_ngram_max", "spec_ngram_min", "structured_mode",
    "structured_fused_decode", "structured_table_max_elems", "spec_structured",
    "spec_structured_crosscheck",
    "cpu_offload_pages", "offload_staging_blocks", "offload_watermark_pages",
    "offload_fs_path", "kv_connector", "kv_connector_params", "role", "lora",
    "attn_tune_file", "dp_ranks", "max_queue", "mesh", "sp_ring_attention",
})
