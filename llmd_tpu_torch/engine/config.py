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
``float8_e4m3fn`` pool).
"""

from __future__ import annotations

from dataclasses import MISSING, dataclass, field, fields
from typing import Optional

from llmd_tpu_torch.parallel.eplb import EPLBConfig


@dataclass
class MeshConfig:
    """Mesh axis sizes (copy of ``llmd_tpu/parallel/mesh.py::MeshConfig``)."""

    dp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.ep * self.tp * self.sp


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
    # Parallelism (one device in this slice)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    dp_ranks: int = 1
    # Scheduling
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
    # KV offload tiers / connectors (later slices)
    cpu_offload_pages: int = 0
    offload_staging_blocks: int = 16
    offload_watermark_pages: int = 8
    offload_fs_path: "str | None" = None
    kv_connector: "str | None" = None
    kv_connector_params: "dict | None" = None
    # P/D role
    role: str = "both"
    # Attention: "auto" = the CUDA kernel on a card, its plain version for CPU
    # tensors (the only value the port takes).
    attn_impl: str = "auto"
    attn_tune_file: "str | None" = None
    sp_ring_attention: bool = True
    # Wait for each unified step's outputs before stamping its device time
    # (EngineStats.time_device); off in serving.
    instrument: bool = False
    # MoE expert GEMMs: "auto" = the CUDA kernels on a card, their plain
    # versions for CPU tensors (the only value the port takes).
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
        if self.quantize_weights == "int8" and self.moe_matmul not in ("auto", "einsum"):
            raise ValueError(f"moe_matmul={self.moe_matmul!r} (the grouped GEMM kernels, "
                             "bf16/f32 only) is incompatible with quantize_weights='int8'")
        if self.attn_impl != "auto":
            raise ValueError(f"attn_impl={self.attn_impl!r}: the port has one "
                             "attention path, 'auto' (the kernel on a card)")
        if self.moe_matmul != "auto":
            raise ValueError(f"moe_matmul={self.moe_matmul!r}: the port has one "
                             "expert-GEMM path, 'auto' (the kernels on a card)")
        if self.moe_dispatch not in ("auto", "sorted", "einsum"):
            raise ValueError(f"moe_dispatch must be auto|sorted|einsum, got "
                             f"{self.moe_dispatch!r}")
        if self.spec_mode not in ("off", "ngram"):
            raise ValueError(f"unknown spec_mode={self.spec_mode!r} "
                             "(supported: 'off', 'ngram')")
        if self.structured_mode not in ("auto", "off"):
            raise ValueError(f"unknown structured_mode={self.structured_mode!r} "
                             "(supported: 'auto', 'off')")
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
})
