"""llmd-lint configuration: discovery globs, the hot-path set, the sync and
blocking-call catalogues, the contract sources and the central allowlist,
as one :class:`LintConfig`. ``PORT`` is the configuration of
``llmd_tpu_torch/``, the default of every :class:`~.core.Project`.

Adding a hot-path file
----------------------
``hot_paths`` maps a repo-relative glob to the functions checked in it:
``"*"`` means every function/method in the file is on the hot path (kernels);
a list restricts checking to the named functions plus any name carrying one
of the listed prefixes (``"_spec_"`` covers ``_spec_propose`` etc.). A list
may also start with ``"*"`` and name exclusions as ``"!name"``: every
function but those. New per-step or per-request code paths belong here the
moment they exist.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .core import AllowEntry


@dataclass(frozen=True)
class LintConfig:
    # code analyzers' discovery set
    globs: tuple
    hot_paths: dict
    # "jax": the reference's dataflow (device = a jnp/jax call or a compiled
    # program handle); "torch": the port's (hotpath.py, _TorchFnChecker)
    dialect: str
    sync_call_attrs: frozenset
    sync_call_names: frozenset
    # program construction inside a hot function (hot-jit-call) or a loop
    # there (hot-jit-in-loop): dotted names, and attribute calls on anything
    jit_call_names: frozenset
    jit_call_attrs: frozenset
    blocking_call_names: frozenset
    blocking_call_attrs: frozenset
    blocking_bare_names: frozenset
    # Event.wait / Thread.join / Condition.wait_for with no timeout, on a
    # receiver that is not one of the class's own locks, block
    blocking_untimed_waits: bool
    allowlist: tuple
    # where central (line-less) allow findings point
    config_file: str
    # env contract: the sources whose reads count, and the package a contract
    # row's Consumer module (``llmd_tpu.x.y``) names in this tree
    env_source_globs: tuple
    consumer_package: str
    # metrics / events contracts: the modules holding the registry and the
    # catalog, and the package scanned for raw lines and emit sites
    registry_module: str
    events_module: str
    package_dir: str
    # program handles whose call returns device values (torch dialect)
    program_calls: frozenset = field(default_factory=frozenset)


# ------------------------------------------------------------------ hot path
# The serving path: one stray host sync or per-call program build here costs
# more than any kernel win. The reference's set (its engine's step / dispatch
# / verify / sample functions, spec.py, the program registry's ledger and
# every op kernel) maps one for one onto the port's files under the same
# names. The port adds the code that runs per step in the port and did not in
# the reference: there, everything under jax.jit was traced once and ran as
# one compiled program, so only the Python around the programs was hot; the
# port's unified and verify programs run eagerly (engine/verify_program.py),
# so every Python line of the forward runs on every step.
HOT_PATHS: dict[str, object] = {
    # kernels' wrappers, the MoE dispatch and the ring (the reference's
    # ops/*.py, "*"), less the helpers that run once or only in checks:
    # bf16_rounding_units is a deliberate .item() for tests and the smoke
    # run; _library / build load the native library once per process
    # (functools.cache); the launch-config table is read and written by the
    # tuner, the ring's reference attention is a test oracle
    "llmd_tpu_torch/ops/paged_attention.py": ["*", "!bf16_rounding_units",
                                              "!_library", "!build"],
    "llmd_tpu_torch/ops/mla_decode.py": ["*", "!_library", "!build"],
    "llmd_tpu_torch/ops/grouped_gemm.py": ["*", "!_library", "!build",
                                           "!make_moe_matmul"],
    "llmd_tpu_torch/ops/moe_dispatch.py": "*",
    "llmd_tpu_torch/ops/ring_attention.py": ["*", "!reference_causal_attention"],
    "llmd_tpu_torch/engine/engine.py": [
        "step",
        "has_work",
        "_step_",          # _step_unified/_step_decode/_step_spec_verify
        "_decode_dispatch",
        "_decode_process",
        "_decode_ready",
        "_flush_pending_",  # _flush_pending_decode/_flush_pending_sample
        "_sample_dispatch",
        "_sample_apply",
        "_plan_chain_masks",
        "_stage_chain_masks",
        "_mask_tables",
        "_constrained_needs_unified",
        "_unified_eligible",
        "_run_",           # _run_unified/_run_verify/_run_decode_program
        "_verify_nt",
        "_pack_buf",
        "_spec_",          # propose/try_verify/release_tail
        "_build_bias",
        "_check_finish",
        "_prefilling_seqs",
        "_prefill_target",
        "_observe_probes",  # the reference's _observe_attn_phase
        "_emit_step_spans",
        "_trace_exemplar",
    ],
    "llmd_tpu_torch/engine/spec.py": "*",
    # step-program registry: the dispatch/complete ledger and routing run
    # once per engine step. select_decode_attn_impl is startup-only and
    # stays unchecked.
    "llmd_tpu_torch/engine/programs.py": [
        "record_dispatch",
        "record_complete",
        "route",
        "quiesced",
    ],
    # port only: the decode programs' bodies (run eagerly off the card and
    # during a capture) and the per-step chain around them; the eager verify
    # and masked-verify programs, which the reference ran under jax.jit
    "llmd_tpu_torch/engine/decode_program.py": ["decode_program", "run_chained"],
    "llmd_tpu_torch/engine/verify_program.py": "*",
    # port only: a graph's replay runs once per decode call; its capture is
    # startup work (and a deliberate synchronize) and stays unchecked
    "llmd_tpu_torch/engine/cuda_graph.py": ["__call__"],
    # port only: the forward and what it runs per layer, eager in the port
    # (traced once under jax.jit in the reference); the loaders, the
    # parameter set-up and the pool's allocation run at startup. The int8
    # per-call product is transformer.linear: models/quant.py holds only the
    # quantize / dequantize set-up and has no per-call code.
    "llmd_tpu_torch/models/transformer.py": [
        "forward_core", "forward", "rms_norm", "rope_tables", "apply_rope",
        "rope", "swiglu", "linear", "swiglu_layer", "moe_block", "_pool_rows",
        "_store_rows", "_write_rows", "write_kv", "embed_lookup", "unembed",
    ],
    # port only: the adapter delta in every LoRA product of the forward
    "llmd_tpu_torch/models/lora.py": ["apply_lora", "slot_mask"],
    # port only: a rank's per-step command (the engine's ops and their row
    # plans) in a world of rank processes
    "llmd_tpu_torch/parallel/worker.py": ["run"],
    "llmd_tpu_torch/parallel/rows.py": "*",
}

# Direct device->host synchronization spellings (torch dialect: the
# receivers and arguments are classified by hotpath.py's dataflow, so a
# numpy array's .tolist() or np.array over a host list is not a finding).
SYNC_CALL_ATTRS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
SYNC_CALL_NAMES = frozenset({
    "np.asarray", "np.array", "np.ascontiguousarray", "numpy.asarray",
    "numpy.array", "torch.cuda.synchronize",
})
# program builds: compile, graph capture, native build
JIT_CALL_NAMES = frozenset({
    "torch.compile", "torch.cuda.graph", "torch.cuda.CUDAGraph",
    "torch.jit.script", "torch.jit.trace", "torch.utils.cpp_extension.load",
    "torch.utils.cpp_extension.load_inline", "cpp_extension.load",
    "cpp_extension.load_inline", "llmd_tpu_torch.native.build.load",
    "llmd_tpu_torch.native.build.load_host", "build.load", "build.load_host",
})
JIT_CALL_ATTRS = frozenset({"capture_begin"})

# ------------------------------------------------------------ blocking calls
# Calls that park the holding thread while a lock is held: every other thread
# queueing on that lock inherits the full wait (and time.sleep under an
# asyncio lock stalls the whole event loop). The port adds the card's waits.
BLOCKING_CALL_NAMES = frozenset({
    "time.sleep", "subprocess.run", "subprocess.check_output",
    "subprocess.check_call", "socket.create_connection",
    "urllib.request.urlopen", "torch.cuda.synchronize",
})
BLOCKING_CALL_ATTRS = frozenset({"block_until_ready", "sendall", "recv",
                                 "urlopen", "synchronize"})
BLOCKING_BARE_NAMES = frozenset({"sleep", "urlopen"})  # from-imports of the above

# --------------------------------------------------------- central allowlist
# For findings with no single line to annotate (lock-order cycles, contract
# rows). match is a substring of the finding message; the justification is
# mandatory and echoed by the lint output.
# deploy/ENV_VARS.md and observability/ are the reference's operator
# documents, which the port is held to and never edits: a row the port has no
# counterpart for is allowed here, with the reason.
_PALLAS_BLOCKS = ("a block size of the TPU's Pallas ragged_paged_attention; the port's "
                  "K1 sizes its launch from ops/paged_attention._plan and the tuned "
                  "table (LLMD_ATTN_TUNE_FILE, ops/attn_tune.py) instead")
ALLOWLIST: tuple = (
    AllowEntry(
        "lock-unguarded-read", "PoolController.",
        "event-loop confined: every read runs on the controller's loop "
        "between awaits; the asyncio lock only serializes the multi-await "
        "reconcile/retire sections (writes stay lint-enforced)"),
    AllowEntry("env-doc-stale", "LLMD_ATTN_BKV:", _PALLAS_BLOCKS),
    AllowEntry("env-doc-stale", "LLMD_ATTN_BQ:", _PALLAS_BLOCKS),
    AllowEntry("env-doc-stale", "LLMD_ATTN_DECODE_N:",
               "the decode-shape gate of the Pallas block-size overrides, which "
               "the port has no counterpart for (see LLMD_ATTN_BKV)"),
    AllowEntry("env-doc-stale", "LLMD_LAYER_UNROLL:",
               "the unroll width of the reference's lax.scan over layers; the port "
               "runs its layers as a Python loop and its bench refuses "
               "--layer-unroll (ROADMAP Queue A item 1)"),
    AllowEntry("env-undocumented", "CUDA_HOME:",
               "the CUDA toolkit's own variable (external), read by native/build.py "
               "to find nvcc; the TPU image's contract table has no CUDA rows"),
    AllowEntry("env-undocumented", "CUDA_PATH:",
               "the CUDA toolkit's own variable (external), read by native/build.py "
               "to find nvcc when CUDA_HOME is unset"),
    AllowEntry("env-undocumented", "OMP_NUM_THREADS:",
               "the OpenMP runtime's own variable (external): tools/dryrun.py sets it "
               "to 1 for its rank processes and restores the caller's value after"),
    AllowEntry("metrics-dangling-ref", "llmd_tpu:decision_:",
               "promql.md's prose names the family prefix llmd_tpu:decision_*; "
               "every family under it is in the port's registry "
               "(register_engine_metrics / register_router_metrics)"),
)

PORT = LintConfig(
    globs=("llmd_tpu_torch/**/*.py",),
    hot_paths=HOT_PATHS,
    dialect="torch",
    sync_call_attrs=SYNC_CALL_ATTRS,
    sync_call_names=SYNC_CALL_NAMES,
    jit_call_names=JIT_CALL_NAMES,
    jit_call_attrs=JIT_CALL_ATTRS,
    blocking_call_names=BLOCKING_CALL_NAMES,
    blocking_call_attrs=BLOCKING_CALL_ATTRS,
    blocking_bare_names=BLOCKING_BARE_NAMES,
    blocking_untimed_waits=True,
    allowlist=ALLOWLIST,
    config_file="llmd_tpu_torch/tools/llmd_lint/config.py",
    env_source_globs=("llmd_tpu_torch/**/*.py",),
    consumer_package="llmd_tpu_torch",
    registry_module="llmd_tpu_torch.obs.metrics",
    events_module="llmd_tpu_torch.obs.events",
    package_dir="llmd_tpu_torch",
    program_calls=frozenset({"self._op", "self._world.local"}),
)
