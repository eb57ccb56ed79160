"""CLI: python -m llmd_tpu_torch.engine.serve --model llama-1b --port 8000 [--cpu] ...

The port's ``llmd_tpu/engine/serve.py``: every flag of the reference, with
its name, choices and ``LLMD_*`` environment default, mapped onto the
``EngineConfig`` field the reference maps it to, so a pool launches a port
replica with the argv it builds for a JAX one
(``llmd_tpu/pool/launcher.engine_argv``, module name swapped). Flags the
port cannot serve yet are parsed and refused, naming their ROADMAP item:
``--kv-layout packed|padded`` (``ops/packed_kv`` is not ported: it reclaims
TPU lane padding the port never adds; ``auto`` is taken).

Serves ``--model`` on the port's HTTP server: a registry name with random
weights from ``--seed`` (port only), or an HF checkpoint directory with its
weights (``models/hf_loader``) and its own tokenizer (``--tokenizer``
otherwise); real weights with the byte tokenizer are refused, as the
reference refuses them. Runs on the CUDA card unless ``--cpu``.

- ``--data-parallel-size`` / ``--expert-parallel-size`` /
  ``--tensor-parallel-size`` / ``--sequence-parallel-size``: the mesh
  ``MeshConfig(dp, sp, ep, tp)``, as the reference builds it. More than one
  device starts a world of that many rank processes (``parallel/launch.py``:
  rank r on ``cuda:r``, or gloo ranks under ``--cpu``); this process is rank
  0 and serves. ``--data-parallel-size N``: N rank frontends over the one
  engine (``engine/dp_group.WideEPEngineGroup``) on ports ``port ..
  port+N-1`` (port 0: free ones). With ``--kv-events-port P`` rank r
  publishes its own blocks' KV events on ``P + r`` (0: free ports), so a
  router's prefix index reads each rank port.
- ``--compile-cache-dir DIR``: the native library cache
  (``native/build.set_cache_dir``) lives in DIR, set before any library
  loads, so a relaunch with the same DIR loads the kernels' ``.so`` files and
  runs no nvcc. CUDA graphs are captured in each process either way.
- ``--predictor-train-url URL``: the engine's latency rows are posted to
  ``URL/samples`` once a second (the latency predictor's training feed).
- ``--attn-impl``, ``--attn-tune-file``, ``--moe-dispatch``: the engine's
  kernel selection and K1's launch-config table (``ops/attn_tune``).
- ``--kv-events-port`` publishes KV events over ZMQ PUB (0: a free port);
  ``--kv-transfer-port`` opens the P/D KV-transfer side channel and
  ``--advertise-host`` is the host written into ``kv_transfer_params``;
  ``--cpu-offload-pages`` / ``--offload-fs-path`` turn on the offload tiers;
  ``--enable-lora`` serves adapters; a model with media tokens serves chat
  media.

The first line on stdout says where it serves, what it runs and, on the card,
how many kernel libraries were compiled (``native builds: N compiled``).
"""

from __future__ import annotations

import argparse
import os
import threading


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: the reference's flags and ``--seed``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny",
                    help="registry name (MODEL_REGISTRY) or HF checkpoint directory")
    ap.add_argument("--served-model-name", default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int,
                    default=int(os.environ.get("LLMD_TPU_PORT", "8000")))
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=512)
    ap.add_argument("--max-model-len", type=int, default=2048)
    ap.add_argument("--max-batch-size", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=128)
    ap.add_argument("--decode-steps", type=int, default=4)
    _env_kve = os.environ.get("LLMD_TPU_KV_EVENTS_PORT")
    ap.add_argument("--kv-events-port", type=int,
                    default=int(_env_kve) if _env_kve else None,
                    help="publish KV events (ZMQ PUB) on this port; 0 = a free one")
    _env_kvt = os.environ.get("LLMD_TPU_KV_TRANSFER_PORT")
    ap.add_argument("--kv-transfer-port", type=int,
                    default=int(_env_kvt) if _env_kvt else None,
                    help="bind the P/D KV-transfer side channel here (0 = a free one)")
    ap.add_argument("--advertise-host", default=None,
                    help="routable host for kv_transfer_params (defaults to --host "
                         "unless that is a bind-any address)")
    ap.add_argument("--tokenizer", default=None, help="local HF tokenizer dir")
    ap.add_argument("--role", default="both", choices=["both", "prefill", "decode"])
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="weight-only quantization (EngineConfig.quantize_weights)")
    ap.add_argument("--kv-cache-dtype", default=None, choices=["fp8"],
                    help="fp8 KV pool (EngineConfig.kv_cache_dtype): halves decode's "
                         "per-step KV read stream")
    ap.add_argument("--kv-layout", default="auto", choices=["auto", "packed", "padded"],
                    help="KV pool lane layout; the port takes auto only (ops/packed_kv "
                         "is not ported: ROADMAP Queue A, not ported by design)")
    ap.add_argument("--attn-impl", default="auto", choices=["auto", "pallas", "reference"],
                    help="attention kernels (EngineConfig.attn_impl): auto = the CUDA "
                         "kernels on a card, the plain versions for CPU tensors; "
                         "pallas = the CUDA kernels, refused on the CPU; reference = "
                         "the plain versions everywhere")
    ap.add_argument("--attn-tune-file", default=os.environ.get("LLMD_ATTN_TUNE_FILE"),
                    help="K1's launch-config table (ops/attn_tune JSON, written by "
                         "the bench's --tune-attn)")
    ap.add_argument("--moe-dispatch",
                    default=os.environ.get("LLMD_MOE_DISPATCH", "") or "auto",
                    choices=["auto", "sorted", "einsum"],
                    help="MoE token dispatch (EngineConfig.moe_dispatch): auto = "
                         "sorted (drop-free, ragged grouped GEMM), einsum = the "
                         "capacity einsum (per-expert grouped GEMM)")
    ap.add_argument("--cpu-offload-pages", type=int, default=0,
                    help="KV blocks of the CPU offload tier")
    ap.add_argument("--offload-fs-path", default=None,
                    help="FS tier below the CPU tier (a directory, shareable)")
    ap.add_argument("--spec-mode", default=os.environ.get("LLMD_SPEC_MODE", "off"),
                    choices=["off", "ngram"],
                    help="speculative decoding: 'ngram' = prompt-lookup drafts "
                         "verified through the verify program")
    ap.add_argument("--spec-tokens", type=int,
                    default=int(os.environ.get("LLMD_SPEC_TOKENS", "4")),
                    help="max draft tokens proposed per sequence per verify step")
    ap.add_argument("--spec-ngram-max", type=int,
                    default=int(os.environ.get("LLMD_SPEC_NGRAM_MAX", "3")),
                    help="longest suffix n-gram the drafter matches")
    ap.add_argument("--spec-ngram-min", type=int,
                    default=int(os.environ.get("LLMD_SPEC_NGRAM_MIN", "1")),
                    help="shortest suffix n-gram the drafter falls back to")
    ap.add_argument("--structured-mode",
                    default=os.environ.get("LLMD_STRUCTURED_MODE", "auto"),
                    choices=["auto", "off"],
                    help="structured outputs: 'auto' = compile grammars for requests "
                         "that ask, 'off' = reject structured requests as 400")
    ap.add_argument("--decode-chain-depth", type=int,
                    default=int(os.environ.get("LLMD_DECODE_CHAIN_DEPTH", "2")),
                    help="decode calls kept in flight (EngineConfig.pipeline_depth)")
    ap.add_argument("--pack-overlap", default=os.environ.get("LLMD_PACK_OVERLAP", "on"),
                    choices=["on", "off"],
                    help="chained decode calls upload only what changed; 'off' "
                         "packs every call in full")
    ap.add_argument("--structured-fused",
                    default=os.environ.get("LLMD_STRUCTURED_FUSED", "on"),
                    choices=["on", "off"],
                    help="constrained rows ride the masked decode program; 'off' "
                         "degrades them to 1-token unified steps")
    ap.add_argument("--structured-table-elems", type=int,
                    default=int(os.environ.get("LLMD_STRUCTURED_TABLE_ELEMS",
                                               str(1 << 23))),
                    help="max staged mask-table size (G_pad*S_pad*V elements) before "
                         "constrained rows degrade to unified steps")
    ap.add_argument("--spec-structured", default=os.environ.get("LLMD_SPEC_STRUCTURED", "on"),
                    choices=["on", "off"],
                    help="constrained rows draft and verify through the masked "
                         "verify program; 'off': they never draft")
    ap.add_argument("--spec-structured-crosscheck",
                    default=os.environ.get("LLMD_SPEC_STRUCTURED_CROSSCHECK", "off"),
                    choices=["on", "off"],
                    help="debug: re-derive the automaton state on the host after "
                         "every masked verify step and count disagreements")
    ap.add_argument("--enable-lora", action="store_true",
                    help="enable dynamic LoRA adapter serving")
    ap.add_argument("--max-loras", type=int, default=8)
    ap.add_argument("--max-lora-rank", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (dev)")
    ap.add_argument("--compile-cache-dir", default=None,
                    help="the native kernel library cache: built into and loaded "
                         "from this directory, so a relaunch with the same one runs "
                         "no nvcc (CUDA graphs are captured in every process anyway)")
    ap.add_argument("--predictor-train-url", default=None,
                    help="latency-predictor training server base URL; completed "
                         "requests' TTFT/TPOT rows stream to its POST /samples")
    ap.add_argument("--data-parallel-size", type=int, default=1, dest="dp",
                    help="the mesh's dp axis: DP rank frontends over one engine; "
                         "rank r serves on port+r")
    ap.add_argument("--expert-parallel-size", type=int, default=1, dest="ep")
    ap.add_argument("--tensor-parallel-size", type=int, default=1, dest="tp")
    ap.add_argument("--sequence-parallel-size", type=int, default=1, dest="sp")
    ap.add_argument("--seed", type=int, default=0, help="random-weight seed")
    return ap


def parse_args(argv: "list[str] | None" = None) -> argparse.Namespace:
    """Parse ``argv``; exit non-zero, naming the ROADMAP item, for a flag the
    port cannot serve yet."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.kv_layout != "auto":
        ap.error(f"--kv-layout {args.kv_layout} is not served by the port: ROADMAP "
                 "Queue A, not ported by design (ops/packed_kv reclaims TPU lane "
                 "padding the port never adds); use auto")
    for flag, n in (("data", args.dp), ("expert", args.ep), ("tensor", args.tp),
                    ("sequence", args.sp)):
        if n < 1:
            ap.error(f"--{flag}-parallel-size must be >= 1, got {n}")
    return args


def engine_config(args: argparse.Namespace):
    """The ``EngineConfig`` of ``args``, field for field as the reference's
    serve builds it."""
    from llmd_tpu_torch.engine.config import EngineConfig, MeshConfig
    from llmd_tpu_torch.models.lora import LoRAConfig

    return EngineConfig(
        page_size=args.block_size, num_pages=args.num_pages,
        max_model_len=args.max_model_len, max_batch_size=args.max_batch_size,
        prefill_chunk=args.prefill_chunk, decode_steps=args.decode_steps,
        role=args.role, cpu_offload_pages=args.cpu_offload_pages,
        offload_fs_path=args.offload_fs_path,
        mesh=MeshConfig(dp=args.dp, sp=args.sp, ep=args.ep, tp=args.tp),
        dp_ranks=args.dp,
        quantize_weights=args.quantize,
        kv_cache_dtype=args.kv_cache_dtype,
        attn_impl=args.attn_impl,
        attn_tune_file=args.attn_tune_file,
        moe_dispatch=args.moe_dispatch,
        spec_mode=args.spec_mode, spec_tokens=args.spec_tokens,
        spec_ngram_max=args.spec_ngram_max, spec_ngram_min=args.spec_ngram_min,
        structured_mode=args.structured_mode,
        pipeline_depth=max(1, args.decode_chain_depth),
        pack_overlap=args.pack_overlap == "on",
        structured_fused_decode=args.structured_fused == "on",
        structured_table_max_elems=args.structured_table_elems,
        spec_structured=args.spec_structured == "on",
        spec_structured_crosscheck=args.spec_structured_crosscheck == "on",
        lora=LoRAConfig(max_adapters=args.max_loras, rank=args.max_lora_rank)
        if args.enable_lora else None)


def main(argv: "list[str] | None" = None) -> None:
    args = parse_args(argv)
    from llmd_tpu_torch.native import build

    if args.compile_cache_dir:
        build.set_cache_dir(args.compile_cache_dir)

    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.engine.tokenizer import load_tokenizer
    from llmd_tpu_torch.models import resolve_model

    model_cfg, params = resolve_model(args.model)
    # an HF checkpoint dir carries its own tokenizer files
    tok_path = args.tokenizer or (args.model if params is not None else None)
    tokenizer = load_tokenizer(tok_path)
    if params is not None and type(tokenizer).__name__ != "HFTokenizer":
        # real weights + byte fallback = garbage completions that look healthy
        raise SystemExit(
            f"could not load an HF tokenizer from {tok_path!r} for real-weight "
            "serving; pass --tokenizer <dir> with tokenizer.json present")
    engine_cfg = engine_config(args)
    name = args.served_model_name or f"llmd-tpu/{model_cfg.name}"
    device = "cpu" if args.cpu else None

    def builds() -> str:  # the engine built (or loaded) its kernels at construction
        return ("" if args.cpu else
                f", native builds: {build.compiles} compiled, cache {build.BUILD_DIR}")

    if args.dp > 1:
        from llmd_tpu_torch.engine.dp_group import WideEPEngineGroup

        group = WideEPEngineGroup(model_cfg, engine_cfg, ranks=args.dp, model_name=name,
                                  host=args.host, port_base=args.port, tokenizer=tokenizer,
                                  params=params, device=device, seed=args.seed,
                                  kv_events_port_base=args.kv_events_port)
        group.start()
        events = ("" if args.kv_events_port is None else
                  f", KV events on ports {[s.kv_events_port for s in group.servers]}")
        print(f"llmd-tpu-torch wide-EP group serving {args.dp} rank engines on "
              f"{group.endpoints()} (mesh dp={args.dp} sp={args.sp} ep={args.ep} "
              f"tp={args.tp}{events}{builds()})", flush=True)
        stop = group.stop
    else:
        server = EngineServer(
            model_cfg, engine_cfg, model_name=name, host=args.host, port=args.port,
            kv_events_port=args.kv_events_port, kv_transfer_port=args.kv_transfer_port,
            tokenizer=tokenizer, params=params, seed=args.seed, device=device,
            predictor_train_url=args.predictor_train_url)
        if args.advertise_host:
            server.advertise_host = args.advertise_host
        server.start()
        events = ("" if args.kv_events_port is None
                  else f", KV events on port {server.kv_events_port}")
        if server.transfer_source is not None:
            events += (f", role {args.role}, KV transfer on port {server.kv_transfer_port}"
                       f" ({'native' if server.transfer_source.native else 'python'})")
        eng = server.engine
        mesh = engine_cfg.mesh
        print(f"llmd-tpu-torch engine serving {server.model_name} on "
              f"http://{server.address} (device {eng.device}, "
              f"{f'mesh sp={mesh.sp} ep={mesh.ep} tp={mesh.tp}, ' if mesh.num_devices > 1 else ''}"
              f"attention {eng.attn_backend}, tune {eng.attn_tune_hash or 'none'}, "
              f"MoE {eng.moe_dispatch} {eng.moe_backend}, weights "
              f"{'hf:' + args.model if params is not None else 'random'}"
              f"{', int8' if args.quantize else ''}, KV pool "
              f"{eng.stats.kv_cache_dtype}{events}"
              f"{f', LoRA {args.max_loras} x rank {args.max_lora_rank}' if args.enable_lora else ''}"
              f"{', vision tower in-process' if model_cfg.has_vision else ''}{builds()})",
              flush=True)
        stop = server.stop
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        stop()


if __name__ == "__main__":
    main()
