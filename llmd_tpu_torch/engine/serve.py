"""CLI: python -m llmd_tpu_torch.engine.serve --model llama-1b --port 8000 [--cpu]
         [--moe-dispatch auto|sorted|einsum] [--quantize int8] [--kv-cache-dtype fp8]
         [--kv-events-port N] [--role both|prefill|decode] [--kv-transfer-port N]
         [--advertise-host H] [--cpu-offload-pages N] [--offload-fs-path DIR]
         [--enable-lora [--max-loras N] [--max-lora-rank R]]

Serves ``--model`` on the port's HTTP server: a registry name with random
weights from ``--seed``, or an HF checkpoint directory with its weights
(``models/hf_loader``) and, unless ``--tokenizer`` says otherwise, the HF
tokenizer in that directory when it has one. ``--quantize int8`` serves int8
weight-only weights (quantized at start); ``--kv-cache-dtype fp8`` a
``float8_e4m3fn`` KV pool. Runs on the CUDA card unless
``--cpu`` is given. ``--kv-events-port`` publishes the engine's KV events
over ZMQ PUB on that port (0 picks a free one) for a router's KV indexer.
``--kv-transfer-port`` opens the P/D KV-transfer side channel (0 picks a free
one; ``LLMD_TPU_KV_TRANSFER_PORT`` is its default, as in the reference), and
``--advertise-host`` is the routable host written into ``kv_transfer_params``
(default ``--host`` unless that is a bind-any address). ``--role`` tags the
engine for the pool (the engine does not read it). ``--cpu-offload-pages`` and
``--offload-fs-path`` turn on the CPU and FS offload tiers. ``--enable-lora``
serves LoRA adapters (``--max-loras`` slots of rank ``--max-lora-rank``,
loaded at run time through ``/v1/load_lora_adapter``). A model with media
tokens (``--model tiny-vl``) serves chat media: items an encode worker sent
along (``mm_items``) are used, the rest are encoded in-process by the tower,
on the engine's device.
Flag names follow the reference CLI
(``llmd_tpu/engine/serve.py``) for the options the port keeps.
"""

from __future__ import annotations

import argparse
import os
import threading


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny",
                    help="registry name (MODEL_REGISTRY) or HF checkpoint directory")
    ap.add_argument("--served-model-name", default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--kv-events-port", type=int, default=None,
                    help="publish KV events (ZMQ PUB) on this port; 0 = a free one")
    _env_kvt = os.environ.get("LLMD_TPU_KV_TRANSFER_PORT")
    ap.add_argument("--kv-transfer-port", type=int,
                    default=int(_env_kvt) if _env_kvt else None,
                    help="bind the P/D KV-transfer side channel here (0 = a free one)")
    ap.add_argument("--advertise-host", default=None,
                    help="routable host for kv_transfer_params (defaults to --host "
                         "unless that is a bind-any address)")
    ap.add_argument("--role", default="both", choices=("both", "prefill", "decode"))
    ap.add_argument("--cpu-offload-pages", type=int, default=0,
                    help="KV blocks of the CPU offload tier")
    ap.add_argument("--offload-fs-path", default=None,
                    help="FS tier below the CPU tier (a directory, shareable)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=512)
    ap.add_argument("--max-model-len", type=int, default=2048)
    ap.add_argument("--max-batch-size", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=128)
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--moe-dispatch", default="auto", choices=("auto", "sorted", "einsum"),
                    help="MoE token dispatch (EngineConfig.moe_dispatch): auto = "
                         "sorted (drop-free, ragged grouped GEMM), einsum = the "
                         "capacity einsum (per-expert grouped GEMM)")
    ap.add_argument("--quantize", default=None, choices=("int8",),
                    help="weight-only quantization (EngineConfig.quantize_weights)")
    ap.add_argument("--kv-cache-dtype", default=None, choices=("fp8",),
                    help="fp8 KV pool (EngineConfig.kv_cache_dtype): halves decode's "
                         "per-step KV read stream")
    ap.add_argument("--enable-lora", action="store_true",
                    help="enable dynamic LoRA adapter serving")
    ap.add_argument("--max-loras", type=int, default=8)
    ap.add_argument("--max-lora-rank", type=int, default=8)
    ap.add_argument("--tokenizer", default=None, help="local HF tokenizer dir")
    ap.add_argument("--seed", type=int, default=0, help="random-weight seed")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (dev)")
    args = ap.parse_args(argv)

    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.engine.tokenizer import load_tokenizer
    from llmd_tpu_torch.models import resolve_model
    from llmd_tpu_torch.models.hf_loader import is_hf_checkpoint
    from llmd_tpu_torch.models.lora import LoRAConfig

    model_cfg, params = resolve_model(args.model)
    tokenizer = args.tokenizer
    if tokenizer is None and is_hf_checkpoint(args.model) and any(
            os.path.isfile(os.path.join(args.model, f))
            for f in ("tokenizer.json", "tokenizer_config.json")):
        tokenizer = args.model
    engine_cfg = EngineConfig(
        page_size=args.block_size, num_pages=args.num_pages,
        max_model_len=args.max_model_len, max_batch_size=args.max_batch_size,
        prefill_chunk=args.prefill_chunk, decode_steps=args.decode_steps,
        moe_dispatch=args.moe_dispatch, quantize_weights=args.quantize,
        kv_cache_dtype=args.kv_cache_dtype, role=args.role,
        cpu_offload_pages=args.cpu_offload_pages, offload_fs_path=args.offload_fs_path,
        lora=LoRAConfig(max_adapters=args.max_loras, rank=args.max_lora_rank)
        if args.enable_lora else None)
    server = EngineServer(
        model_cfg, engine_cfg,
        model_name=args.served_model_name, host=args.host, port=args.port,
        kv_events_port=args.kv_events_port, kv_transfer_port=args.kv_transfer_port,
        tokenizer=load_tokenizer(tokenizer), params=params, seed=args.seed,
        device="cpu" if args.cpu else None)
    if args.advertise_host:
        server.advertise_host = args.advertise_host
    server.start()
    events = ("" if args.kv_events_port is None
              else f", KV events on port {server.kv_events_port}")
    if server.transfer_source is not None:
        events += (f", role {args.role}, KV transfer on port {server.kv_transfer_port}"
                   f" ({'native' if server.transfer_source.native else 'python'})")
    print(f"llmd-tpu-torch engine serving {server.model_name} on "
          f"http://{server.address} (device {server.engine.device}, "
          f"attention {server.engine.attn_backend}, MoE {server.engine.moe_dispatch} "
          f"{server.engine.moe_backend}, weights "
          f"{'hf:' + args.model if params is not None else 'random'}"
          f"{', int8' if args.quantize else ''}, KV pool "
          f"{server.engine.stats.kv_cache_dtype}{events}"
          f"{f', LoRA {args.max_loras} x rank {args.max_lora_rank}' if args.enable_lora else ''}"
          f"{', vision tower in-process' if model_cfg.has_vision else ''})",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
