"""CLI: python -m llmd_tpu_torch.engine.serve --model llama-1b --port 8000 [--cpu]
         [--moe-dispatch auto|sorted|einsum] [--quantize int8] [--kv-cache-dtype fp8]
         [--kv-events-port N]

Serves ``--model`` on the port's HTTP server: a registry name with random
weights from ``--seed``, or an HF checkpoint directory with its weights
(``models/hf_loader``) and, unless ``--tokenizer`` says otherwise, the HF
tokenizer in that directory when it has one. ``--quantize int8`` serves int8
weight-only weights (quantized at start); ``--kv-cache-dtype fp8`` a
``float8_e4m3fn`` KV pool. Runs on the CUDA card unless
``--cpu`` is given. ``--kv-events-port`` publishes the engine's KV events
over ZMQ PUB on that port (0 picks a free one) for a router's KV indexer.
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
    ap.add_argument("--tokenizer", default=None, help="local HF tokenizer dir")
    ap.add_argument("--seed", type=int, default=0, help="random-weight seed")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (dev)")
    args = ap.parse_args(argv)

    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.engine.tokenizer import load_tokenizer
    from llmd_tpu_torch.models import resolve_model
    from llmd_tpu_torch.models.hf_loader import is_hf_checkpoint

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
        kv_cache_dtype=args.kv_cache_dtype)
    server = EngineServer(
        model_cfg, engine_cfg,
        model_name=args.served_model_name, host=args.host, port=args.port,
        kv_events_port=args.kv_events_port,
        tokenizer=load_tokenizer(tokenizer), params=params, seed=args.seed,
        device="cpu" if args.cpu else None)
    server.start()
    events = ("" if args.kv_events_port is None
              else f", KV events on port {server.kv_events_port}")
    print(f"llmd-tpu-torch engine serving {server.model_name} on "
          f"http://{server.address} (device {server.engine.device}, "
          f"attention {server.engine.attn_backend}, MoE {server.engine.moe_dispatch} "
          f"{server.engine.moe_backend}, weights "
          f"{'hf:' + args.model if params is not None else 'random'}"
          f"{', int8' if args.quantize else ''}, KV pool "
          f"{server.engine.stats.kv_cache_dtype}{events})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
