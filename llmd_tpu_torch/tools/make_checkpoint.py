"""Materialise a serving-scale HF-format checkpoint for bench/serve runs (port
of ``tools/make_checkpoint.py``: the same flags, default paths and refusal).

Writes ``config.json`` and sharded safetensors of a registry shape, with
random weights drawn by the port's ``init_params`` from ``--seed``
(``testing/checkpoints.write_hf_checkpoint``), so the full HF-load path —
the one a real checkpoint takes — is what the bench and
``python -m llmd_tpu_torch.engine.serve --model <dir>`` exercise.

Departure, kept on purpose: no tokenizer is written. The reference trains a
BPE tokenizer with ``transformers`` / ``tokenizers``, which the card's
machine does not have; the port's server falls back to its byte tokenizer
for a checkpoint without one. With network access, point ``--model`` at any
downloaded Llama/Qwen checkpoint instead.

Usage: python -m llmd_tpu_torch.tools.make_checkpoint [--shape llama-1b]
           [--out checkpoints/llama-1b-hf] [--dtype bfloat16] [--seed 0]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

MAX_SHARD_BYTES = 500 * 10**6  # the reference's max_shard_size="500MB"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="No tokenizer is written (the reference's needs transformers and "
               "tokenizers, absent on the card's machine): servers of the "
               "checkpoint use the byte tokenizer.")
    ap.add_argument("--shape", default="llama-1b",
                    help="registry shape to materialise (llmd_tpu_torch.models.MODEL_REGISTRY)")
    ap.add_argument("--out", default=None, help="output dir (default checkpoints/<shape>-hf)")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = args.out or os.path.join("checkpoints", f"{args.shape}-hf")
    if os.path.isfile(os.path.join(out, "config.json")):
        print(f"exists: {out}")
        return 0

    import torch

    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.transformer import init_params
    from llmd_tpu_torch.testing.checkpoints import write_hf_checkpoint

    cfg = get_model_config(args.shape)
    if cfg.is_moe:
        raise SystemExit("HF export currently covers the dense families (llama/qwen)")
    cfg = dataclasses.replace(cfg, dtype=args.dtype)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed))
    try:
        write_hf_checkpoint(out, cfg, params, max_shard_bytes=MAX_SHARD_BYTES)
    except ValueError as e:  # MLA / vision shapes have no HF Llama-family layout
        raise SystemExit(str(e)) from e
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
