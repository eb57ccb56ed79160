"""PyTorch/CUDA port of the serving engine, for NVIDIA Hopper (H100).

The JAX package ``llmd_tpu`` is the reference; this package mirrors its module
names so each piece can be found beside its counterpart. It imports torch,
numpy and the standard library only — never ``jax`` and never ``llmd_tpu`` —
and keeps its own copy of every pure-Python module it needs.

Served so far: dense GQA, MoE and absorbed-MLA decoders (registry ``llama-1b``,
``moe-wide-sim``, ``moe-wide-mla``; the ``tiny*`` models in CI) and HF Llama /
Qwen2 / Qwen3 checkpoints, bf16 or int8 weight-only, behind the OpenAI
completions route, with every TPU kernel of the reference as a hand-written
CUDA kernel (``csrc/``), and the reference's bench (``tools/bench.py``).
"""
