"""PyTorch/CUDA port of the serving engine, for NVIDIA Hopper (H100).

The JAX package ``llmd_tpu`` is the reference; this package mirrors its module
names so each piece can be found beside its counterpart. It imports torch,
numpy and the standard library only — never ``jax`` and never ``llmd_tpu`` —
and keeps its own copy of every pure-Python module it needs.

Slice served so far: a dense GQA decoder (registry ``llama-1b`` at full width,
``tiny``/``tiny64`` in CI) behind the OpenAI completions route, with ragged
paged attention as a hand-written CUDA kernel (``csrc/paged_attention.cu``).
"""
