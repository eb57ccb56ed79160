"""The engine side of the KV data plane: the CPU/FS offload tiers, the
external-connector seam, the remote block store and the durable write-back
tier (ports of ``llmd_tpu/kv/``). Host blocks are torch CPU tensors."""
