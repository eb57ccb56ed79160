"""Dtype names on the KV wires, and raw bytes <-> torch tensors.

The KVT1 transfer frames, the FS tier's files and the KVS1 store frames name
a block's dtype as numpy does in the reference (``str(array.dtype)``):
``"float32"``, ``"bfloat16"``, ``"float8_e4m3fn"``. numpy knows the last two
only through ``ml_dtypes``, which the port does not need: host blocks are
torch CPU tensors, and bytes become tensors through ``torch.frombuffer``.
"""

from __future__ import annotations

import torch

_BY_NAME: dict[str, torch.dtype] = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
}
_NAMES = {v: k for k, v in _BY_NAME.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a torch dtype (the reference's ``str(np.dtype)``)."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise TypeError(f"no KV wire name for {dtype}") from None


def resolve_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire name; TypeError for any other name."""
    try:
        return _BY_NAME[name]
    except (KeyError, TypeError):
        raise TypeError(f"data type {name!r} not understood") from None


def from_bytes(buf, name: str, shape) -> torch.Tensor:
    """A CPU tensor of dtype ``name`` and ``shape`` over ``buf`` (bytes-like;
    a writable buffer is shared, a read-only one is copied once)."""
    dtype = resolve_dtype(name)
    if isinstance(buf, (bytes, memoryview)) and (isinstance(buf, bytes) or buf.readonly):
        buf = bytearray(buf)
    flat = (torch.frombuffer(buf, dtype=torch.uint8) if len(buf)
            else torch.empty(0, dtype=torch.uint8))
    return flat.view(dtype).reshape(tuple(shape))


def to_bytes(t: torch.Tensor) -> memoryview:
    """The bytes of a CPU tensor, C order, without a copy when it is contiguous."""
    t = t.contiguous()
    return memoryview(t.view(torch.uint8).reshape(-1).numpy())


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: itself when it is there, else a pinned copy
    (synchronous: the call returns once the bytes have landed)."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host
