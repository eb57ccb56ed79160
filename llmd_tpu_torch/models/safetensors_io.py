"""The safetensors file format, read and written with numpy and the standard
library (the port does not depend on the ``safetensors`` package).

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}``, then the raw little-endian tensor bytes, ``data_offsets`` counted
from the end of the header. ``BF16`` has no numpy dtype: it is read as
``uint16`` and viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import struct
from typing import Iterable

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the raw bytes, torch dtype of the tensor)
DTYPES = {"BF16": (np.uint16, torch.bfloat16), "F16": (np.float16, torch.float16),
          "F32": (np.float32, torch.float32)}
_TORCH_TO_ST = {tdt: name for name, (_, tdt) in DTYPES.items()}


def read_header(path: str) -> tuple[dict, int]:
    """(header without ``__metadata__``, byte offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class SafetensorsFile:
    """Tensor-by-name reads from one file (memory-mapped, copied on read)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.header, self._base = read_header(path)
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")

    def keys(self) -> list[str]:
        return list(self.header)

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` on the host, in its stored dtype."""
        info = self.header[name]
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype {info['dtype']}; "
                             f"the reader takes {sorted(DTYPES)}")
        np_dt, t_dt = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        raw = np.array(self._mm[self._base + begin: self._base + end])  # a copy
        a = raw.view(np.dtype(np_dt).newbyteorder("<")).reshape(info["shape"])
        t = torch.from_numpy(a.astype(np_dt, copy=False))
        return t.view(torch.bfloat16) if t_dt == torch.bfloat16 else t


def write_file(path: str, tensors: Iterable[tuple[str, torch.Tensor]],
               metadata: "dict | None" = None) -> None:
    """Write ``(name, tensor)`` pairs (bf16, f16 or f32, on any device) as one
    safetensors file, the tensors back to back in the given order, the
    header padded with spaces to a multiple of 8 bytes."""
    header: dict = {"__metadata__": {"format": "pt", **(metadata or {})}}
    blobs, off = [], 0
    for name, t in tensors:
        if t.dtype not in _TORCH_TO_ST:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} is not bf16, f16 or f32")
        t = t.detach().to("cpu").contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": _TORCH_TO_ST[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)))
        f.write(h)
        for raw in blobs:
            f.write(raw)
