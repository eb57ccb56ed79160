"""Grouped GEMMs of the MoE expert MLP: the CUDA kernels' wrappers, their plain
versions, and their counters.

Ports of two TPU kernels of ``llmd_tpu/ops/grouped_gemm.py``, with the
reference's signatures:

* :func:`ragged_grouped_gemm` (K2, ``ragged_grouped_gemm``), the default
  ``sorted`` dispatch: ``out[b] = x[b] @ w[block_slot[b]]`` over token-sorted
  ``[nb, bc, D]`` blocks; a block with ``block_rows[b] == 0`` is zeros, every
  other block is multiplied whole (dead rows included).
* :func:`grouped_gemm` (K4, ``grouped_gemm``), the capacity-einsum path:
  ``out[g] = x[g] @ w[g]``; a group with ``counts[g] == 0`` is zeros.

Both accumulate in float32 and return ``x.dtype``. For CUDA tensors the
wrapper launches ``csrc/grouped_gemm.cu`` or raises; for CPU tensors it calls
the plain version. There is no fallback from the kernel to the plain version.
Each wrapper and each plain version counts its runs in ``.launches``.

The source has two instances, chosen by :func:`_instance` from the dtype and
the widths alone: ``"wgmma"`` (bfloat16 with D and F multiples of 8: tensor
cores fed by TMA copies through a ring of shared-memory stages) and
``"simt"`` (float32, and bfloat16 at other widths: CUDA-core FMAs). Each
wrapper also counts its launches per instance in ``.launches_by_instance``.
A CUDA-graph replay of a program that launches a wrapper adds what the
capture counted (``engine/cuda_graph.py``), so the counters count device
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INSTANCE_CODE = {"simt": 0, "wgmma": 1}


def ragged_grouped_gemm_ref(x: torch.Tensor, w: torch.Tensor,
                            block_slot: torch.Tensor,
                            block_rows: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: each block times its slot's weight in float32,
    cast to ``x.dtype``; zero-row blocks are zeros."""
    ragged_grouped_gemm_ref.launches += 1
    wb = w.index_select(0, block_slot.long())
    out = torch.bmm(x.float(), wb.float()).to(x.dtype)
    return out * (block_rows > 0).to(out.dtype)[:, None, None]


ragged_grouped_gemm_ref.launches = 0


def grouped_gemm_ref(x: torch.Tensor, w: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: per-group product in float32, cast to
    ``x.dtype``; zero-count groups are zeros."""
    grouped_gemm_ref.launches += 1
    out = torch.bmm(x.float(), w.float()).to(x.dtype)
    return out * (counts > 0).to(out.dtype)[:, None, None]


grouped_gemm_ref.launches = 0


@functools.cache
def _library():
    """The kernels' C entry points, every argument type declared (an
    undeclared pointer would pass as a 32-bit int and be cut)."""
    from llmd_tpu_torch.native.build import load

    lib = load("grouped_gemm").lib
    rgg = lib.llmd_ragged_grouped_gemm
    rgg.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    rgg.restype = ctypes.c_int
    gg = lib.llmd_grouped_gemm
    gg.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    gg.restype = ctypes.c_int
    return rgg, gg


def build() -> float:
    """Build (or load the cached build of) the kernels; returns seconds taken."""
    from llmd_tpu_torch.native.build import load

    _library()
    return load("grouped_gemm").seconds


def _instance(dtype: torch.dtype, D: int, F: int) -> str:
    """The kernel instance for these operands: ``"wgmma"`` for bfloat16 with
    D and F multiples of 8 (the TMA copies move 16-byte rows), ``"simt"``
    otherwise (float32 stays off the tensor cores, which would take it in
    TF32)."""
    if dtype == torch.bfloat16 and D > 0 and D % 8 == 0 and F % 8 == 0:
        return "wgmma"
    return "simt"


def _check(name: str, x: torch.Tensor, w: torch.Tensor, *index: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[2] != w.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} are not "
                         "[groups, rows, D] and [slots, D, F]")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"{name}: x {x.dtype} / w {w.dtype}; the kernel takes "
                        "float32 or bfloat16, both alike")
    if any(t.shape != (x.shape[0],) for t in index):
        raise ValueError(f"{name}: index arrays must be [{x.shape[0]}]")
    if any(t.device != x.device for t in (w, *index)):
        raise ValueError(f"{name}: all inputs must be on x's device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a view at an odd offset is
    copied): the wgmma instance's TMA copies need both."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fn, name: str, instance: str, x: torch.Tensor, w: torch.Tensor,
            index: list[torch.Tensor], dims: tuple[int, ...]) -> torch.Tensor:
    out = torch.empty((x.shape[0], x.shape[1], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    xc, wc = _aligned(x), _aligned(w)
    idx = [t.to(torch.int32).contiguous() for t in index]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xc.data_ptr(), wc.data_ptr(), *(t.data_ptr() for t in idx),
                 out.data_ptr(), *dims, _DTYPE_CODE[x.dtype], _INSTANCE_CODE[instance],
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel ({instance}) launch failed: cudaError {err}")
    return out


def ragged_grouped_gemm(x: torch.Tensor, w: torch.Tensor, block_slot: torch.Tensor,
                        block_rows: torch.Tensor) -> torch.Tensor:
    """K2: x [nb, bc, D], w [S, D, F], block_slot / block_rows [nb] int ->
    [nb, bc, F]. The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. ``block_slot`` must lie in [0, S) (the kernel reads it on the
    device and does not check)."""
    if x.device.type == "cpu":
        return ragged_grouped_gemm_ref(x, w, block_slot, block_rows)
    if x.device.type != "cuda":
        raise ValueError(f"ragged_grouped_gemm: unsupported device {x.device}")
    _check("ragged_grouped_gemm", x, w, block_slot, block_rows)
    nb, bc, D = x.shape
    S, _, F = w.shape
    instance = _instance(x.dtype, D, F)
    out = _launch(_library()[0], "ragged_grouped_gemm", instance, x, w,
                  [block_slot, block_rows], (nb, bc, D, F, S))
    ragged_grouped_gemm.launches += 1
    ragged_grouped_gemm.launches_by_instance[instance] += 1
    return out


ragged_grouped_gemm.launches = 0
ragged_grouped_gemm.launches_by_instance = {"wgmma": 0, "simt": 0}


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """K4: x [G, C, D], w [G, D, F], counts [G] int -> [G, C, F]. The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return grouped_gemm_ref(x, w, counts)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm: unsupported device {x.device}")
    _check("grouped_gemm", x, w, counts)
    if w.shape[0] != x.shape[0]:
        raise ValueError(f"grouped_gemm: {x.shape[0]} groups but {w.shape[0]} weights")
    G, C, D = x.shape
    F = w.shape[2]
    instance = _instance(x.dtype, D, F)
    out = _launch(_library()[1], "grouped_gemm", instance, x, w, [counts], (G, C, D, F))
    grouped_gemm.launches += 1
    grouped_gemm.launches_by_instance[instance] += 1
    return out


grouped_gemm.launches = 0
grouped_gemm.launches_by_instance = {"wgmma": 0, "simt": 0}


def make_moe_matmul():
    """The ``moe_block`` matmul_impl ``impl(xe [S, C, D], w [S, D, F],
    slot_counts [S]) -> [S, C, F]``: K4's wrapper, whose signature it is."""
    return grouped_gemm
