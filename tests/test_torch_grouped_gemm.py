"""The grouped-GEMM wrappers of the PyTorch port on the CPU: which kernel
instance each dtype and width takes, the checks a CUDA launch goes through,
and the plain versions taken for CPU tensors (the kernels themselves run in
``tests/test_torch_kernel_gpu.py`` on the card)."""

import numpy as np
import pytest
import torch

from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models.registry import MODEL_REGISTRY
from llmd_tpu_torch.ops import grouped_gemm as tgg


@pytest.mark.parametrize("dtype,D,F,instance", [
    (torch.bfloat16, 1024, 1024, "wgmma"),  # moe-wide-sim wi
    (torch.bfloat16, 512, 1024, "wgmma"),   # moe-wide-sim wo
    (torch.bfloat16, 8, 200, "wgmma"),      # below one column tile and one depth step
    (torch.bfloat16, 16, 200, "wgmma"),
    (torch.bfloat16, 136, 64, "wgmma"),
    (torch.bfloat16, 100, 200, "simt"),     # D not a multiple of 8
    (torch.bfloat16, 64, 100, "simt"),      # F not a multiple of 8
    (torch.bfloat16, 0, 64, "simt"),        # no depth
    (torch.float32, 1024, 1024, "simt"),    # float32 stays off the tensor cores
    (torch.float32, 8, 200, "simt"),
    (torch.float16, 1024, 1024, "simt"),
])
def test_instance_by_dtype_and_widths(dtype, D, F, instance):
    assert tgg._instance(dtype, D, F) == instance


@pytest.mark.parametrize("name", sorted(n for n, c in MODEL_REGISTRY.items()
                                        if c.moe_num_experts))
def test_registry_moe_models_take_wgmma_in_bf16(name):
    """Both launches of every registry MoE model's expert MLP (wi: D -> 2Fe,
    wo: Fe -> D) take the tensor-core instance in bf16 and the CUDA-core one
    in float32."""
    cfg = get_model_config(name)
    D, Fe = cfg.hidden_size, cfg.moe_intermediate_size
    for d, f in ((D, 2 * Fe), (Fe, D)):
        assert tgg._instance(torch.bfloat16, d, f) == "wgmma"
        assert tgg._instance(torch.float32, d, f) == "simt"


def _operands(dtype=torch.bfloat16, wdtype=None, n_index=4):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 8, 16), np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((3, 16, 24), np.float32)).to(wdtype or dtype)
    index = torch.tensor([2, 0, 1, 1][:n_index] + [0] * (n_index - 4), dtype=torch.int32)
    return x, w, index


@pytest.mark.parametrize("case,exc", [
    ("float16", TypeError),
    ("float64", TypeError),
    ("mixed", TypeError),
    ("short_index", ValueError),
    ("long_index", ValueError),
    ("depth_mismatch", ValueError),
])
def test_check_refuses(case, exc):
    """The checks every CUDA launch goes through: a dtype the kernel does not
    take, x and w of different dtypes, index arrays of the wrong length, and
    widths that do not chain."""
    x, w, index = _operands(
        dtype={"float16": torch.float16, "float64": torch.float64}.get(case, torch.bfloat16),
        wdtype=torch.float32 if case == "mixed" else None,
        n_index={"short_index": 3, "long_index": 5}.get(case, 4))
    if case == "depth_mismatch":
        w = w[:, :8]
    with pytest.raises(exc):
        tgg._check("ragged_grouped_gemm", x, w, index, index)


def test_check_accepts_kernel_operands():
    for dtype in (torch.float32, torch.bfloat16):
        x, w, index = _operands(dtype)
        tgg._check("ragged_grouped_gemm", x, w, index, index)
        tgg._check("grouped_gemm", x, w, index)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_tensors_take_plain_versions_and_count_no_instance(dtype):
    x, w, slot = _operands(dtype)
    live = torch.tensor([8, 0, 3, 8], dtype=torch.int32)
    by_instance = (dict(tgg.ragged_grouped_gemm.launches_by_instance),
                   dict(tgg.grouped_gemm.launches_by_instance))
    launches = (tgg.ragged_grouped_gemm.launches, tgg.grouped_gemm.launches)
    plain = (tgg.ragged_grouped_gemm_ref.launches, tgg.grouped_gemm_ref.launches)
    a = tgg.ragged_grouped_gemm(x, w, slot, live)
    b = tgg.grouped_gemm(x[:3], w, live[:3])
    assert (tgg.ragged_grouped_gemm.launches, tgg.grouped_gemm.launches) == launches
    assert (dict(tgg.ragged_grouped_gemm.launches_by_instance),
            dict(tgg.grouped_gemm.launches_by_instance)) == by_instance
    assert (tgg.ragged_grouped_gemm_ref.launches,
            tgg.grouped_gemm_ref.launches) == (plain[0] + 1, plain[1] + 1)
    assert a.dtype == b.dtype == dtype
    assert torch.equal(a, tgg.ragged_grouped_gemm_ref(x, w, slot, live))
    assert torch.equal(b, tgg.grouped_gemm_ref(x[:3], w, live[:3]))
    assert not a[1].any() and not b[1].any()


def test_aligned_copies_only_misaligned_views():
    base = torch.zeros(65, dtype=torch.bfloat16)
    ok = base[:64].view(4, 16)
    assert tgg._aligned(ok) is ok
    odd = base[1:].view(4, 16)
    assert odd.data_ptr() % 16 != 0
    fixed = tgg._aligned(odd)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, odd)
    strided = base[:64].view(16, 4).t()
    assert tgg._aligned(strided).is_contiguous()
