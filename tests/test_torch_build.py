"""The kernels' build cache key (``llmd_tpu_torch/native/build.py``): a cached
shared library is reused only while its source, the headers it may include
and the nvcc flags are unchanged. Runs without nvcc: only the key is
computed."""

from llmd_tpu_torch.native import build


def test_digest_changes_with_a_header_and_only_with_what_is_built(tmp_path):
    src = tmp_path / "kernel.cu"
    src.write_text('#include "common.cuh"\nextern "C" int f() { return 0; }\n')
    header = tmp_path / "common.cuh"
    header.write_text("#pragma once\nconstexpr int kStages = 3;\n")
    base = build.digest(src)
    assert build.digest(src) == base  # a pure function of the bytes

    header.write_text("#pragma once\nconstexpr int kStages = 4;\n")
    assert build.digest(src) != base  # an edited header never loads a stale .so
    header.write_text("#pragma once\nconstexpr int kStages = 3;\n")
    assert build.digest(src) == base

    (tmp_path / "other.cuh").write_text("#pragma once\n")
    with_other = build.digest(src)
    assert with_other != base  # a new header beside the source counts too
    (tmp_path / "notes.txt").write_text("not built")
    (tmp_path / "other.cu").write_text("// another source")
    assert build.digest(src) == with_other  # other sources and files do not

    src.write_text(src.read_text() + "// edited\n")
    assert build.digest(src) != with_other


def test_the_attention_sources_share_the_header_they_include():
    for name in ("paged_attention", "mla_decode"):
        assert '#include "mma_attention.cuh"' in (build.CSRC / f"{name}.cu").read_text()
    assert (build.CSRC / "mma_attention.cuh").exists()
