"""The port's bench (``llmd_tpu_torch/tools/bench.py``) at ``--tiny --cpu``, in
this process, against the reference's ``bench.py --tiny --cpu`` (run as its
own process: it sets up JAX on the CPU itself).

Its one JSON line carries every key of ``tools/perf_regress.TOLERANCES`` as
a number, and the counters that the regression gate holds exact equal the
reference bench's on the same config: tokens, steps, calls, shape and the
goodput classes. The goodput padding equals the reference's in this run
only because each of its two unified steps fills the token budget (4
prompts of 64 tokens = 256): the reference pads a unified step to the
budget and the port runs exactly its real tokens, so on a partial step the
two differ; the port's padding here is the decode program's slots past each
row's budget (4 calls x 8 slots x 8 steps - 248 tokens). Flags for features
the port does not serve exit non-zero naming their ROADMAP item; ``--kv-dtype
fp8`` is served (an fp8 KV pool, the reference's ``kv_cache_dtype="fp8"``).

The speculative and structured runs (``--spec-mode ngram --workload echo``,
``--workload json-echo --assert-spec-structured``, ``--workload json`` with
the masked program and with its unified degrade) carry exactly the
reference bench's keys, bar the two the port leaves out; the reference's
keys do not depend on its flags, so its uniform run gives them.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tools.perf_regress as pr
from llmd_tpu_torch.tools import bench

REPO = Path(__file__).resolve().parent.parent
# bench.py keys of features the port does not serve (the port bench's docstring)
LEFT_OUT = {"kv_layout", "layer_unroll"}
EXACT = ("prefill_tokens", "decode_tokens", "preemptions", "unified_steps", "decode_calls",
         "batch", "isl", "osl", "goodput_committed_tokens", "goodput_prefix_saved_tokens",
         "goodput_preempted_recompute_tokens", "goodput_padding_tokens")


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny bench is thousands of small ops: on one intra-op thread it
    runs in well under a second, where thread pools contending with the
    other test workers for the cores can take tens of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(capsys, argv) -> dict:
    assert bench.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1  # one JSON line on stdout
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def reference() -> dict:
    proc = subprocess.run([sys.executable, "bench.py", "--tiny", "--cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_tiny_cpu_bench_keys_and_counters(capsys, reference):
    row = _run(capsys, ["--tiny", "--cpu"])
    for key in pr.TOLERANCES:
        assert isinstance(row[key], (int, float)) and not isinstance(row[key], bool), key
    for key in EXACT:
        assert row[key] == reference[key], key
    assert row["goodput_padding_tokens"] == 4 * 8 * 8 - row["decode_tokens"]
    assert row["recompiles"] == 0 and row["value"] > 0 and row["wall_s"] > 0
    assert row["quantize"] is None and row["weights"] == "random:tiny"
    assert row["device"] == "cpu" and row["power_limit_w"] is None
    # no peak for the CPU: no guessed utilization
    assert row["decode_mfu"] is None and row["weights_bw_util"] is None
    assert 0 < row["ttft_p50_ms"] <= row["ttft_p90_ms"] <= row["e2e_p90_ms"]
    assert row["e2e_mean_ms"] <= row["wall_s"] * 1e3
    assert row["kernel_launches"]["paged_attention"] == {  # plain on the CPU
        "mma": 0, "simt": 0, "mma_fp8": 0, "simt_fp8": 0}
    # the gate reads the payload: provenance differs from any TPU baseline,
    # so throughput is skipped and the counters compared
    assert pr.extract_payload(row) is row


def test_tiny_cpu_bench_int8(capsys, reference):
    row = _run(capsys, ["--tiny", "--cpu", "--quantize", "int8", "--chain-depth", "1",
                        "--pack-overlap", "off"])
    assert row["quantize"] == "int8" and row["chain_depth"] == 1 and not row["pack_overlap"]
    for key in ("prefill_tokens", "decode_tokens", "unified_steps", "decode_calls",
                "goodput_committed_tokens"):
        assert row[key] == reference[key], key


@pytest.mark.parametrize("argv", [
    ["--layer-unroll", "2"], ["--tune-attn"], ["--tune-attn", "--attn-tune-file", "t.json"],
    ["--kv-layout", "padded"], ["--kv-layout", "packed"],
])
def test_unserved_flags_exit_nonzero(capsys, argv):
    """Flags for what the port does not serve exit non-zero naming their
    ROADMAP item; ``--tune-attn`` is refused on the CPU, where K1 runs its
    plain version, which has no launch plan to tune."""
    with pytest.raises(SystemExit) as e:
        bench.main(["--tiny", "--cpu", *argv])
    assert e.value.code != 0
    err = capsys.readouterr().err
    if argv[0] == "--tune-attn":
        assert "times K1's plans on the card" in err
    else:
        assert "not served by the port: ROADMAP" in err and argv[0] in err


@pytest.mark.parametrize("kv_dtype", ["fp8", "bf16"])
def test_tiny_cpu_bench_kv_dtype(capsys, reference, kv_dtype):
    """``--kv-dtype fp8`` (as ``bench.py``'s: ``kv_cache_dtype="fp8"``) serves
    the window over a float8_e4m3fn pool and says so; ``bf16`` keeps the
    model's pool, as the reference's. The counters are the reference's (the
    pool's dtype moves no token or step)."""
    row = _run(capsys, ["--tiny", "--cpu", "--kv-dtype", kv_dtype])
    assert row["kv_cache_dtype"] == ("fp8" if kv_dtype == "fp8" else reference["kv_cache_dtype"])
    for key in EXACT:
        assert row[key] == reference[key], key
    assert row["recompiles"] == 0
    assert not any(sum(by.values()) for by in row["kernel_launches"].values())  # plain on CPU


@pytest.mark.parametrize("argv", [
    ["--spec-mode", "ngram", "--workload", "echo"],
    ["--spec-mode", "ngram", "--workload", "json-echo", "--assert-spec-structured"],
    ["--workload", "json"],
    ["--workload", "json", "--structured-fused", "off"],
])
def test_tiny_cpu_bench_spec_and_structured(capsys, reference, argv):
    """The reference bench's keys for the same flags (its keys do not depend
    on them), the counters behind them, and the path each workload took."""
    row = _run(capsys, ["--tiny", "--cpu", *argv])
    assert set(reference) - set(row) == LEFT_OUT
    assert row["workload"] == argv[argv.index("--workload") + 1]
    assert row["decode_tokens"] + row["prefill_tokens"] == reference["decode_tokens"] + 512
    assert row["structured_violations"] == 0 and row["recompiles"] == 0
    if "--spec-mode" in argv:
        assert row["spec_mode"] == "ngram" and row["spec_tokens"] == 4
        assert row["spec_verify_steps"] > 0 and row["spec_accepted"] > 0
        assert row["spec_accepted_per_verify_step"] == round(
            row["spec_accepted"] / row["spec_verify_steps"], 3)
        assert row["goodput_spec_rejected_tokens"] == row["spec_rejected"]
        assert row["spec_steps_s"] > 0
    else:
        assert row["spec_mode"] == "off" and row["spec_tokens"] is None
        assert row["spec_verify_steps"] == 0 and row["spec_accepted_per_verify_step"] is None
    if "json" in row["workload"]:
        assert row["structured_requests"] == row["requests"]
        fused = "off" not in argv
        assert row["structured_fused"] == fused
        # which path the constrained rows took: masked chains or unified steps
        assert (row["structured_chain_stages"] > 0) == fused
        assert (row["structured_mask_builds"] > row["requests"]) == (not fused)
    if "--assert-spec-structured" in argv:
        assert row["spec_accepted_constrained"] > 0
        assert row["spec_fsm_crosscheck_mismatches"] == 0


def test_spec_flags_validated(capsys):
    for argv in (["--spec-mode", "medusa"], ["--workload", "yaml"],
                 ["--structured-fused", "maybe"]):
        with pytest.raises(SystemExit) as e:
            bench.main(["--tiny", "--cpu", *argv])
        assert e.value.code != 0
