"""Utilization-plane gate (port of ``tools/util_check.py``: the same engine
settings, rounds, checks and printed lines; ``ci_gate`` stage ``util-check``).

One tiny engine, two generate rounds (warmup + steady state), then the
utilization attribution plane's standing invariants are asserted end to end:

1. per-program goodput fractions sum to 1 +- 1e-6 (the sum-to-capacity
   construction of obs/costmodel.py actually holds through the live engine)
2. padding efficiency lands in (0, 1] for every program that dispatched
3. the MFU/MBU families are exposed through /metrics. With ``--cpu`` the
   null-peak path: the CPU has no peak-table entry, so the TYPE headers are
   present with no samples, and the achieved-FLOP/s / bytes/s gauges DO carry
   samples. On the card (the H100 has a peak entry, ``obs/costmodel.chip_peaks``)
   both families must carry samples, each in (0, 1].
4. the recompile counter stays flat across the steady-state round. The
   port's compile is a CUDA-graph capture: on the card every decode program
   is captured in warmup; the CPU captures nothing, so its count is empty and
   stays so.
5. ledger totals and the scraped ``llmd_tpu:goodput_tokens_total`` counters
   agree exactly, and the bench-style measured-window delta accounting
   (the bench's ``goodput_*`` keys) reproduces the counter deltas token for
   token.

Run: python -m llmd_tpu_torch.tools.util_check [--cpu]  (the card unless
``--cpu``; exit 0 = all checks pass)
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine.config import EngineConfig
from llmd_tpu_torch.engine.engine import LLMEngine, resolve_device
from llmd_tpu_torch.models.config import ModelConfig
from llmd_tpu_torch.obs.costmodel import GOODPUT_KINDS

ENGINE_KW = dict(page_size=16, num_pages=96, max_model_len=256, max_batch_size=4,
                 prefill_chunk=32, decode_steps=4, max_num_batched_tokens=64)


def _run(eng: LLMEngine, n: int, salt: int) -> None:
    for i in range(n):
        eng.add_request(f"u{salt}-{i}", list(range(1, 24 + i)),
                        SamplingParams(max_tokens=10, temperature=0.0))
    while eng.has_work():
        eng.step()


def _label(rendered: str, key: str) -> str:
    # rendered labels look like {program="decode",kind="committed"}
    for part in rendered.strip("{}").split(","):
        k, _, v = part.partition("=")
        if k == key:
            return v.strip('"')
    raise AssertionError(f"label {key} not in {rendered}")


def _scrape_goodput(eng: LLMEngine) -> dict:
    """program -> kind -> value from the live registry counters."""
    out: dict = {}
    for name, labels, value in eng.metrics.registry.collect():
        if name != "llmd_tpu:goodput_tokens_total":
            continue
        out.setdefault(_label(labels, "program"), {})[_label(labels, "kind")] = value
    return out


def _samples(expo: str, fam: str) -> list[float]:
    return [float(ln.rpartition(" ")[2]) for ln in expo.splitlines()
            if ln.startswith(fam + "{")]


def check(device: "torch.device | str", params=None) -> dict:
    """Run the gate on ``device`` (the tiny model at seed 0, or ``params``);
    raises AssertionError on a failed check, else returns its numbers:
    ``totals`` (program -> kind -> tokens), ``window_delta`` (kind -> tokens of the steady round), ``compiles``,
    ``programs`` and, on the card, the ``mfu`` / ``mbu`` samples."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    eng = LLMEngine(ModelConfig(), EngineConfig(**ENGINE_KW), params=params, seed=0,
                    device=device)
    try:
        return _check(eng, on_card)
    finally:
        eng.close()


def _check(eng: LLMEngine, on_card: bool) -> dict:
    assert eng.util is not None, (
        "LLMD_UTIL_LEDGER unexpectedly off — the gate must run with the "
        "ledger enabled")
    _run(eng, 3, salt=1)  # warmup: captures every program this workload uses
    compiles_warm = eng.util.compiles()
    if on_card:
        assert compiles_warm, "no program captures recorded during warmup"
    else:
        assert compiles_warm == {}, ("the CPU captured a graph", compiles_warm)
    base_totals = eng.util.totals()
    base_scrape = _scrape_goodput(eng)

    _run(eng, 4, salt=2)  # steady state: same shapes, zero fresh captures

    # (1) fractions sum to 1 per program
    for prog in eng.util.programs():
        fr = eng.util.fractions(prog)
        s = sum(fr.values())
        assert abs(s - 1.0) <= 1e-6, (prog, fr, s)
        # (2) padding efficiency in (0, 1]
        pe = eng.util.padding_efficiency(prog)
        assert pe is not None and 0.0 < pe <= 1.0, (prog, pe)
    print(f"util-check: goodput fractions sum to 1 across "
          f"{len(eng.util.programs())} programs; padding efficiency in (0,1]")

    # (3) the MFU/MBU families: null peaks on the CPU, samples on the card
    expo = eng.metrics.registry.expose()
    out: dict = {}
    for fam in ("llmd_tpu:program_mfu", "llmd_tpu:program_mbu"):
        assert f"# TYPE {fam} gauge" in expo, f"{fam} family not declared"
        got = _samples(expo, fam)
        if on_card:
            assert got and all(0.0 < v <= 1.0 for v in got), (
                f"{fam} samples {got} on {eng.util.peak_flops} FLOP/s peak — the "
                f"card's peak entry must give samples in (0, 1]")
            out[fam.rpartition("_")[2]] = got
        else:
            assert not got, (
                f"{fam} exported samples on CPU — null peaks must mean no series")
    for fam in ("llmd_tpu:program_flops_per_second",
                "llmd_tpu:program_bytes_per_second"):
        assert _samples(expo, fam), f"{fam} carried no samples"
    if on_card:
        print(f"util-check: MFU {out['mfu']} / MBU {out['mbu']} samples in (0,1] "
              f"on {torch.cuda.get_device_name(eng.device)}'s peak entry; "
              f"achieved-rate gauges carry samples")
    else:
        print("util-check: MFU/MBU families declared with null peaks; "
              "achieved-rate gauges carry samples")

    # (4) recompile counter flat across steady state
    compiles_now = eng.util.compiles()
    assert compiles_now == compiles_warm, (
        "recaptures during steady-state decode", compiles_warm, compiles_now)
    print(f"util-check: compile counts flat across steady state "
          f"({compiles_now})")

    # (5) ledger == /metrics, exactly; bench-style deltas reproduce them
    totals = eng.util.totals()
    scraped = _scrape_goodput(eng)
    for prog, tk in totals.items():
        for kind, v in tk.items():
            got = scraped.get(prog, {}).get(kind, 0.0)
            if v == 0 and kind not in scraped.get(prog, {}):
                continue  # zero classes never create counter children
            assert got == v, (prog, kind, v, got)
    bench_delta = {k: 0 for k in GOODPUT_KINDS}
    for prog, tk in totals.items():
        base = base_totals.get(prog, {})
        for kind, v in tk.items():
            bench_delta[kind] += v - base.get(kind, 0)
    scrape_delta = {k: 0.0 for k in GOODPUT_KINDS}
    for prog, tk in scraped.items():
        base = base_scrape.get(prog, {})
        for kind, v in tk.items():
            scrape_delta[kind] += v - base.get(kind, 0.0)
    assert {k: float(v) for k, v in bench_delta.items()} == scrape_delta, (
        bench_delta, scrape_delta)
    print(f"util-check: ledger == /metrics exactly; window deltas match "
          f"token for token ({bench_delta})")
    return out | {"totals": totals, "window_delta": bench_delta,
                  "compiles": compiles_now, "programs": list(eng.util.programs())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the null-peak path); default the card")
    args = ap.parse_args(argv)
    t_start = time.monotonic()
    check(resolve_device("cpu" if args.cpu else None))
    print(f"util-check: ALL OK ({time.monotonic() - t_start:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
