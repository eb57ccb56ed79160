"""Structured-outputs gate: schema-constrained serving through the real stack
(port of ``tools/structured_check.py``: the same requests, engine variants,
checks and verdict JSON; ``ci_gate`` stage ``structured-check``).

Spins one in-process port ``EngineServer`` (tiny model, byte tokenizer) per
engine variant and drives N schema-constrained chat completions plus
guided_choice/guided_regex requests through the OpenAI surface. The gate
holds when:

- every constrained response is 200 AND its content parses/validates against
  the constraint it was issued under (100% conformance, not a ratio),
- a malformed schema and a malformed logit_bias answer 400 (never 5xx),
- zero 5xx anywhere,
- all of the above holds again with the n-gram drafter live (spec_mode=
  "ngram"), i.e. the grammar-masked verify program keeps 100% conformance.

Run: python -m llmd_tpu_torch.tools.structured_check [--cpu]  (the card
unless ``--cpu``; exit 0 = the gate holds)
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
import urllib.error
import urllib.request

from llmd_tpu_torch.engine.engine import resolve_device

N_SCHEMA_REQUESTS = 8

SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "maxLength": 8},
        "count": {"enum": [0, 1, 2, 3]},
        "ok": {"type": "boolean"},
    },
    "required": ["name", "count", "ok"],
}
CHOICES = ["alpha", "beta", "gamma"]
REGEX = r"[a-c]{3}-[0-9]{2}"


# The whole battery runs twice: once plain, once with the n-gram drafter
# live so the grammar-masked verify program carries the constrained rows —
# conformance must be 100% either way, since greedy accept/reject keeps spec
# output bitwise identical to spec-off.
ENGINE_VARIANTS = [
    ("spec-off", {}),
    ("spec-ngram", {"spec_mode": "ngram", "spec_tokens": 4}),
]

BAD_BODIES = (
    ("bad-schema", {"messages": [{"role": "user", "content": "x"}],
                    "response_format": {
                        "type": "json_schema",
                        "json_schema": {"schema": {
                            "type": "object",
                            "properties": {"x": {"type": "wat"}},
                            "required": ["x"]}}}}),
    ("bad-rf-type", {"messages": [{"role": "user", "content": "x"}],
                     "response_format": {"type": "yaml_object"}}),
    ("bad-logit-bias", {"messages": [{"role": "user", "content": "x"}],
                        "logit_bias": {"7": 9000}}),
)


def _chat(address: str, body: dict, statuses: dict[int, int]) -> tuple[int, str]:
    body = {"model": "llmd-tpu/tiny", "max_tokens": 64, "temperature": 0.0, **body}
    req = urllib.request.Request(
        f"http://{address}/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    statuses[status] = statuses.get(status, 0) + 1
    if status != 200:
        return status, raw.decode(errors="replace")
    return 200, json.loads(raw)["choices"][0]["message"]["content"]


def drive_variant(device, label: str, spec_overrides: dict,
                  statuses: dict[int, int], bad: list[str]) -> None:
    """One engine variant's battery; failures are appended to ``bad``."""
    from llmd_tpu_torch.engine.config import EngineConfig
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.structured import validate_instance

    server = EngineServer(
        get_model_config("tiny"),
        EngineConfig(page_size=8, num_pages=128, max_model_len=256,
                     max_batch_size=4, prefill_chunk=32, **spec_overrides),
        model_name="llmd-tpu/tiny", port=0, device=device)
    server.start()
    try:
        addr = server.address
        # N schema-constrained requests (varied prompts; temperature 0.7
        # on half so the sampled path is exercised too)
        for i in range(N_SCHEMA_REQUESTS):
            status, text = _chat(addr, {
                "messages": [{"role": "user",
                              "content": f"emit record {i} " * (i + 1)}],
                "temperature": 0.7 if i % 2 else 0.0,
                "seed": i,
                "response_format": {"type": "json_schema",
                                    "json_schema": {"schema": SCHEMA}},
            }, statuses)
            if status != 200:
                bad.append(f"{label}/schema[{i}]: HTTP {status}: {text[:200]}")
                continue
            try:
                value = json.loads(text)
            except ValueError:
                bad.append(f"{label}/schema[{i}]: not JSON: {text!r}")
                continue
            if not validate_instance(value, SCHEMA):
                bad.append(f"{label}/schema[{i}]: fails schema: {value!r}")

        status, text = _chat(addr, {
            "messages": [{"role": "user", "content": "pick one"}],
            "guided_choice": CHOICES,
        }, statuses)
        if status != 200 or text not in CHOICES:
            bad.append(f"{label}/choice: HTTP {status}: {text!r}")
        status, text = _chat(addr, {
            "messages": [{"role": "user", "content": "match it"}],
            "guided_regex": REGEX,
        }, statuses)
        if status != 200 or not re.fullmatch(REGEX, text):
            bad.append(f"{label}/regex: HTTP {status}: {text!r}")

        # malformed inputs must answer 400 (and never reach the engine);
        # admission rejects these before the engine config matters, so one
        # pass on the plain variant covers the contract
        if spec_overrides:
            return
        for case, body in BAD_BODIES:
            status, text = _chat(addr, body, statuses)
            if status != 400:
                bad.append(f"{label}/{case}: expected 400, got {status}: {text[:200]}")
    finally:
        server.stop()


def run(device, variants=ENGINE_VARIANTS) -> dict:
    """The battery over ``variants`` on ``device``: the verdict dict."""
    statuses: dict[int, int] = {}
    bad: list[str] = []
    t0 = time.monotonic()
    for label, spec_overrides in variants:
        drive_variant(device, label, spec_overrides, statuses, bad)
    wall = time.monotonic() - t0
    n_5xx = sum(n for code, n in statuses.items() if code >= 500)
    return {
        "structured_check": "ok" if not bad and n_5xx == 0 else "failed",
        "engine_variants": [label for label, _ in variants],
        "schema_requests": N_SCHEMA_REQUESTS * len(variants),
        "statuses": {str(k): v for k, v in sorted(statuses.items())},
        "failures": bad,
        "wall_s": round(wall, 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU; default the card")
    args = ap.parse_args(argv)
    verdict = run(resolve_device("cpu" if args.cpu else None))
    print(json.dumps(verdict, indent=2))
    if verdict["structured_check"] != "ok":
        n_5xx = sum(n for code, n in verdict["statuses"].items() if int(code) >= 500)
        print(f"structured_check: FAILED — {len(verdict['failures'])} failures, "
              f"{n_5xx} 5xx", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
