"""KV-durability gate: the cluster prefix tier survives replica churn (port
of ``tools/kv_durability_check.py``: the same prompts, phases, checks and
verdict JSON; ``ci_gate`` stage ``kv-durability-check``).

End-to-end over REAL tiny-model port engines and the port's
``RemoteKVStoreServer`` speaking KVS1 — the same servers production wires
together, so write-back, crc + hash-chain verification, the circuit breaker,
and drain-time flushing are all exercised on actual frames.

Asserts:

1. **five-rung token identity** — local pool hit, peer pull, durable-tier get,
   local offload tier, and re-prefill (including the corrupt-store
   down-ladder) all produce greedy output token-identical to a plain engine;
2. **scale-to-zero -> scale-up with the store alive** — the last replica
   drains (write-back flush), dies, and a fresh replica serves >= 90% of
   repeat-prefix requests without recomputing the prefix (a durable-less
   control replica recomputes every one);
3. **mid-run store kill** — the store is killed halfway through a replay and
   every request still completes 200 with token-identical output (the
   breaker degrades the rung; zero client 5xx).

Run: python -m llmd_tpu_torch.tools.kv_durability_check [--cpu]  (the card
unless ``--cpu``; exit 0 = every check holds)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import urllib.error
import urllib.request

from llmd_tpu_torch.engine.engine import resolve_device

HIT_FLOOR = 0.90
BLOCK = 8          # engine page_size below
N_GROUPS = 4
REPEATS = 3
PROMPTS = [
    f"group-{g:02d} " + ("shared conversation context " * 3)[: 8 * BLOCK]
    for g in range(N_GROUPS)
]

# the durable tier rides the precise KV plane; precise also makes engines
# prefer the python transfer transport, which speaks pull_prefix (rung 2).
# A tight client envelope: the gate must finish in seconds even while the
# store is dead, so attempts are short and the breaker trips fast.
GATE_ENV = {"LLMD_KV_PLANE": "precise"}
GATE_ENV_DEFAULTS = {
    "LLMD_KV_DURABLE_OP_TIMEOUT_S": "1.0",
    "LLMD_KV_DURABLE_PROBE_TIMEOUT_S": "0.25",
    "LLMD_KV_DURABLE_RETRIES": "1",
    "LLMD_KV_DURABLE_BACKOFF_MS": "5",
    "LLMD_KV_DURABLE_BREAKER_FAILURES": "2",
    "LLMD_KV_DURABLE_BREAKER_COOLDOWN_S": "30",
}


@contextlib.contextmanager
def gate_env():
    """The gate's environment (engines read it at construction), restored
    on exit: the durable store's address is set per engine inside."""
    keys = (*GATE_ENV, *GATE_ENV_DEFAULTS, "LLMD_KV_DURABLE_STORE")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(GATE_ENV)
    for k, v in GATE_ENV_DEFAULTS.items():
        os.environ.setdefault(k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _engine_cfg(**kw):
    from llmd_tpu_torch.engine.config import EngineConfig

    base = dict(page_size=BLOCK, num_pages=64, max_model_len=256,
                max_batch_size=4, prefill_chunk=32)
    base.update(kw)
    return EngineConfig(**base)


def _hashes(prompt: str) -> list[int]:
    from llmd_tpu_torch.core.kv_events import block_keys_for_tokens

    return block_keys_for_tokens(list(prompt.encode()), BLOCK)


def _reusable(prompt: str) -> int:
    """Tokens a full-prefix restore credits: whole blocks minus the final
    token (its logit must be recomputed)."""
    n = len(prompt.encode())
    full = (n // BLOCK) * BLOCK
    return full - BLOCK if full == n else full


def _post(url: str, body: "dict | None" = None, timeout: float = 30.0) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(body or {}).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, {}
    except (OSError, ValueError):
        return 599, {}


def _gen(addr: str, prompt: str, ktp=None) -> tuple[int, dict]:
    body = {"model": "m", "prompt": prompt, "max_tokens": 8, "temperature": 0}
    if ktp:
        body["kv_transfer_params"] = ktp
    return _post(f"http://{addr}/v1/completions", body)


def _drained(addr: str) -> bool:
    st, body = _post(f"http://{addr}/drain?timeout_s=15")
    return st == 200 and body.get("status") == "drained"


def _durable_stamp(probe, prompt: str):
    """The router rung's stand-in: probe the store, stamp tier="durable"."""
    keys = _hashes(prompt)
    found = probe.probe(keys)
    if found <= 0:
        return None
    return {"do_prefix_pull": True, "tier": "durable", "num_blocks": found,
            "block_hashes": keys[:found]}


def _text(body: dict) -> "str | None":
    choices = body.get("choices") or [{}]
    return choices[0].get("text")


def _cached(body: dict) -> int:
    return (body.get("usage") or {}).get("cached_tokens", -1)


def run(device, params=None, identity_only: bool = False, model=None) -> dict:
    """The gate on ``device``: its verdict dict, with each prompt's control
    text under ``expected``. ``model``: the engines' config (default
    ``tiny``); ``params``: their weights (default: drawn from seed 0).
    ``identity_only``: phase 1 (the five rungs) alone."""
    with gate_env():
        return _run(device, params, identity_only, model)


def _run(device, params, identity_only: bool, model) -> dict:
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.kv.remote_store import RemoteKVStoreServer
    from llmd_tpu_torch.kv.writeback import DurableStoreClient, DurableStoreConfig
    from llmd_tpu_torch.models import get_model_config

    model = model or get_model_config("tiny")
    store = RemoteKVStoreServer()
    store.start()
    store_addr = f"127.0.0.1:{store.port}"
    os.environ["LLMD_KV_DURABLE_STORE"] = store_addr
    engines: list[EngineServer] = []

    def _up(durable=True, transfer=False, **cfg_kw) -> EngineServer:
        if not durable:
            os.environ.pop("LLMD_KV_DURABLE_STORE", None)
        try:
            srv = EngineServer(model, _engine_cfg(**cfg_kw), model_name="m",
                               host="127.0.0.1", port=0,
                               kv_transfer_port=0 if transfer else None,
                               device=device, params=params)
        finally:
            os.environ["LLMD_KV_DURABLE_STORE"] = store_addr
        srv.start()
        engines.append(srv)
        return srv

    checks: dict[str, bool] = {}
    detail: dict = {}
    statuses: list[int] = []

    def gen(addr: str, prompt: str, ktp=None) -> dict:
        st, body = _gen(addr, prompt, ktp)
        statuses.append(st)
        return body

    try:
        control = _up(durable=False)
        expected = {p: _text(gen(control.address, p)) for p in PROMPTS}

        # ---- phase 1: five-rung token identity ----------------------------
        a = _up(transfer=True)
        b = _up(transfer=True)
        p0, p1 = PROMPTS[0], PROMPTS[1]
        texts = {}

        gen(a.address, p0)  # cold prefill
        body = gen(a.address, p0)  # rung 1: local hit
        texts["rung1_local"] = _text(body)
        rung1_cached = _cached(body) >= _reusable(p0)

        gen(b.address, p1)  # warm the peer
        peer_ktp = {"do_prefix_pull": True,
                    "remote_host": "127.0.0.1",
                    "remote_port": b.transfer_source.port,
                    "remote_request_id": "durability-gate-peer",
                    "num_blocks": len(_hashes(p1)),
                    "block_hashes": _hashes(p1)}
        body = gen(a.address, p1, peer_ktp)  # rung 2
        texts["rung2_peer"] = _text(body)
        rung2_cached = _cached(body) >= _reusable(p1)

        # rung 3: drain A (write-back flush) -> fresh replica pulls the
        # store; rung 4: an offload-tier engine evicts to host and reloads
        drained = _drained(a.address)
        probe = DurableStoreClient(DurableStoreConfig.from_env())
        c = _up()
        body = gen(c.address, p0, _durable_stamp(probe, p0))
        texts["rung3_durable"] = _text(body)
        rung3_cached = _cached(body) >= _reusable(p0)

        d = _up(durable=False, cpu_offload_pages=64, num_pages=16)
        for p in PROMPTS:  # small pool: earlier groups evict to the host tier
            gen(d.address, p)
        body = gen(d.address, PROMPTS[0])  # rung 4
        texts["rung4_offload"] = _text(body)
        rung4_cached = _cached(body) > 0

        # rung 5: corrupt store -> crc/chain verify rejects, re-prefill
        store.set_faults(corrupt_payload=True)
        e5 = _up()
        body = gen(e5.address, p1, _durable_stamp(probe, p1))
        texts["rung5_reprefill"] = _text(body)
        rung5_recompute = _cached(body) == 0
        store.set_faults(corrupt_payload=False)
        corrupted = store.fault_counts["corrupted"]

        ident = {
            "rung1_local": texts["rung1_local"] == expected[p0],
            "rung2_peer": texts["rung2_peer"] == expected[p1],
            "rung3_durable": texts["rung3_durable"] == expected[p0],
            "rung4_offload": texts["rung4_offload"] == expected[p0],
            "rung5_reprefill": texts["rung5_reprefill"] == expected[p1],
        }
        checks["five_rung_token_identity"] = all(ident.values())
        checks["rung_credits"] = (rung1_cached and rung2_cached
                                  and rung3_cached and rung4_cached
                                  and rung5_recompute and drained
                                  and corrupted > 0)
        detail["rung_identity"] = ident
        detail["rung_credits"] = {
            "rung1_local": rung1_cached, "rung2_peer": rung2_cached,
            "rung3_durable": rung3_cached, "rung4_offload": rung4_cached,
            "rung5_recomputed": rung5_recompute,
            "drain_flushed": drained, "store_corruptions_served": corrupted,
        }
        detail["expected"] = expected

        if not identity_only:
            # ---- phase 2: scale-to-zero -> scale-up, store alive ----------
            # the LAST replica drains and dies; a fresh one must restore the
            # working set from the store (control: durable-less replica
            # recomputes everything)
            warm = _up()
            for p in PROMPTS:
                gen(warm.address, p)
            drained2 = _drained(warm.address)
            warm.stop()  # scale to zero
            engines.remove(warm)

            cold_ctrl = _up(durable=False)
            fresh = _up()
            served, total, ctrl_served = 0, 0, 0
            for rep in range(REPEATS):
                for p in PROMPTS:
                    body = gen(fresh.address, p, _durable_stamp(probe, p))
                    total += 1
                    if _cached(body) >= _reusable(p) and _text(body) == expected[p]:
                        served += 1
                    if rep == 0:
                        if _cached(gen(cold_ctrl.address, p)) >= _reusable(p):
                            ctrl_served += 1
            hit_ratio = served / max(1, total)
            checks["scale_to_zero_restore"] = drained2 and hit_ratio >= HIT_FLOOR
            checks["durable_less_control_recomputes"] = ctrl_served == 0
            detail["scale_to_zero"] = {
                "drained": drained2, "repeat_prefix_requests": total,
                "no_recompute": served, "hit_ratio": round(hit_ratio, 4),
                "hit_floor": HIT_FLOOR,
                "control_no_recompute": ctrl_served,
            }

            # ---- phase 3: store killed mid-replay -------------------------
            victim = _up()
            stamps = [_durable_stamp(probe, p) for p in PROMPTS]
            kill_ok = True
            n_before_kill = 0
            for rep in range(REPEATS):
                if rep == 1:
                    store.stop()  # hard kill, no drain
                for p, ktp in zip(PROMPTS, stamps):
                    st, body = _gen(victim.address, p, ktp)
                    statuses.append(st)
                    if st != 200 or _text(body) != expected[p]:
                        kill_ok = False
                    elif rep == 0:
                        n_before_kill += 1
            checks["store_kill_zero_5xx"] = kill_ok
            detail["store_kill"] = {
                "served_before_kill": n_before_kill,
                "breaker_state_after": victim.engine.durable.breaker_state(),
                "client_errors": sum(1 for s in statuses if s >= 500),
            }

        n_5xx = sum(1 for s in statuses if s >= 500)
        checks["zero_5xx"] = n_5xx == 0
        verdict = {
            "kv_durability_check": "ok" if all(checks.values()) else "failed",
            "requests": len(statuses),
            "client_5xx": n_5xx,
            "checks": checks,
            **detail,
        }
    finally:
        for srv in engines:
            try:
                srv.stop()
            except Exception as e:  # noqa: BLE001 — teardown reports, never masks
                print(f"kv_durability_check: stopping {srv.address}: {e!r}",
                      file=sys.stderr)
        store.stop()
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU; default the card")
    args = ap.parse_args(argv)
    verdict = run(resolve_device("cpu" if args.cpu else None))
    verdict.pop("expected", None)
    print(json.dumps(verdict, indent=2))
    if verdict["kv_durability_check"] != "ok":
        print(f"kv_durability_check: FAILED — checks: {verdict['checks']}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
