"""KV-plane gate: precise prefix routing + cross-engine pulls under churn
(copy of ``tools/kv_plane_check.py`` over the port's router, KV plane and fake
servers; no jax, no aiohttp).

End-to-end over the real router, no hardware: three in-process fake engines
publish block-level KV events over ZMQ; the RouterServer runs an
approx-producer config with ``LLMD_KV_PLANE=precise`` (proving the env knob
swaps the live scheduler), and a shared-prefix trace drives routing.

Asserts:

1. >= 90% of repeat-prefix requests land on an engine that already holds the
   prefix or complete a cross-engine pull (measured as: the prefix was NOT
   recomputed — ``usage.cached_tokens`` covers it — or the serving engine
   logged a completed pull),
2. one engine is KILLED mid-measurement (no drain) with ZERO client-visible
   5xx / transport errors,
3. the router-side block index stays bounded across kill/relaunch churn
   (departed pods are evicted by the pool listener).

Run: python -m llmd_tpu_torch.tools.kv_plane_check  (exit 0 when every check
holds)
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

from llmd_tpu_torch.router.http import HTTPClient


def gate_env() -> None:
    """The gate IS the precise plane; retries sized so a mid-run kill never
    surfaces to the client, short backoff keeps the gate inside seconds. Set
    before the router is built (it reads them then), never at import."""
    os.environ["LLMD_KV_PLANE"] = "precise"
    os.environ.setdefault("LLMD_KV_PLANE_STALE_S", "0")  # tiny run: no stale trips
    os.environ.setdefault("LLMD_RETRY_MAX_ATTEMPTS", "4")
    os.environ.setdefault("LLMD_RETRY_BACKOFF_MS", "5")
    os.environ.setdefault("LLMD_RETRY_BACKOFF_MAX_MS", "50")
    os.environ.setdefault("LLMD_BREAKER_COOLDOWN_S", "0.5")


HIT_FLOOR = 0.90
N_GROUPS = 6
REPEATS = 12
BLOCK = 16
PREFIX_BLOCKS = 8  # 128 shared-prefix tokens per group, > pull threshold (4)

# the config declares the APPROX pair: LLMD_KV_PLANE=precise must swap it
CFG = """
plugins:
  - {name: queue, type: queue-depth-scorer}
  - {name: prefix, type: approx-prefix-cache-producer}
  - {name: prefix-score, type: prefix-cache-scorer}
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: queue, weight: 3}
      - {pluginRef: prefix-score, weight: 1}
"""
# queue outweighs prefix: with idle engines the queue scores tie and prefix
# affinity decides, but a loaded holder gets routed AROUND — exactly the case
# where the plane must stamp a cross-engine pull instead of re-prefilling


def _group_prompt(g: int, r: int) -> str:
    prefix = f"group-{g:02d} " + ("shared conversation context " * 20)
    prefix = prefix[: PREFIX_BLOCKS * BLOCK]
    return prefix + f" unique-suffix-{g}-{r}"


async def _fake(port_labels: bool = True):
    from llmd_tpu_torch.testing.fake_server import FakeModelServer, FakeServerConfig

    srv = FakeModelServer(FakeServerConfig(
        block_size=BLOCK, num_blocks=4096, kv_events_port=0,
        prefill_us_per_token=20.0, decode_us_per_token=100.0))
    await srv.start()
    return srv


def _endpoint(srv):
    from llmd_tpu_torch.core.endpoint import Endpoint
    from llmd_tpu_torch.kv.subscriber import LABEL_KV_EVENTS_ADDR
    from llmd_tpu_torch.kvplane.plane import LABEL_KV_TRANSFER_PORT

    return Endpoint(address=srv.address, labels={
        LABEL_KV_EVENTS_ADDR: f"127.0.0.1:{srv.cfg.kv_events_port}",
        # fake engines simulate the pull on receipt of stamped params, but the
        # router only PLANS pulls toward peers advertising a side channel
        LABEL_KV_TRANSFER_PORT: "7000",
    })


async def _post(sess: HTTPClient, router_addr: str, prompt: str) -> tuple[int, dict]:
    try:
        r = await sess.request(
            "POST", f"http://{router_addr}/v1/completions",
            json_body={"model": "fake/model", "prompt": prompt, "max_tokens": 4},
            timeout=15)
        if r.status == 200:
            return r.status, await r.json()
        r.close()
        return r.status, {}
    except Exception:
        return 599, {}


async def main_async() -> int:
    from llmd_tpu_torch.core.config import FrameworkConfig
    from llmd_tpu_torch.core.endpoint import EndpointPool
    from llmd_tpu_torch.kv.plugins import CTX_KV_INDEX
    from llmd_tpu_torch.router import filters_pickers as _fp  # noqa: F401
    from llmd_tpu_torch.router import scorers as _s  # noqa: F401
    from llmd_tpu_torch.router.plugins import known_plugin_types
    from llmd_tpu_torch.router.server import RouterServer

    gate_env()

    fakes = [await _fake() for _ in range(3)]
    pool = EndpointPool()
    cfg = FrameworkConfig.from_yaml(CFG, known_types=known_plugin_types())
    router = RouterServer(cfg, pool, port=0, poll_interval_s=0.2)
    await router.start()
    verdict = {"kv_plane_check": "failed"}
    try:
        assert router.kvplane.active and router.kvplane.swaps, \
            "LLMD_KV_PLANE=precise did not swap the approx config"
        for srv in fakes:
            pool.upsert(_endpoint(srv))
        await asyncio.sleep(0.5)  # ZMQ slow-joiner: let SUBs connect

        idx = router.ctx[CTX_KV_INDEX]
        statuses: list[int] = []

        # ---- warm round: first sight of each prefix group -----------------
        sess = HTTPClient()
        try:
            for g in range(N_GROUPS):
                st, _ = await _post(sess, router.address, _group_prompt(g, 0))
                statuses.append(st)
            # the event feed must materialize the warm round in the index
            deadline = time.monotonic() + 5.0
            while len(idx) == 0 and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            index_warm = len(idx)

            # ---- measurement: repeat prefixes, kill one engine halfway ----
            prefix_served = 0
            total = 0
            killed = None
            min_cached = (PREFIX_BLOCKS - 1) * BLOCK  # allow boundary block
            for r in range(1, REPEATS + 1):
                if r == REPEATS // 2:
                    victim = fakes[0]
                    await victim.stop()  # no drain: mid-run death
                    killed = victim.address
                results = await asyncio.gather(*[
                    _post(sess, router.address, _group_prompt(g, r))
                    for g in range(N_GROUPS)])
                if r == REPEATS // 2 + 1 and killed:
                    # discovery catches up one wave later; the retry loop and
                    # breakers carried the interim — then the pool listener
                    # must evict the dead pod's index entries
                    pool.remove(killed)
                for st, body in results:
                    statuses.append(st)
                    total += 1
                    cached = int(((body.get("usage") or {})
                                  .get("cached_tokens", 0)))
                    if cached >= min_cached:
                        prefix_served += 1

            # ---- pull exercise: load the holder, route around it ----------
            # find a live engine holding a full measured prefix, inflate its
            # queue gauge: the queue scorer now routes the next repeat to a
            # non-holder, and the plane must stamp a pull for the prefix
            from llmd_tpu_torch.core.kv_events import block_keys_for_tokens
            from llmd_tpu_torch.testing.fake_server import fake_tokenize

            live = [f for f in fakes if f.address != killed]
            holder, group = None, None
            for g in range(N_GROUPS):
                keys = block_keys_for_tokens(
                    fake_tokenize(_group_prompt(g, 0)), BLOCK)
                for f in live:
                    if keys[PREFIX_BLOCKS - 1] in f.blocks:
                        holder, group = f, g
                        break
                if holder:
                    break
            assert holder is not None, "no live engine holds a full prefix"
            holder.queued = 500
            await asyncio.sleep(0.6)  # let the poller scrape the gauge
            for r in range(REPEATS + 1, REPEATS + 4):
                st, body = await _post(sess, router.address,
                                       _group_prompt(group, r))
                statuses.append(st)
                total += 1
                cached = int(((body.get("usage") or {})
                              .get("cached_tokens", 0)))
                if cached >= min_cached:
                    prefix_served += 1
            holder.queued = 0
            await asyncio.sleep(0.4)
        finally:
            await sess.close()

        hit_ratio = prefix_served / max(1, total)
        n_5xx = sum(1 for s in statuses if s >= 500)
        index_after_kill = len(idx)

        # ---- churn: kill/relaunch cycles must keep the index bounded ------
        peak = index_after_kill
        for cycle in range(6):
            srv = await _fake()
            pool.upsert(_endpoint(srv))
            await asyncio.sleep(0.15)
            sess = HTTPClient()
            try:
                await _post(sess, router.address, _group_prompt(90 + cycle, 0))
            finally:
                await sess.close()
            peak = max(peak, len(idx))
            pool.remove(srv.address)
            await srv.stop()
        index_final = len(idx)
        # bounded = every indexed entry belongs to a LIVE pod: departures
        # (kill + 6 relaunch cycles) were all evicted by the pool listener
        live_addrs = {e.address for e in pool.list()}
        indexed_pods = set(getattr(idx, "_pod_keys", {}) or {})
        bounded = index_final <= peak and indexed_pods <= live_addrs

        stats = dict(router.kvplane.stats)
        pulls_completed = sum(f.pulls_completed for f in fakes
                              if f.address != killed)
        ok = (hit_ratio >= HIT_FLOOR and n_5xx == 0 and bounded
              and stats["precise_requests"] > 0
              and stats["pulls_planned"] > 0 and pulls_completed > 0)
        verdict = {
            "kv_plane_check": "ok" if ok else "failed",
            "mode": "precise",
            "swaps": router.kvplane.swaps,
            "requests": len(statuses),
            "repeat_prefix_requests": total,
            "prefix_served": prefix_served,
            "hit_ratio": round(hit_ratio, 4),
            "hit_floor": HIT_FLOOR,
            "client_5xx": n_5xx,
            "killed_mid_run": killed,
            "pulls_completed": pulls_completed,
            "pulls_stamped": stats["pulls_planned"],
            "index_blocks": {"warm": index_warm, "after_kill": index_after_kill,
                             "churn_peak": peak, "final": index_final},
            "index_bounded": bounded,
            "plane_stats": stats,
            "checks": {"hit_ratio": hit_ratio >= HIT_FLOOR,
                       "zero_5xx": n_5xx == 0,
                       "index_bounded": bounded,
                       "precise_path_used": stats["precise_requests"] > 0,
                       "pull_exercised": (stats["pulls_planned"] > 0
                                          and pulls_completed > 0)},
        }
    finally:
        await router.stop()
        for f in fakes:
            try:
                await f.stop()
            except Exception:
                pass

    print(json.dumps(verdict, indent=2), flush=True)
    if verdict["kv_plane_check"] != "ok":
        print(f"kv_plane_check: FAILED — checks: {verdict.get('checks')}",
              file=sys.stderr)
        return 1
    return 0


def main() -> int:
    argparse.ArgumentParser(description=__doc__).parse_args()
    return asyncio.run(main_async())


if __name__ == "__main__":
    sys.exit(main())
