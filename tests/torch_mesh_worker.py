"""World script of the mesh tests (``tests/test_torch_mesh.py``,
``test_torch_ring_attention.py``, ``test_torch_wide_ep_mesh.py``): rank 0
of a gloo world of CPU rank processes (``llmd_tpu_torch.parallel.launch``),
running a list of cases on that one world and writing their results.

    python tests/torch_mesh_worker.py --world N --spec cases.pkl --out results.pkl
        [--timeout S]

``cases.pkl`` is a pickled list of dicts (port objects and numpy arrays only;
this script imports the port and nothing of the JAX package):

- ``{"kind": "engine", "mesh", "model_cfg", "engine_cfg", "params", "phases",
  "max_tokens", "temperature", "embed"}``: one meshed ``LLMEngine``
  (``params``: the reference's numpy leaves, or None for the seed's random
  ones); each phase a list of prompts generated in turn (greedy unless
  ``temperature``), then ``embed``'s token lists through ``LLMEngine.embed``.
  Result: each phase's tokens and the ring steps after it, the embeddings,
  the engine's stats, whether every rank's device ops gave rank 0's
  tokens, every rank's row log (``checks.row_log``: each op's program, its
  rows and the rows the rank ran) with the ranks' mesh coordinates, and
  whether every rank's pool holds the bytes of the rank of rank 0's tp group
  at its tp index.
- ``{"kind": "call", "mesh", "fn", "kw"}``: ``fn(mesh, **kw)`` on every rank
  (``llmd_tpu_torch.parallel.checks``); rank 0's result and whether the
  workers' equal it.
- ``{"kind": "group", "mesh", "model_cfg", "engine_cfg", "prompts"}``: a
  ``WideEPEngineGroup`` over the world; one completion posted to each rank
  port. Result: (status, completion tokens) per port.
- ``{"kind": "kill", "mesh"}``: rank 1's process is killed, then a call runs:
  the error rank 0 raised and the seconds it took. Ends the world.
- ``{"kind": "script", "mesh", "model_cfg", "engine_cfg", "params", "actions",
  "twin", "env", "tokenizer"}``: one port engine (meshed on the world, or a
  one-card engine when ``mesh`` is None) runs ``actions`` in turn (see
  :func:`run_actions`: adapter loads and unloads, request batches, a bank
  slot read on every rank, KV export over the KVT1 wire with each rank's
  pool planes, inject of an earlier case's export, counters); ``twin``: the
  same actions again on a one-card engine of the same config. ``env``: the
  environment while the engines are built (the durable tier's store).
  Result: each engine's action results, its KV events, and whether every
  rank's device ops gave rank 0's tokens.

Each case's result is a dict, or ``{"error": text}``; the script exits 1
when a case failed or a rank was killed. Tests start it through
:class:`WorldRun`, which bounds it by a deadline and kills what is left of
it (the script, and every rank process carrying its tag) when done.
"""

import argparse
import dataclasses
import json
import os
import pickle
import signal
import subprocess
import sys
import time
import traceback
import urllib.request
import uuid

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from llmd_tpu_torch.core.request import SamplingParams  # noqa: E402
from llmd_tpu_torch.parallel.launch import World  # noqa: E402
from llmd_tpu_torch.parallel.mesh import MeshConfig, rank_coords  # noqa: E402


TAG_VAR = "MESH_WORLD_TAG"


class WorldRun:
    """One run of this script in the background: ``results()`` waits for it
    (``deadline_s`` from the start), then kills the script's process group
    and every rank process carrying this run's tag, whatever happened."""

    def __init__(self, cases: list, world: int, tmp_dir: str, deadline_s: float = 240.0,
                 timeout_s: float = 60.0) -> None:
        self.tag = uuid.uuid4().hex
        self.spec = os.path.join(tmp_dir, f"mesh-{self.tag}.pkl")
        self.out = os.path.join(tmp_dir, f"mesh-{self.tag}.out.pkl")
        self.log = os.path.join(tmp_dir, f"mesh-{self.tag}.log")
        with open(self.spec, "wb") as f:
            pickle.dump(cases, f)
        self.deadline = time.monotonic() + deadline_s
        env = {**os.environ, TAG_VAR: self.tag, "OMP_NUM_THREADS": "1"}
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--world", str(world), "--spec",
             self.spec, "--out", self.out, "--timeout", str(timeout_s)],
            stdout=open(self.log, "w"), stderr=subprocess.STDOUT, env=env,
            start_new_session=True)
        self._results = None

    def results(self) -> tuple[int, list]:
        """(exit code, the cases' results)."""
        if self._results is None:
            try:
                code = self.proc.wait(timeout=max(1.0, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                code = None
            finally:
                self.reap()
            res = []
            if os.path.exists(self.out):
                with open(self.out, "rb") as f:
                    res = pickle.load(f)
            if code is None:
                raise AssertionError(f"world past its deadline; log:\n{self.log_text()}")
            self._results = (code, res)
        return self._results

    def log_text(self) -> str:
        with open(self.log) as f:
            return f.read()[-6000:]

    def reap(self) -> None:
        """Kill the script's process group and this run's rank processes."""
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait()
        reap_tag(self.tag)


def reap_tag(tag: str) -> None:
    """SIGKILL every process whose environment carries ``TAG_VAR=tag``."""
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if f"{TAG_VAR}={tag}".encode() in f.read():
                    os.kill(int(pid), signal.SIGKILL)
        except (OSError, ProcessLookupError):
            pass


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def run_engine(world: World, case: dict) -> dict:
    from llmd_tpu_torch.engine.engine import LLMEngine
    from llmd_tpu_torch.models.transformer import params_from_numpy

    cfg = case["model_cfg"]
    params = (params_from_numpy(cfg, case["params"]) if case.get("params") is not None
              else None)
    eng = LLMEngine(cfg, case["engine_cfg"], params=params, device="cpu",
                    rank_mesh=world.mesh(case["mesh"]))
    eng._op_log = []
    try:
        out, ring = [], []
        sp = SamplingParams(max_tokens=case.get("max_tokens", 6),
                            temperature=case.get("temperature", 0.0))
        for phase in case["phases"]:
            got = {}
            for i, p in enumerate(phase):
                eng.add_request(f"r{len(out)}-{i}", p, sp, rank=i % eng.num_ranks)
            while eng.has_work():
                for o in eng.step():
                    got.setdefault(o.request_id, []).extend(o.new_token_ids)
            out.append([got[f"r{len(out)}-{i}"] for i in range(len(phase))])
            ring.append(eng.stats.n_ring_prefill_steps)
        embeds = [eng.embed(ids) for ids in case.get("embed", ())]
        logs = world.oplogs()
        mine, theirs = world.engine_call("llmd_tpu_torch.parallel.checks:row_log", eng)
        st = eng.stats
        return {"tokens": out, "ring_steps": ring, "embeds": embeds,
                "agree": all(_same(eng._op_log, w) for w in logs) and len(eng._op_log) > 0,
                "n_ops": len(eng._op_log), "row_logs": [mine, *theirs],
                "coords": [rank_coords(case["mesh"], r) for r in range(world.size)],
                "pools_equal": pools_equal(world, eng),
                "stats": {k: getattr(st, k) for k in (
                    "sp_attn_backend", "moe_dispatch", "moe_dropped_tokens",
                    "eplb_rebalances", "kv_cache_dtype", "n_decode_dispatches",
                    "spec_drafted", "spec_accepted", "n_spec_verify_steps",
                    "total_offload_loads")},
                "fallback": eng.moe_dispatch_fallback_reason}
    finally:
        eng.close()


def pools_equal(world: World, eng) -> bool:
    """Every rank's pool pages (their bytes) equal those of the rank of rank
    0's tp group at its tp index (ranks 0..tp-1): the pool is whole on every
    dp / sp / ep replica."""
    pids = list(range(eng.cfg.num_pages))
    mine, theirs = world.engine_call("llmd_tpu_torch.parallel.checks:pool_pages", eng, pids=pids)
    pools = [mine, *theirs]
    cfg = eng.cfg.mesh
    return all(np.array_equal(p, pools[rank_coords(cfg, r)["tp"]]) for r, p in enumerate(pools))


def rows_as_planned(res: dict, mesh: MeshConfig) -> list:
    """Every op of a meshed engine case against the reference's row
    binding, from the ranks' row logs: the rank at (d, s) of a flat program
    (unified, verify, verify_masked, embed) of n rows ran n // (dp*sp) rows,
    one more when d*sp + s < n % (dp*sp), the (dp, sp) parts' rows summing to
    n; a decode program ran ceil(B / dp) slots; a ring step of n rows its
    zig-zag share, n padded to 2*sp, over sp. Every rank logged the same
    programs and step sizes. Returns the mismatches (empty: as planned)."""
    logs, coords = res["row_logs"], res["coords"]
    bad = []
    if len({len(log) for log in logs}) != 1:
        return [("op counts", [len(log) for log in logs])]
    parts = mesh.dp * mesh.sp
    for j, entry in enumerate(logs[0]):
        prog, n = entry[0], entry[1]
        sums: dict = {}
        for log, c in zip(logs, coords):
            if tuple(log[j][:2]) != (prog, n):
                bad.append((j, "step", log[j], entry))
                continue
            p = c["dp"] * mesh.sp + c["sp"]
            if prog in ("decode", "decode_masked"):
                want = -(-n // mesh.dp)
            elif prog == "unified_ring":
                want = (n + (-n) % (2 * mesh.sp)) // mesh.sp
            else:
                want = n // parts + (1 if p < n % parts else 0)
                sums[p] = log[j][2]
            if log[j][2] != want:
                bad.append((j, prog, n, c, log[j][2], want))
        if sums and sum(sums.values()) != n:
            bad.append((j, prog, n, "sum", sums))
    return bad


def run_actions(eng, actions: list, world=None, results=()) -> list:
    """Run ``actions`` on engine ``eng`` (on ``world`` when meshed); one
    result per action:

    - ``("load", name, weights)`` / ``("unload", name)``: the adapter calls;
    - ``("run", [(rid, prompt, sampling kwargs, add_request kwargs)])``:
      every request added, the engine stepped until idle: {rid: (tokens,
      finish reason, cached prompt tokens)};
    - ``("slot", slot)``: ``checks.lora_slot_sums`` on every rank;
    - ``("export", rid, prompt)``: the resident prefix of ``prompt`` through
      ``export_from_engine`` and a KVT1 pull on loopback: (header, payload,
      each rank's planes of the exported pages as bytes);
    - ``("inject", case, engine, action, prompt)``: an earlier case's export
      pulled into this engine: blocks injected;
    - ``("stats", keys)``: those ``EngineStats`` fields, the offload store's
      saves / loads / demotions and the connector's stats;
    - ``("flush",)``: the durable tier's queue drained and its worker
      stopped (no more offers), its counts;
    - ``("programs",)``: the program ledger's counters.

    ``EngineConfig(kv_connector="shared")`` names one in-memory connector
    shared by every engine of the run (a store that outlives an engine).
    """
    from llmd_tpu_torch.disagg import transfer as ttr
    from llmd_tpu_torch.parallel import checks

    out = []
    for act in actions:
        kind = act[0]
        if kind == "load":
            out.append(eng.load_lora_adapter(act[1], act[2]))
        elif kind == "unload":
            out.append(eng.unload_lora_adapter(act[1]))
        elif kind == "run":
            got: dict = {}
            for rid, prompt, skw, akw in act[1]:
                eng.add_request(rid, list(prompt), SamplingParams(**skw), **akw)
                got[rid] = ([], None, 0)
            steps = 0
            while eng.has_work():
                for o in eng.step():
                    toks, _, _ = got[o.request_id]
                    got[o.request_id] = (toks + list(o.new_token_ids), o.finish_reason,
                                         o.num_cached_prompt_tokens)
                steps += 1
                assert steps < 3000, "no forward progress"
            if eng._connector_pool is not None:  # retire-time saves are async
                eng._connector_pool.submit(lambda: None).result()
            out.append(got)
        elif kind == "slot":
            fn = "llmd_tpu_torch.parallel.checks:lora_slot_sums"
            out.append(world.engine_call(fn, eng, slot=act[1]) if world is not None
                       else (checks.lora_slot_sums(eng, act[1]), []))
        elif kind == "export":
            src = ttr.KVTransferSource(host="127.0.0.1", transport="python")
            src.start()
            try:
                ttr.export_from_engine(eng, src, act[1], list(act[2]))
                hdr, payload = ttr.KVTransferClient(timeout_s=10)._request(
                    "127.0.0.1", src.port, {"op": "pull", "id": act[1]})
            finally:
                src.stop()
            pids = [eng.alloc.cached[h] for h in hdr.get("block_hashes", [])]
            planes = []
            if world is not None and pids:
                mine, theirs = world.engine_call("llmd_tpu_torch.parallel.checks:pool_pages",
                                                 eng, pids=pids)
                planes = [mine, *theirs]
            out.append((hdr, bytes(payload), planes))
        elif kind == "inject":
            hdr, payload, _ = results[act[1]][act[2]][act[3]]
            pulled = ttr.KVTransferClient._decode(hdr, bytearray(payload))
            out.append(ttr.inject_into_engine(eng, pulled, list(act[4])))
        elif kind == "stats":
            st = eng.stats
            res = {k: getattr(st, k) for k in act[1]}
            if eng.offload is not None:
                store = eng.offload.store
                res["offload"] = (store.saves, store.loads, store.demotions)
            if eng.kv_connector is not None:
                res["connector"] = dict(getattr(eng.kv_connector, "stats", {}))
            out.append(res)
        elif kind == "flush":  # the durable queue drained: its counts
            wb = eng.writeback
            wb.flush_for_drain(10.0)
            wb.stop()  # the worker's put in flight lands before the counts are read
            assert not wb._thread.is_alive(), "the write-back worker did not stop"
            out.append(dict(wb.counts))
        elif kind == "programs":
            out.append(eng.programs.counters())
        else:
            raise ValueError(f"unknown action {kind!r}")
    return out


def run_script(world: World, case: dict, results: list) -> dict:
    from llmd_tpu_torch.engine.engine import LLMEngine
    from llmd_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmd_tpu_torch.models.transformer import params_from_numpy

    cfg = case["model_cfg"]
    params = (params_from_numpy(cfg, case["params"]) if case.get("params") is not None
              else None)
    tok = ByteTokenizer() if case.get("tokenizer") else None
    res: dict = {}
    engines = [("mesh", case["engine_cfg"], case["mesh"])]
    if case.get("twin"):
        engines.append(("twin", dataclasses.replace(case["engine_cfg"], mesh=MeshConfig()), None))
    for name, ecfg, mesh in engines:
        events: list = []
        saved = {k: os.environ.get(k) for k in case.get("env", {})}
        os.environ.update(case.get("env", {}))
        try:
            eng = LLMEngine(cfg, ecfg, params=params, device="cpu", tokenizer=tok,
                            event_sink=events.extend,
                            rank_mesh=world.mesh(mesh) if mesh is not None else None)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        try:
            if mesh is not None:
                eng._op_log = []
            res[name] = run_actions(eng, case["actions"], world if mesh is not None else None,
                                    results)
            res[name + "_events"] = [(type(e).__name__, list(getattr(e, "block_hashes", [])),
                                      getattr(e, "parent_block_hash", None),
                                      getattr(e, "medium", None), getattr(e, "lora_id", None))
                                     for e in events]
            if mesh is not None:
                logs = world.oplogs()
                res["agree"] = all(_same(eng._op_log, w) for w in logs) and len(eng._op_log) > 0
        finally:
            eng.close()
    return res


def run_group(world: World, case: dict) -> dict:
    from llmd_tpu_torch.engine.dp_group import WideEPEngineGroup

    group = WideEPEngineGroup(case["model_cfg"], case["engine_cfg"],
                              model_name="llmd-tpu/" + case["model_cfg"].name, device="cpu",
                              rank_mesh=world.mesh(case["mesh"]))
    group.start()
    try:
        res = []
        for ep, prompt in zip(group.endpoints(), case["prompts"]):
            body = json.dumps({"model": "llmd-tpu/" + case["model_cfg"].name,
                               "prompt": prompt, "max_tokens": 3,
                               "temperature": 0}).encode()
            req = urllib.request.Request(f"http://{ep}/v1/completions", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                res.append((r.status, json.loads(r.read())["usage"]["completion_tokens"]))
        return {"endpoints": group.endpoints(), "answers": res,
                "ranks": group.ranks, "decode_tokens": group.engine.stats.total_decode_tokens}
    finally:
        group.stop()


def run_kill(world: World, case: dict) -> dict:
    world.mesh(case["mesh"])
    os.kill(world.pids[0], signal.SIGKILL)
    t0 = time.monotonic()
    try:
        world.call("llmd_tpu_torch.parallel.checks:ring_prefill",
                   q=np.zeros((8, 2, 4), np.float32), k=np.zeros((8, 1, 4), np.float32),
                   v=np.zeros((8, 1, 4), np.float32))
        err = None
    except Exception as e:  # noqa: BLE001 — what rank 0 raised is the result
        err = f"{type(e).__name__}: {e}"
    return {"error_raised": err, "seconds": time.monotonic() - t0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args()
    torch.set_num_threads(1)
    from llmd_tpu_torch.kv.connector_api import InMemoryKVConnector, register_kv_connector

    shared = InMemoryKVConnector()
    register_kv_connector("shared", lambda params: shared)
    with open(args.spec, "rb") as f:
        cases = pickle.load(f)
    world = World.start(args.world, "cpu", timeout_s=args.timeout)
    world.record_ops = True
    results = []
    try:
        for case in cases:
            t0 = time.monotonic()
            try:
                if case["kind"] == "engine":
                    res = run_engine(world, case)
                elif case["kind"] == "group":
                    res = run_group(world, case)
                elif case["kind"] == "kill":
                    res = run_kill(world, case)
                elif case["kind"] == "script":
                    res = run_script(world, case, results)
                else:
                    world.mesh(case["mesh"])
                    mine, theirs = world.call(case["fn"], **case["kw"])
                    res = {"result": mine, "agree": all(_same(mine, t) for t in theirs)}
            except Exception as e:  # noqa: BLE001 — reported per case
                traceback.print_exc()
                res = {"error": f"{type(e).__name__}: {e}"}
            res["seconds"] = res.get("seconds", time.monotonic() - t0)
            results.append(res)
            if "error" in res or case["kind"] == "kill":
                break  # a failed world runs nothing more
    finally:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
        world.close()
    return 0 if all("error" not in r and "error_raised" not in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
