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
  ``temperature``), then ``embed``'s token lists through ``LLMEngine.embed``,
  then each of ``refuse``'s requests (add_request keywords and ``sampling``),
  whose ``NotImplementedError`` texts are reported.
  Result: each phase's tokens and the ring steps after it, the embeddings,
  the engine's stats, and whether every rank's device ops gave rank 0's
  tokens.
- ``{"kind": "call", "mesh", "fn", "kw"}``: ``fn(mesh, **kw)`` on every rank
  (``llmd_tpu_torch.parallel.checks``); rank 0's result and whether the
  workers' equal it.
- ``{"kind": "group", "mesh", "model_cfg", "engine_cfg", "prompts"}``: a
  ``WideEPEngineGroup`` over the world; one completion posted to each rank
  port. Result: (status, completion tokens) per port.
- ``{"kind": "kill", "mesh"}``: rank 1's process is killed, then a call runs:
  the error rank 0 raised and the seconds it took. Ends the world.

Each case's result is a dict, or ``{"error": text}``; the script exits 1
when a case failed or a rank was killed. Tests start it through
:class:`WorldRun`, which bounds it by a deadline and kills what is left of
it (the script, and every rank process carrying its tag) when done.
"""

import argparse
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
        refused = []  # what a meshed engine refuses, by its message
        for kw in case.get("refuse", ()):
            try:
                eng.add_request(f"refused-{len(refused)}", [3, 4, 5],
                                SamplingParams(**kw.get("sampling", {})),
                                **{k: v for k, v in kw.items() if k != "sampling"})
                refused.append(None)
            except NotImplementedError as e:
                refused.append(str(e))
        logs = world.oplogs()
        st = eng.stats
        return {"tokens": out, "ring_steps": ring, "embeds": embeds, "refused": refused,
                "agree": all(_same(eng._op_log, w) for w in logs) and len(eng._op_log) > 0,
                "n_ops": len(eng._op_log),
                "stats": {k: getattr(st, k) for k in (
                    "sp_attn_backend", "moe_dispatch", "moe_dropped_tokens",
                    "eplb_rebalances", "kv_cache_dtype", "n_decode_dispatches",
                    "spec_drafted", "spec_accepted", "n_spec_verify_steps")},
                "fallback": eng.moe_dispatch_fallback_reason}
    finally:
        eng.close()


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
