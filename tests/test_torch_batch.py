"""The port's batch plane (``llmd_tpu_torch/batch``: the OpenAI Batch gateway on
``router/http.py`` and the async processor) against the reference's aiohttp
one, on the CPU.

- **The gateway.** One script through the reference's ``BatchGateway`` in
  front of the reference's fake server, and the same script through the port's
  in front of the port's fake server (the two fake servers answer alike,
  ``tests/test_torch_fake_server.py``): a recovery scan over a store left with
  rows ``in_progress``, ``cancelling`` and ``finalizing``; a raw and a
  multipart upload of the same bytes; create, get, list, cancel; a JSONL file
  with invalid lines; a batch whose requests the server refuses with 429
  (seeded faults); a batch past its completion window; a missing file, a wrong
  bearer key, another tenant; the output and error files' bytes; the GC of
  aged batches. Every step's (status, content type, body) is equal. One fake
  clock and one id counter per module are patched into both packages' batch
  and fake-server modules; a run is held at the gateway's global semaphore to
  cancel it or let its window pass, never by sleeping out a window.
- **Port only.** A malformed multipart body answers 400; a transport error
  becomes the line's error; a stopped gateway leaves its run ``in_progress``
  and a new gateway over the same store and files completes it.
- **The async processor.** Against the reference's under one fake clock (an
  ``asyncio`` whose ``sleep`` advances it) and one seed: the memory puller's
  priority order, the spool's claim and survival, ``BudgetGate`` pacing, retry
  counts and their backoff, fatal 4xx, deadline expiry and propagation,
  ``stats``; the saturation and budget gates over the port's fake ``/metrics``.
"""

import asyncio
import itertools
import json
import os
import random

import aiohttp
import pytest

import llmd_tpu.batch.async_processor as ref_ap
import llmd_tpu.batch.files as ref_files
import llmd_tpu.batch.gateway as ref_gw
import llmd_tpu.batch.store as ref_store
import llmd_tpu.testing.fake_server as ref_fake
import llmd_tpu_torch.batch.async_processor as port_ap
import llmd_tpu_torch.batch.files as port_files
import llmd_tpu_torch.batch.gateway as port_gw
import llmd_tpu_torch.batch.store as port_store
import llmd_tpu_torch.testing.fake_server as port_fake
from llmd_tpu_torch.router.http import HTTPServer, json_response
from tests.conftest import run_async

REF = dict(gw=ref_gw, store=ref_store, files=ref_files, fake=ref_fake, ap=ref_ap)
PORT = dict(gw=port_gw, store=port_store, files=port_files, fake=port_fake, ap=port_ap)
KEY = {"Authorization": "Bearer sk-test"}
ALICE = {**KEY, "x-llm-d-tenant": "alice"}
BOB = {**KEY, "x-llm-d-tenant": "bob"}


class Clock:
    def __init__(self) -> None:
        self.t = 5000.0

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return self.t


class _Ids:
    """``uuid.uuid4().hex`` as a counter."""

    def __init__(self) -> None:
        self._n = itertools.count(1)

    def uuid4(self):
        class _U:
            hex = f"{next(self._n):08x}" * 4  # distinct in its first 12 and 16

        return _U()


class _Asyncio:
    """``asyncio`` whose ``sleep`` advances ``clock`` (and is recorded)
    instead of waiting: a backoff or a pacing delay reads off the fake clock.
    A sleep lasts at least a microsecond, as a real loop's timer does, so a
    delay below the clock's float step (a token bucket's last 1e-17 of a
    token) still moves it."""

    def __init__(self, clock: Clock) -> None:
        self.clock = clock
        self.sleeps: list[float] = []

    def __getattr__(self, name):
        return getattr(asyncio, name)

    async def sleep(self, delay, result=None):
        self.sleeps.append(delay)
        self.clock.t += max(delay, 1e-6)
        await asyncio.sleep(0)
        return result


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock per package, and one id counter per module."""
    out = {}
    for side in (REF, PORT):
        clock = out[side["gw"].__name__] = Clock()
        for name in ("gw", "store", "files", "fake", "ap"):
            monkeypatch.setattr(side[name], "time", clock)
            if name != "ap":
                monkeypatch.setattr(side[name], "uuid", _Ids())
    return out


def _line(cid, prompt, model="fake/model", url="/v1/completions", **body):
    return json.dumps({"custom_id": cid, "method": "POST", "url": url,
                       "body": {"model": model, "prompt": prompt, "max_tokens": 3,
                                **body}})


def _jsonl(n, tag, model="fake/model"):
    return "\n".join(_line(f"{tag}-{i}", f"{tag} prompt number {i}", model)
                     for i in range(n)).encode()


MIXED = "\n".join([
    _line("ok-0", "the first valid line"),
    "this line is not json",
    json.dumps({"method": "POST", "url": "/v1/completions", "body": {}}),  # no custom_id
    _line("ok-0", "a duplicate id"),
    _line("bad-url", "x", url="/v1/nope"),
    json.dumps({"custom_id": "no-body", "url": "/v1/completions"}),
    json.dumps({"custom_id": "get", "method": "GET", "url": "/v1/completions", "body": {}}),
    "",
    json.dumps({"custom_id": "chat-1", "method": "POST", "url": "/v1/chat/completions",
                "body": {"model": "fake/model", "max_tokens": 2,
                         "messages": [{"role": "user", "content": "hi there"}]}}),
    json.dumps({"custom_id": "emb-1", "method": "POST", "url": "/v1/embeddings",
                "body": {"model": "fake/model", "input": ["a", "bb"]}}),
    _line("ok-1", "the last valid line"),
]).encode()


def _multipart(data: bytes, filename: str, purpose: str = "batch") -> tuple[bytes, str]:
    """A multipart/form-data body by hand: a preamble, a quoted boundary, a
    file part, an unquoted-parameter purpose part and an epilogue."""
    b = "llmd-batch-7d1f"
    body = (b"this preamble is ignored\r\n"
            + f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
              f"filename=\"{filename}\"\r\nContent-Type: application/jsonl\r\n\r\n".encode()
            + data
            + f"\r\n--{b}\r\nContent-Disposition: form-data; name=purpose\r\n\r\n"
              f"{purpose}\r\n--{b}--\r\nand so is this epilogue\r\n".encode())
    return body, f'multipart/form-data; boundary="{b}"'


async def _call(sess, gw, method, path, headers=None, **kw):
    async with sess.request(method, f"http://{gw.address}{path}", headers=headers or {},
                            **kw) as r:
        data = await r.read()
        if r.content_type == "application/json":
            return r.status, r.content_type, json.loads(data)
        return r.status, r.content_type, data


async def _until(cond, what, timeout_s=20.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while not cond():
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.005)


async def _gateway_script(side: dict, clock: Clock, root) -> list:
    """The script through ``side``'s gateway and fake server: every step's
    (status, content type, body), the recovered rows, stats at the end."""
    files_root, db = str(root / "files"), str(root / "batches.db")
    # a store a crashed gateway left behind: three non-terminal rows
    fs = side["files"].FileStore(files_root)
    meta = fs.put("alice", "in.jsonl", _jsonl(2, "rec"))
    store = side["store"].BatchStore(db)
    left = {}
    for status in ("in_progress", "cancelling", "finalizing"):
        row = store.create("alice", meta.id, "/v1/completions")
        row.status = status
        row.completed = 1  # partial progress a re-run must not double-count
        store.update(row)
        left[status] = row.id
        clock.t += 1
    store.db.close()

    fake = side["fake"].FakeModelServer(side["fake"].FakeServerConfig(
        prefill_us_per_token=0.0, decode_us_per_token=0.0, kv_pull_us_per_block=0.0))
    await fake.start()
    gw = side["gw"].BatchGateway(side["gw"].BatchGatewayConfig(
        target_url=f"http://{fake.address}", files_root=files_root, store_path=db,
        global_concurrency=1, per_model_concurrency=1, api_key="sk-test",
        gc_interval_s=0.02))
    await gw.start()
    out: list = [("recovered", gw.stats["recovered"])]
    try:
        await _until(lambda: all(gw.store.get(i).status in ("completed", "cancelled", "failed")
                                 for i in left.values()), "the recovered rows")
        async with aiohttp.ClientSession() as s:
            async def call(*a, **k):
                out.append(await _call(s, gw, *a, **k))
                return out[-1][2]

            async def wait_status(bid, want, headers=ALICE):
                await _until(lambda: gw.store.get(bid).status in want, f"{bid} in {want}")
                return await call("GET", f"/v1/batches/{bid}", headers)

            for bid in left.values():
                await call("GET", f"/v1/batches/{bid}", ALICE)
            await call("GET", "/health")
            await call("GET", "/nope")
            await call("GET", "/v1/files", ALICE)  # 405: no such method on the route
            # auth and uploads
            await call("POST", "/v1/files", data=_jsonl(2, "x"))  # no key: 401
            await call("POST", "/v1/files", {"Authorization": "Bearer wrong"},
                       data=_jsonl(2, "x"))
            raw = await call("POST", "/v1/files?filename=raw.jsonl&purpose=batch", ALICE,
                             data=_jsonl(3, "raw"))
            body, ctype = _multipart(_jsonl(3, "raw"), "multi part.jsonl")
            multi = await call("POST", "/v1/files", {**ALICE, "Content-Type": ctype},
                               data=body)
            await call("POST", "/v1/files", ALICE, data=b"")  # empty: 400
            await call("GET", f"/v1/files/{multi['id']}", ALICE)
            await call("GET", f"/v1/files/{multi['id']}/content", ALICE)
            await call("GET", f"/v1/files/{multi['id']}", BOB)  # another tenant: 404
            await call("GET", f"/v1/files/{multi['id']}/content", BOB)
            await call("GET", "/v1/files/file-0000/content", ALICE)
            await call("GET", "/v1/files/..secret/content", ALICE)
            await call("DELETE", f"/v1/files/{raw['id']}", BOB)
            await call("DELETE", f"/v1/files/{raw['id']}", ALICE)
            await call("DELETE", f"/v1/files/{raw['id']}", ALICE)
            # batches: refusals
            await call("POST", "/v1/batches", ALICE, data=b"{not json")
            await call("POST", "/v1/batches", ALICE, json={"input_file_id": "file-missing"})
            await call("POST", "/v1/batches", BOB, json={"input_file_id": multi["id"]})
            await call("POST", "/v1/batches", {"Authorization": "Bearer wrong"},
                       json={"input_file_id": multi["id"]})
            # the multipart file as a batch, to the end
            clock.t += 1
            b1 = await call("POST", "/v1/batches", ALICE, json={
                "input_file_id": multi["id"], "endpoint": "/v1/completions",
                "metadata": {"job": "nightly"}, "priority": 2})
            done = await wait_status(b1["id"], ("completed", "failed"))
            await call("GET", f"/v1/files/{done['output_file_id']}/content", ALICE)
            await call("GET", f"/v1/batches/{b1['id']}", BOB)
            # invalid lines beside valid ones; the server refuses half with 429
            clock.t += 1
            mixed = await call("POST", "/v1/files?filename=mixed.jsonl", ALICE, data=MIXED)
            fake.set_faults(error_rate=0.5, error_status=429, seed=3)
            b2 = await call("POST", "/v1/batches", ALICE, json={"input_file_id": mixed["id"]})
            done = await wait_status(b2["id"], ("completed", "failed"))
            fake.set_faults(error_rate=0.0)
            for key in ("output_file_id", "error_file_id"):
                await call("GET", f"/v1/files/{done[key]}/content", ALICE)
            # a file of nothing valid fails the batch
            clock.t += 1
            junk = await call("POST", "/v1/files?filename=junk.jsonl", ALICE,
                              data=b"garbage\nmore garbage")
            b3 = await call("POST", "/v1/batches", ALICE, json={"input_file_id": junk["id"]})
            await wait_status(b3["id"], ("failed",))
            # cancel: the run held at the global semaphore, cancelled there
            clock.t += 1
            f4 = await call("POST", "/v1/files?filename=c.jsonl", ALICE, data=_jsonl(4, "cn"))
            await gw._global_sem.acquire()
            b4 = await call("POST", "/v1/batches", ALICE, json={"input_file_id": f4["id"]})
            await wait_status(b4["id"], ("in_progress",))
            await call("POST", f"/v1/batches/{b4['id']}/cancel", ALICE)
            gw._global_sem.release()
            await wait_status(b4["id"], ("cancelled",))
            await call("POST", f"/v1/batches/{b4['id']}/cancel", ALICE)  # terminal: kept
            await call("POST", "/v1/batches/batch_nope/cancel", ALICE)
            await call("POST", f"/v1/batches/{b4['id']}/cancel", BOB)
            # expiry: the run held while the clock passes its completion window
            clock.t += 1
            b5 = None
            await gw._global_sem.acquire()
            b5 = await call("POST", "/v1/batches", ALICE, json={
                "input_file_id": f4["id"], "completion_window": "10s"})
            await wait_status(b5["id"], ("in_progress",))
            clock.t += 20
            gw._global_sem.release()
            done = await wait_status(b5["id"], ("failed",))
            await call("GET", f"/v1/files/{done['error_file_id']}/content", ALICE)
            await call("GET", "/v1/batches", ALICE)
            await call("GET", "/v1/batches", BOB)
            # GC: every terminal row past the retention window goes
            clock.t += 31 * 24 * 3600
            await _until(lambda: gw.store.get(b5["id"]) is None, "the GC pass")
            await call("GET", f"/v1/batches/{b1['id']}", ALICE)
            await call("GET", "/v1/batches", ALICE)
        out.append(("stats", dict(gw.stats)))
    finally:
        await gw.stop()
        await fake.stop()
    return out


def test_gateway_answers_as_the_reference(tmp_path, clocks):
    want = run_async(_gateway_script(REF, clocks[ref_gw.__name__], tmp_path / "ref"))
    got = run_async(_gateway_script(PORT, clocks[port_gw.__name__], tmp_path / "port"))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, (i, a, b)
    # the script reached what it meant to: recovery, both uploads, the 429s,
    # an error file, a cancel, an expiry, the GC
    assert want[0] == ("recovered", 3)
    steps = [s for s in want if len(s) == 3]
    assert {200, 400, 401, 404, 405} <= {s[0] for s in steps}
    text = b"".join(s[2] for s in steps if isinstance(s[2], bytes))
    assert b"HTTP 429" in text and b"completion window expired" in text
    stats = want[-1][1]
    assert stats["requests_failed"] > 0 and stats["gc_deleted"] >= 5


def test_malformed_multipart_answers_400(tmp_path):
    async def scenario():
        gw = port_gw.BatchGateway(port_gw.BatchGatewayConfig(
            target_url="http://127.0.0.1:9", files_root=str(tmp_path / "f"),
            store_path=":memory:"))
        await gw.start()
        good, ctype = _multipart(b'{"x": 1}', "a.jsonl")
        cases = [
            (good, "multipart/form-data"),  # no boundary
            (good, 'multipart/form-data; boundary="unterminated'),
            (good, "multipart/form-data; boundary=other"),  # no delimiter line
            (good.replace(b"--llmd-batch-7d1f--", b""), ctype),  # no close delimiter
            (good.replace(b"\r\n\r\n", b"\r\n", 1), ctype),  # headers never end
            (good.replace(b"llmd-batch-7d1f\r\nContent", b"llmd-batch-7d1fXContent", 1), ctype),
            (b"", ctype),
        ]
        try:
            async with aiohttp.ClientSession() as s:
                got = [await _call(s, gw, "POST", "/v1/files", {"Content-Type": c}, data=b)
                       for b, c in cases]
                ok = await _call(s, gw, "POST", "/v1/files", {"Content-Type": ctype},
                                 data=good)
        finally:
            await gw.stop()
        assert [g[0] for g in got] == [400] * len(cases), got
        assert all("malformed multipart" in g[2]["error"] for g in got)
        assert ok[0] == 200 and ok[2]["filename"] == "a.jsonl" and ok[2]["bytes"] == 8

    run_async(scenario())


def test_transport_errors_become_error_lines_and_a_stopped_run_recovers(tmp_path):
    """A dead target: every line carries the transport error, the batch
    fails, nothing escapes. Then a run stopped mid-flight stays
    ``in_progress`` on disk, and a new gateway over the same store and files
    completes it."""

    async def scenario():
        root, db = str(tmp_path / "files"), str(tmp_path / "b.db")
        dead = port_gw.BatchGateway(port_gw.BatchGatewayConfig(
            target_url="http://127.0.0.1:9", files_root=root, store_path=db,
            request_timeout_s=5.0))
        await dead.start()
        meta = dead.files.put("default", "in.jsonl", _jsonl(2, "dead"))
        row = dead.store.create("default", meta.id, "/v1/completions")
        dead._enqueue(row)
        await _until(lambda: dead.store.get(row.id).status == "failed", "the dead batch")
        err = json.loads(dead.files.get_content(
            "default", dead.store.get(row.id).error_file_id).splitlines()[0])
        assert err["response"] is None and err["error"]["message"].startswith(
            ("ConnectionRefusedError", "OSError")), err
        assert dead.stats["requests_failed"] == 2
        await dead.stop()

        fake = port_fake.FakeModelServer(port_fake.FakeServerConfig(
            prefill_us_per_token=0.0, decode_us_per_token=0.0))
        await fake.start()
        cfg = port_gw.BatchGatewayConfig(target_url=f"http://{fake.address}",
                                         files_root=root, store_path=db,
                                         global_concurrency=1)
        first = port_gw.BatchGateway(cfg)
        await first.start()
        meta = first.files.put("default", "in.jsonl", _jsonl(3, "crash"))
        await first._global_sem.acquire()  # the run waits for a dispatch slot
        row = first.store.create("default", meta.id, "/v1/completions")
        first._enqueue(row)
        await _until(lambda: first.store.get(row.id).status == "in_progress", "in_progress")
        await first.stop()
        assert port_store.BatchStore(db).get(row.id).status == "in_progress"
        second = port_gw.BatchGateway(cfg)
        await second.start()
        try:
            assert second.stats["recovered"] == 1
            await _until(lambda: second.store.get(row.id).status == "completed", "recovery")
            done = second.store.get(row.id)
            assert (done.total, done.completed, done.failed) == (3, 3, 0)
            assert fake.request_count == 3
        finally:
            await second.stop()
            await fake.stop()

    run_async(scenario())


# -- the async processor ---------------------------------------------------------
async def _upstream(log: list):
    """A scripted upstream: an item's body names the status of each attempt
    (the last repeats); the deadline header is logged."""
    attempts: dict = {}

    async def handler(request):
        body = await request.json()
        n = attempts[body["id"]] = attempts.get(body["id"], 0) + 1
        log.append((body["id"], n, request.headers.get("x-llm-d-deadline")))
        status = body["script"][min(n, len(body["script"])) - 1]
        return json_response({"id": body["id"], "attempt": n}, status=status)

    srv = HTTPServer()
    srv.add_route("POST", "/v1/completions", handler)
    await srv.start("127.0.0.1", 0)
    return srv


async def _processor_script(side: dict, clock: Clock, aio: _Asyncio, spool) -> dict:
    ap = side["ap"]
    out: dict = {}
    q = ap.MemoryQueuePuller()
    for name, prio in (("low", 0), ("high", 10), ("mid", 5), ("high2", 10), ("low2", 0)):
        await q.put(ap.AsyncItem(id=name, url="/v1/completions", body={}, priority=prio))
    out["priority_order"] = [(await q.get()).id for _ in range(5)]
    q.nack(ap.AsyncItem(id="nacked", url="/x", body={}))  # requeued by a task
    out["nacked"] = (await q.get()).id

    os.makedirs(spool)
    for name, d in (("b.json", {"id": "b", "body": {"prompt": "b"}, "priority": 2}),
                    ("a.json", {"id": "a", "url": "/v1/chat/completions", "deadline": 9e9}),
                    ("junk.txt", {"id": "junk"})):
        with open(os.path.join(spool, name), "w") as f:
            json.dump(d, f)
    with open(os.path.join(spool, "0bad.json"), "w") as f:
        f.write("{not json")
    sp = ap.FileSpoolPuller(spool, poll_interval_s=0.25)
    got = [await sp.get(), await sp.get()]
    sp.nack(got[1])
    out["spool_after_nack"] = sorted(os.listdir(spool))
    restarted = ap.FileSpoolPuller(spool, poll_interval_s=0.25)  # a new process
    got.append(await restarted.get())
    out["spool_items"] = [(i.id, i.url, i.body, i.priority, i.deadline) for i in got]
    out["spool_left"] = sorted(os.listdir(spool))

    t0, n0 = clock.t, len(aio.sleeps)
    gate = ap.BudgetGate(rate=50.0, burst=2.0)
    for _ in range(6):
        await gate.acquire()
    out["budget_elapsed"] = round(clock.t - t0, 9)
    out["budget_sleeps"] = [round(s, 9) for s in aio.sleeps[n0:]]

    log: list = []
    up = await _upstream(log)
    results: list = []
    # the port's jitter: a generator of its own, seeded from the config
    seed = {"seed": 7} if "seed" in ap.AsyncProcessorConfig.__dataclass_fields__ else {}
    proc = ap.AsyncProcessor(
        ap.AsyncProcessorConfig(target_url=f"http://127.0.0.1:{up.port}", num_workers=1,
                                max_attempts=3, backoff_base_s=0.5, backoff_max_s=1.5,
                                request_timeout_s=10.0, **seed),
        q, on_result=lambda item, res: results.append((item.id, item.attempts, res)))
    random.seed(7)  # the reference's jitter: the global generator
    n0 = len(aio.sleeps)
    await proc.start()
    try:
        items = [("ok", [200], None), ("flaky", [503, 502, 200], None),
                 ("dead", [503], None), ("fatal", [404], None), ("unprocessable", [422], None),
                 ("expired", [200], clock.t - 1), ("deadlined", [200], clock.t + 30),
                 ("throttled", [429, 200], None)]
        for prio, (name, script, deadline) in enumerate(items):
            await q.put(ap.AsyncItem(id=name, url="/v1/completions",
                                     body={"id": name, "script": script},
                                     priority=-prio, deadline=deadline))
        await _until(lambda: len(results) == len(items), "every item")
    finally:
        await proc.stop()
        await up.stop()
    out["results"] = results
    out["upstream"] = log
    out["backoffs"] = aio.sleeps[n0:]
    out["stats"] = dict(proc.stats)
    return out


def test_async_processor_runs_as_the_reference(tmp_path, clocks, monkeypatch):
    outs = []
    for side, tag in ((REF, "ref"), (PORT, "port")):
        clock = clocks[side["gw"].__name__]
        aio = _Asyncio(clock)
        monkeypatch.setattr(side["ap"], "asyncio", aio)
        outs.append(run_async(_processor_script(side, clock, aio, str(tmp_path / tag))))
    want, got = outs
    assert got == want
    assert want["priority_order"] == ["high", "high2", "mid", "low", "low2"]
    assert [i[0] for i in want["spool_items"]] == ["a", "b", "b"]
    assert want["spool_left"] == ["junk.txt"]
    assert want["budget_elapsed"] > 0.07  # 4 refills at 50/s after a burst of 2
    assert want["stats"] == {"dispatched": 12, "succeeded": 4, "failed": 3, "retried": 5,
                             "expired": 1}
    assert len(want["backoffs"]) == 5 and all(0.5 <= b <= 1.25 for b in want["backoffs"])
    assert [e[2] for e in want["upstream"] if e[0] != "deadlined"] == [None] * 11
    assert [e[2] for e in want["upstream"] if e[0] == "deadlined"][0] is not None


async def _gates_script(ap, fake) -> list:
    url = f"http://{fake.address}/metrics"
    out = []
    sat = ap.PrometheusSaturationGate(url, "vllm:num_requests_waiting", threshold=5.0,
                                      poll_interval_s=0.5)
    fake.queued = 9
    task = asyncio.get_running_loop().create_task(sat.acquire())
    await _until(lambda: sat.last_value == 9.0, "a saturated reading")
    out.append(("saturated", task.done(), sat.saturated))
    fake.queued = 2
    await asyncio.wait_for(task, 10)
    out.append(("open", sat.last_value, sat.saturated))
    await sat.close()
    budget = ap.PrometheusBudgetGate(url, "vllm:num_requests_waiting", threshold=3.0,
                                     poll_interval_s=0.5)
    task = asyncio.get_running_loop().create_task(budget.acquire())
    await _until(lambda: budget.last_value == 2.0, "a reading under the budget")
    out.append(("closed", task.done()))
    fake.queued = 4
    await asyncio.wait_for(task, 10)
    out.append(("spent", budget.last_value))
    await budget.close()
    fake.queued = 0
    for cls, fail_open in ((ap.PrometheusSaturationGate, True),
                           (ap.PrometheusSaturationGate, False),
                           (ap.PrometheusBudgetGate, True)):
        gate = cls("http://127.0.0.1:9/metrics", "x", 1.0, poll_interval_s=0.5,
                   fail_open=fail_open)
        await gate._poll_once()
        out.append((cls.__name__, fail_open, gate.saturated, gate.last_value))
        if fail_open:
            await asyncio.wait_for(gate.acquire(), 10)
        await gate.close()
    out.append(("registry", sorted(ap.GATE_REGISTRY)))
    return out


def test_prometheus_gates_over_the_port_fake_metrics(clocks, monkeypatch):
    async def scenario():
        fake = port_fake.FakeModelServer(port_fake.FakeServerConfig())
        await fake.start()
        try:
            got = []
            for side in (REF, PORT):
                monkeypatch.setattr(side["ap"], "asyncio",
                                    _Asyncio(clocks[side["gw"].__name__]))
                got.append(await _gates_script(side["ap"], fake))
        finally:
            await fake.stop()
        return got

    want, got = run_async(scenario())
    assert got == want
    assert want[:4] == [("saturated", False, True), ("open", 2.0, False), ("closed", False),
                        ("spent", 4.0)]
