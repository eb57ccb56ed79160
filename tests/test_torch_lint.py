"""The port's static analysis (``llmd_tpu_torch/tools/llmd_lint``) against the
reference's suite (``tools/llmd_lint``), and over the port itself.

* parity: the port's framework run with the reference's configuration over
  ``llmd_tpu/`` gives the reference suite's findings, ``(check, file, line,
  message, allowed)`` for every analyzer; both registries declare the same
  metric families and both catalogs the same events;
* the reference's fixture cases (``tests/test_llmd_lint.py``, all but its two
  repo-wide tests) as cases of one test against the port's framework under
  the reference's configuration;
* the torch dialect: each sync spelling flagged in a hot function and not
  outside one, host numpy arrays not flagged, program builds in a hot
  function flagged, and the annotation audit under the port's configuration;
* the port's suite exits clean and models at least the reference's 15 lock
  classes;
* the repairs the suite's findings led to, each with a test that fails on the
  code before it.
"""

from __future__ import annotations

import asyncio
import textwrap
import threading
from dataclasses import replace
from pathlib import Path

import pytest

from llmd_tpu_torch.tools.llmd_lint import config as pconfig
from llmd_tpu_torch.tools.llmd_lint import core as pcore
from llmd_tpu_torch.tools.llmd_lint import envcontract as penv
from llmd_tpu_torch.tools.llmd_lint import events_contract as pevents
from llmd_tpu_torch.tools.llmd_lint import hotpath as phot
from llmd_tpu_torch.tools.llmd_lint import locks as plocks
from llmd_tpu_torch.tools.llmd_lint import metrics_contract as pmetrics
from llmd_tpu_torch.tools.llmd_lint.__main__ import run_suite as port_suite
from tools.llmd_lint import config as rconfig
from tools.llmd_lint import core as rcore
from tools.llmd_lint import events_contract as revents
from tools.llmd_lint import metrics_contract as rmetrics
from tools.llmd_lint.__main__ import run_suite as ref_suite

REPO = Path(__file__).resolve().parent.parent

# the reference's configuration, from its own modules
REFERENCE = replace(
    pconfig.PORT, globs=rcore.DEFAULT_GLOBS, hot_paths=rconfig.HOT_PATHS, dialect="jax",
    sync_call_attrs=frozenset(rconfig.SYNC_CALL_ATTRS),
    sync_call_names=frozenset(rconfig.SYNC_CALL_NAMES),
    jit_call_names=frozenset({"jax.jit", "jax.pmap"}), jit_call_attrs=frozenset(),
    blocking_call_names=frozenset(rconfig.BLOCKING_CALL_NAMES),
    blocking_call_attrs=frozenset(rconfig.BLOCKING_CALL_ATTRS),
    blocking_bare_names=frozenset(rconfig.BLOCKING_BARE_NAMES),
    blocking_untimed_waits=False, allowlist=tuple(rconfig.ALLOWLIST),
    config_file="tools/llmd_lint/config.py",
    env_source_globs=("llmd_tpu/**/*.py", "tools/**/*.py", "helpers/**/*.py", "bench.py",
                      "__graft_entry__.py"),
    consumer_package="llmd_tpu", registry_module="llmd_tpu.obs.metrics", events_module="llmd_tpu.obs.events",
    package_dir="llmd_tpu", program_calls=frozenset())


def _key(findings) -> set:
    return {(f.check, f.file, f.line, f.message, f.allowed) for f in findings}


@pytest.fixture(scope="module")
def suites():
    """(reference suite, the port's framework under the reference's
    configuration, the port's suite), each a full run over its tree."""
    projects = rcore.Project(REPO), pcore.Project(REPO, config=REFERENCE)
    ref, _ = ref_suite(projects[0])
    port_ref, _ = port_suite(projects[1])
    port, summaries = port_suite(pcore.Project(REPO))
    return ref, port_ref, port, summaries, projects


_ANALYZER_CHECKS = {
    "locks": ("lock-", "guard-"), "hotpath": ("hot-",), "env-contract": ("env-",),
    "metrics-contract": ("metrics-",), "events-contract": ("event-",),
    "annotations": ("allow-",)}


@pytest.mark.parametrize("analyzer", sorted(_ANALYZER_CHECKS))
def test_reference_configuration_reproduces_the_reference_suite(suites, analyzer):
    ref, port_ref, _, _, _ = suites
    prefixes = _ANALYZER_CHECKS[analyzer]
    want = {k for k in _key(ref) if k[0].startswith(prefixes)}
    got = {k for k in _key(port_ref) if k[0].startswith(prefixes)}
    assert got == want
    if analyzer in ("locks", "hotpath"):
        assert want, f"the reference suite found nothing for {analyzer}: no parity shown"


def test_reference_configuration_reads_the_reference_env_contract(suites):
    """The env contract finds nothing on the reference's tree, so its inputs
    are held instead: every env read (with its files), every variable the
    artifacts set, every contract row."""
    from tools.llmd_lint import envcontract as renv

    ref_project, port_project = suites[4]
    assert penv.vars_read_in_source(port_project) == renv.vars_read_in_source(ref_project)
    assert penv.vars_set_in_artifacts(REPO) == renv.vars_set_in_artifacts(REPO)
    assert penv.contract_rows(REPO) == renv.contract_rows(REPO)


def test_registries_declare_the_same_families_and_events():
    assert pmetrics.registry_families(REPO) == rmetrics.registry_families(REPO)
    assert pmetrics.registry_families(REPO, "llmd_tpu.obs.metrics") \
        == rmetrics.registry_families(REPO)
    assert pevents.catalog_events(REPO) == revents.catalog_events(REPO)
    assert pevents.catalog_events(REPO, "llmd_tpu.obs.events") == revents.catalog_events(REPO)


# -- the reference's fixture cases, against the port's framework ------------------

def _project(tmp_path: Path, source: str, rel: str = "llmd_tpu/fixt.py",
             config=REFERENCE) -> pcore.Project:
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return pcore.Project(tmp_path, config=config)


def _checks(findings) -> set[str]:
    return {f.check for f in findings}


_BOX = """\
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []

        def add(self, x):
            with self._lock:
                self._items.append(x)
"""


def case_catches_unguarded_write(tmp_path):
    fs = plocks.run(_project(tmp_path, _BOX + """
        def sneak(self, x):
            self._items.append(x)   # mutation without the lock
    """))
    assert any(f.check == "lock-unguarded-write" and "sneak" in f.message
               and "_items" in f.message for f in fs)


def case_clean_locking_fixture_is_quiet(tmp_path):
    assert plocks.run(_project(tmp_path, _BOX + """
        def drain(self):
            with self._lock:
                out = list(self._items)
                self._items = []
            return out
    """)) == []


def case_private_helper_inherits_held_lock(tmp_path):
    assert plocks.run(_project(tmp_path, """\
        import threading

        class Nested:
            def __init__(self):
                self._lock = threading.Lock()
                self._depth = 0

            def enter(self, n):
                with self._lock:
                    self._step(n)

            def _step(self, n):
                self._depth += 1
                if n:
                    self._step(n - 1)
    """)) == []


def case_catches_lock_order_cycle(tmp_path):
    fs = plocks.run(_project(tmp_path, """\
        import threading

        class A:
            def __init__(self, b: "B"):
                self._lock = threading.Lock()
                self.b = b
                self.x = 0

            def ping(self):
                with self._lock:
                    self.b.pong()

            def poke(self):
                with self._lock:
                    self.x = 1

        class B:
            def __init__(self, a: "A"):
                self._lock = threading.Lock()
                self.a = a
                self.y = 0

            def pong(self):
                with self._lock:
                    self.y = 2

            def kick(self):
                with self._lock:
                    self.a.poke()
    """))
    cyc = [f for f in fs if f.check == "lock-order-cycle"]
    assert any("A._lock" in f.message and "B._lock" in f.message for f in cyc), fs


_REENTRY = """\
    import threading

    class Re:
        def __init__(self):
            self._lock = threading.{kind}()
            self.n = 0

        def outer(self):
            with self._lock:
                self._inner()

        def _inner(self):
            with self._lock:
                self.n += 1
"""


def case_catches_self_deadlock_reacquire(tmp_path):
    fs = plocks.run(_project(tmp_path, _REENTRY.format(kind="Lock")))
    assert any(f.check == "lock-order-cycle" and "self-deadlock" in f.message for f in fs)


def case_rlock_reacquire_is_fine(tmp_path):
    assert plocks.run(_project(tmp_path, _REENTRY.format(kind="RLock"))) == []


_SLOW = """\
    import threading
    import time

    class Slow:
        def __init__(self):
            self._lock = threading.Lock()
            self.state = 0

        def tick(self):
            with self._lock:
                {allow}
                time.sleep(0.5)
                self.state += 1
"""


def case_catches_sleep_under_lock(tmp_path):
    fs = plocks.run(_project(tmp_path, _SLOW.format(allow="pass")))
    assert any(f.check == "lock-blocking-call" and "time.sleep" in f.message for f in fs)


def case_semaphore_is_not_a_guard(tmp_path):
    assert plocks.run(_project(tmp_path, """\
        import asyncio

        class Gate:
            def __init__(self):
                self._sem = asyncio.Semaphore(4)
                self.done = 0

            async def run(self):
                async with self._sem:
                    self.done += 1

            def report(self):
                return self.done
    """)) == []


def case_guarded_by_annotation_enforced(tmp_path):
    fs = plocks.run(_project(tmp_path, """\
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self._listeners = []  # guarded-by: _lock

            def subscribe(self, fn):
                self._listeners.append(fn)
    """))
    assert any(f.check == "lock-unguarded-write" and "subscribe" in f.message for f in fs)


def case_guarded_by_unknown_lock_flagged(tmp_path):
    fs = plocks.run(_project(tmp_path, """\
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self._listeners = []  # guarded-by: _mutex

            def poke(self):
                with self._lock:
                    self._listeners = []
    """))
    assert any(f.check == "guard-unknown-lock" for f in fs)


HOT_FIXTURE_PATHS = {"llmd_tpu/fixt.py": "*"}


def case_catches_item_in_hot_path(tmp_path):
    fs = phot.run(_project(tmp_path, """\
        import jax.numpy as jnp

        def decode_step(logits):
            probs = jnp.exp(logits)
            return probs.item()
    """), hot_paths=HOT_FIXTURE_PATHS)
    assert any(f.check == "hot-host-sync" and ".item()" in f.message for f in fs)


def case_catches_jit_in_loop_and_token_loop(tmp_path):
    fs = phot.run(_project(tmp_path, """\
        import jax

        def decode(fns, n_tokens, xs):
            outs = []
            for t in range(n_tokens):
                f = jax.jit(fns[t])
                outs.append(f(xs))
            return outs
    """), hot_paths=HOT_FIXTURE_PATHS)
    assert "hot-jit-in-loop" in _checks(fs) and "hot-token-loop" in _checks(fs)


def case_clean_hot_path_is_quiet(tmp_path):
    assert phot.run(_project(tmp_path, """\
        import jax.numpy as jnp

        def decode_step(step_fn, state, batch):
            state, out = step_fn(state, batch)
            return state, out
    """), hot_paths=HOT_FIXTURE_PATHS) == []


def case_host_asarray_needs_allow(tmp_path):
    proj = _project(tmp_path, """\
        import numpy as np

        def decode_step(toks):
            # llmd-lint: allow[hot-host-sync] host-side list, no transfer
            arr = np.asarray(toks)
            return arr
    """)
    fs = phot.run(proj, hot_paths=HOT_FIXTURE_PATHS)
    pcore.apply_inline_allows(proj, fs)
    assert fs and all(f.allowed for f in fs)


def _contract(tmp_path: Path, rows: str = "") -> None:
    (tmp_path / "deploy").mkdir()
    (tmp_path / "deploy" / "ENV_VARS.md").write_text(
        "| Var | Consumer | Description |\n|---|---|---|\n" + rows)


def case_catches_undocumented_env_var(tmp_path):
    proj = _project(tmp_path, """\
        import os

        FLAG = os.environ.get("LLMD_FIXTURE_UNDOCUMENTED", "0")
    """)
    _contract(tmp_path)
    assert any(f.check == "env-undocumented" and "LLMD_FIXTURE_UNDOCUMENTED" in f.message
               for f in penv.run(proj))


def case_catches_wrapper_env_read_and_stale_row(tmp_path):
    proj = _project(tmp_path, """\
        import os

        def _env_f(name, default):
            return float(os.environ.get(name, default))

        TIMEOUT = _env_f("LLMD_FIXTURE_WRAPPED", 1.0)
    """)
    _contract(tmp_path, "| `LLMD_FIXTURE_WRAPPED` | `llmd_tpu.fixt` | wrapped knob |\n"
                        "| `LLMD_FIXTURE_GONE` | `llmd_tpu.fixt` | removed knob |\n")
    fs = penv.run(proj)
    assert "env-undocumented" not in _checks(fs)
    assert any(f.check == "env-doc-stale" and "LLMD_FIXTURE_GONE" in f.message for f in fs)


def case_catches_consumer_drift(tmp_path):
    proj = _project(tmp_path, """\
        import os

        MODE = os.environ.get("LLMD_FIXTURE_MOVED", "a")
    """, rel="llmd_tpu/newhome.py")
    _contract(tmp_path, "| `LLMD_FIXTURE_MOVED` | `llmd_tpu.oldhome` | moved knob |\n")
    assert any(f.check == "env-consumer-drift" for f in penv.run(proj))


def case_allow_without_justification_rejected(tmp_path):
    proj = _project(tmp_path, _SLOW.format(allow="# llmd-lint: allow[lock-blocking-call]"))
    fs = plocks.run(proj)
    pcore.apply_inline_allows(proj, fs)
    assert any(f.check == "lock-blocking-call" and not f.allowed for f in fs)
    assert any(n.check == "allow-missing-justification"
               for n in pcore.annotation_findings(proj, fs))


def case_unused_allow_flagged(tmp_path):
    proj = _project(tmp_path, """\
        # llmd-lint: allow[lock-blocking-call] nothing here blocks any more
        X = 1
    """)
    assert any(n.check == "allow-unused" for n in pcore.annotation_findings(proj, []))


def case_justified_allow_suppresses_and_is_echoed(tmp_path):
    proj = _project(tmp_path, _SLOW.format(
        allow="# llmd-lint: allow[lock-blocking-call] startup-only warm path, never "
              "per-request"))
    fs = plocks.run(proj)
    pcore.apply_inline_allows(proj, fs)
    blocked = [f for f in fs if f.check == "lock-blocking-call"]
    assert blocked and all(f.allowed for f in blocked)
    assert "startup-only" in blocked[0].justification
    assert pcore.annotation_findings(proj, fs) == []


REFERENCE_CASES = {name[5:]: fn for name, fn in dict(globals()).items()
                   if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_fixture_cases(tmp_path, case):
    REFERENCE_CASES[case](tmp_path)


def test_the_reference_fixture_cases_are_all_here():
    src = (REPO / "tests" / "test_llmd_lint.py").read_text()
    names = {line.split("(")[0][9:] for line in src.splitlines()
             if line.startswith("def test_")}
    assert names - {"repo_suite_is_clean", "repo_lock_graph_covers_acceptance_floor"} \
        == set(REFERENCE_CASES)


# -- the torch dialect -----------------------------------------------------------

TORCH_HOT = {"llmd_tpu_torch/fixt.py": ["hot"]}


def _hot_and_cold(params: str, body: str) -> str:
    """A module with the same ``body`` in a hot function and a cold one."""
    fn = "".join(f"def {name}({params}):\n" + textwrap.indent(body, "    ") + "\n\n\n"
                 for name in ("hot", "cold"))
    return ("import numpy as np\nimport torch\n"
            "from llmd_tpu_torch.native.build import load\n\n\n" + fn)

_SPELLINGS = {
    "item": "y = x.item()",
    "tolist": "y = x.tolist()",
    "cpu": "y = x.cpu()",
    "numpy": "y = x.numpy()",
    "to_cpu": 'y = x.to("cpu")',
    "to_cpu_device": 'y = x.to(device=torch.device("cpu"))',
    "cuda_synchronize": "torch.cuda.synchronize()",
    "stream_synchronize": "torch.cuda.current_stream().synchronize()",
    "event_synchronize": "rec['event'].synchronize()",
    "np_asarray": "y = np.asarray(x)",
    "np_array": "y = np.array(x + 1)",
    "float": "y = float(x.sum())",
    "int": "y = int(x[0])",
    "bool": "y = bool((x > 0).any())",
    "nonzero": "y = torch.nonzero(x)",
    "nonzero_method": "y = (x > 0).nonzero()",
    "unique": "y = torch.unique(x)",
    "masked_select": "y = torch.masked_select(x, x > 0)",
    "repeat_interleave": "y = x.repeat_interleave(torch.tensor([1, 2], device=x.device))",
    "bool_mask_index": "y = x[x > 0]",
    "bool_mask_store": "x[torch.isnan(x)] = 0.0",
    "implicit_bool": "if (x > 0).all():\n    pass",
}


@pytest.mark.parametrize("spelling", sorted(_SPELLINGS))
def test_torch_sync_spelling_flagged_in_hot_code_only(tmp_path, spelling):
    proj = _project(tmp_path, _hot_and_cold("x: torch.Tensor, rec: dict",
                                            _SPELLINGS[spelling]),
                    rel="llmd_tpu_torch/fixt.py", config=pconfig.PORT)
    fs = phot.run(proj, hot_paths=TORCH_HOT)
    assert fs and {f.check for f in fs} <= {"hot-host-sync", "hot-implicit-bool"}, fs
    assert all(f.message.startswith("hot:") for f in fs), fs


def test_torch_host_values_are_not_flagged(tmp_path):
    proj = _project(tmp_path, """\
        import numpy as np
        import torch

        def hot(x: torch.Tensor, toks: list, out: torch.Tensor, rec: dict):
            a = np.zeros(3, np.int32)
            b = a.tolist() + np.array(toks).tolist()
            n = int(a[0]) + len(toks) + x.shape[0] + int(x.numel())
            host = rec["host"].numpy()
            rows = host[:n].tolist()
            ids = torch.from_numpy(a)
            ids.tolist()
            y = x.repeat_interleave(n) + x.repeat_interleave(2)
            reps = out.cpu().numpy()  # llmd-lint: allow[hot-host-sync] the fixture's one read
            z = int(reps[0]) + bool(host[0]) + float(np.asarray(toks).sum())
            return b, rows, y, z
    """, rel="llmd_tpu_torch/fixt.py", config=pconfig.PORT)
    fs = phot.run(proj, hot_paths=TORCH_HOT)
    pcore.apply_inline_allows(proj, fs)
    assert [(f.line, f.message) for f in fs if not f.allowed] == []
    assert len(fs) == 1  # the allowed .cpu()


@pytest.mark.parametrize("build,check", [
    ("f = torch.compile(fn)", "hot-jit-call"),
    ("g = torch.cuda.CUDAGraph()\nwith torch.cuda.graph(g):\n    fn()", "hot-jit-call"),
    ("g.capture_begin()", "hot-jit-call"),
    ("load('paged_attention')", "hot-jit-call"),
    ("for _ in range(3):\n    fn = torch.compile(fn)", "hot-jit-in-loop"),
])
def test_torch_program_build_in_hot_code_is_flagged(tmp_path, build, check):
    proj = _project(tmp_path, _hot_and_cold("fn, g", build),
                    rel="llmd_tpu_torch/fixt.py", config=pconfig.PORT)
    fs = phot.run(proj, hot_paths=TORCH_HOT)
    assert check in _checks(fs) and all(f.message.startswith("hot:") for f in fs), fs


def test_torch_untimed_wait_under_a_lock_blocks(tmp_path):
    proj = _project(tmp_path, """\
        import threading
        import torch

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self._cond = threading.Condition()
                self._done = threading.Event()
                self.n = 0

            def bad(self, t):
                with self._lock:
                    self._done.wait()
                    t.join()
                    torch.cuda.synchronize()
                    self.n += 1

            def good(self, t):
                with self._lock:
                    self._done.wait(1.0)
                    t.join(timeout=1.0)
                    self.n += 1
                with self._cond:
                    self._cond.wait()
    """, rel="llmd_tpu_torch/fixt.py", config=pconfig.PORT)
    blocked = {f.message.split("'")[1] for f in plocks.run(proj)
               if f.check == "lock-blocking-call"}
    assert blocked == {"self._done.wait", "t.join", "torch.cuda.synchronize"}


def test_torch_annotation_audit(tmp_path):
    proj = _project(tmp_path, """\
        import torch

        def hot(x: torch.Tensor):
            # llmd-lint: allow[hot-host-sync]
            y = x.item()
            # llmd-lint: allow[hot-host-sync] nothing syncs here any more
            z = x + 1
            return y, z
    """, rel="llmd_tpu_torch/fixt.py", config=replace(pconfig.PORT, hot_paths=TORCH_HOT))
    findings, _ = port_suite(proj, ["hotpath"])
    assert [f.check for f in findings if not f.allowed] == ["hot-host-sync"]
    notes = {n.check for n in pcore.annotation_findings(proj, findings)}
    assert notes == {"allow-missing-justification", "allow-unused"}


# -- the port's suite ------------------------------------------------------------

def test_port_suite_is_clean(suites):
    _, _, port, _, _ = suites
    failures = [f"{f.check} {f.location()}: {f.message}" for f in port if not f.allowed]
    assert failures == []
    assert all(f.justification.strip() for f in port if f.allowed)


def test_port_lock_graph_covers_the_reference_floor(suites):
    _, _, _, summaries, _ = suites
    assert summaries["locks"]["num_classes"] >= 15, summaries["locks"]


# -- repairs the suite's findings led to -----------------------------------------

def test_channel_close_waits_for_a_connect_in_flight():
    """``grpc_wire.Channel.close`` read ``_conn`` without the lock its
    creation holds: a close while a connect was in flight closed nothing, and
    the connection made after it stayed open."""
    from llmd_tpu_torch.router.grpc_wire import Channel

    async def scenario():
        accepted = []

        async def peer(reader, writer):
            accepted.append(writer)
            await reader.read()  # hold the connection until the client closes it

        server = await asyncio.start_server(peer, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        ch = Channel(f"127.0.0.1:{port}")
        connecting = asyncio.get_running_loop().create_task(ch._connection())
        await asyncio.sleep(0)  # the connect holds the channel's lock now
        await ch.close()
        conn = await connecting
        try:
            assert conn.closed and ch._conn is None
        finally:
            await conn.close()
            for w in accepted:
                w.close()
            server.close()
            await server.wait_closed()

    asyncio.run(scenario())


def test_server_stop_frees_a_tower_built_concurrently():
    """``EngineServer.stop`` read ``_built_vision`` / ``_vision`` without the
    lock a media request builds the tower under: a stop during that build
    left the tower's weights allocated."""
    from llmd_tpu_torch.engine.server import EngineServer

    class Tower:
        closed = False

        def close(self):
            self.closed = True

    srv = EngineServer.__new__(EngineServer)
    srv._vision, srv._built_vision = None, False
    srv._vision_lock = threading.Lock()
    tower, building, built = Tower(), threading.Event(), threading.Event()

    def build():  # a media request building the in-process tower
        with srv._vision_lock:
            building.set()
            built.wait(5)
            srv._vision, srv._built_vision = tower, True

    builder = threading.Thread(target=build)
    builder.start()
    building.wait(5)
    stopper = threading.Thread(target=srv._close_tower)
    stopper.start()
    stopper.join(0.2)
    waited = stopper.is_alive()  # the stop waits for the build to finish
    built.set()
    builder.join(5)
    stopper.join(5)
    assert waited and tower.closed
