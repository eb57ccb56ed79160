"""Lock-discipline analyzer (the port's copy of ``tools/llmd_lint/locks.py``).

Three checks over every class that owns (or inherits) a lock:

1. **Guarded-attribute discipline** (``lock-unguarded-read`` /
   ``lock-unguarded-write``). An attribute is *guarded* when some method
   writes it while holding the lock (outside ``__init__``), or when its
   initialising assignment carries an explicit ``# guarded-by: _lock``
   annotation. Every other read/write of a guarded attribute must hold one
   of its guards. Private methods whose every intra-class call site holds
   the lock are treated as running under it (the ``_breaker``/
   ``_transition`` helper idiom); public methods never inherit a lock —
   they are API entry points.

2. **Lock-acquisition order** (``lock-order-cycle``). Acquiring lock B
   while holding lock A adds the edge A→B — directly via nested ``with``,
   or through a call whose receiver type is statically resolvable
   (``self.m()``, ``self.attr.m()`` with the attr constructed in
   ``__init__``, locals assigned from a constructor). A cycle in the
   cross-class graph is a potential deadlock; acquiring a non-reentrant
   lock already held is a guaranteed one.

3. **Blocking calls under a lock** (``lock-blocking-call``).
   ``time.sleep``, socket/HTTP operations, ``block_until_ready`` and
   friends made while holding a lock serialize every waiter behind the
   sleeper (and stall the event loop entirely under an asyncio lock). The
   port's configuration adds ``torch.cuda.synchronize`` / ``.synchronize()``
   and an ``Event.wait()`` / ``Thread.join()`` with no timeout on anything
   but the class's own lock (a ``Condition.wait`` releases its lock).

The analysis is intentionally per-class with static receiver resolution:
no alias tracking, no cross-object guard inference. What it cannot see it
stays silent about — findings are designed to be true positives worth
fixing or explicitly allowlisting.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional

from .core import Finding, Project, SourceFile, dotted_name

LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
REENTRANT_KINDS = {"RLock", "Condition", "unknown"}
# Semaphores bound concurrency; they do not provide mutual exclusion, so they
# never make an attribute "guarded" (they still join the acquisition graph —
# blocking inside one can deadlock just the same).
SEMAPHORE_KINDS = {"Semaphore", "BoundedSemaphore"}
MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "add", "discard", "setdefault", "appendleft", "popleft",
    "sort", "reverse", "__setitem__",
}
EXEMPT_METHODS = {"__init__", "__post_init__", "__new__"}


@dataclass
class Lock:
    key: str    # "ClassName._lock" or "path.py:NAME"
    name: str   # attribute / global name
    kind: str   # factory name; "unknown" when injected without annotation
    owner: str  # defining class name or module rel path
    file: str
    line: int

    @property
    def reentrant(self) -> bool:
        return self.kind in REENTRANT_KINDS


@dataclass
class Access:
    attr: str
    write: bool
    line: int
    end_line: int
    held: frozenset  # lock keys held at the access site
    nested: bool     # inside a nested def/lambda (runs later, lock unknown)


@dataclass
class CallSite:
    chain: str               # dotted spelling at the call site
    target: Optional[tuple]  # resolved (class_name, method_name) or None
    line: int
    end_line: int
    held: frozenset
    untimed_wait: bool = False  # .wait() / .join() with no timeout, not on a lock


@dataclass
class MethodRec:
    name: str
    node: ast.AST
    accesses: list = field(default_factory=list)
    acquires: list = field(default_factory=list)  # (lock_key, line, held_before)
    calls: list = field(default_factory=list)
    inherited_held: frozenset = frozenset()  # via all-call-sites-hold-lock


@dataclass
class ClassRec:
    name: str
    sf: SourceFile
    node: ast.ClassDef
    bases: list
    methods: dict = field(default_factory=dict)      # name -> MethodRec
    own_locks: dict = field(default_factory=dict)    # attr -> Lock
    attr_types: dict = field(default_factory=dict)   # attr -> class name
    guards: dict = field(default_factory=dict)       # attr -> set[lock key]

    def method_names(self, index) -> set:
        out = set(self.methods)
        for b in self._ancestors(index):
            out |= set(b.methods)
        return out

    def _ancestors(self, index, _seen=None):
        seen = _seen or {self.name}
        out = []
        for b in self.bases:
            rec = index.get(b)
            if rec is not None and rec.name not in seen:
                seen.add(rec.name)
                out.append(rec)
                out.extend(rec._ancestors(index, seen))
        return out

    def effective_locks(self, index) -> dict:
        out = {}
        for b in reversed(self._ancestors(index)):
            out.update(b.own_locks)
        out.update(self.own_locks)
        return out

    def effective_attr_types(self, index) -> dict:
        out = {}
        for b in reversed(self._ancestors(index)):
            out.update(b.attr_types)
        out.update(self.attr_types)
        return out

    def effective_guards(self, index) -> dict:
        out: dict[str, set] = {}
        for rec in [*self._ancestors(index), self]:
            for attr, keys in rec.guards.items():
                out.setdefault(attr, set()).update(keys)
        return out


# ---------------------------------------------------------------- pass A

def _lock_kind_from_call(call: ast.Call) -> Optional[str]:
    name = dotted_name(call.func)
    if name is None:
        return None
    parts = name.split(".")
    if parts[-1] in LOCK_FACTORIES and (
            len(parts) == 1 or parts[0] in ("threading", "asyncio", "multiprocessing")):
        return parts[-1]
    return None


def _annotation_name(node: Optional[ast.AST]) -> Optional[str]:
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(".")[-1].strip("'\" ")
    name = dotted_name(node)
    return name.split(".")[-1] if name else None


def _collect_class(sf: SourceFile, node: ast.ClassDef) -> ClassRec:
    rec = ClassRec(
        name=node.name, sf=sf, node=node,
        bases=[b for b in (dotted_name(x) for x in node.bases) if b],
    )
    rec.bases = [b.split(".")[-1] for b in rec.bases]
    for item in node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        rec.methods[item.name] = MethodRec(item.name, item)
        params = {a.arg: a.annotation for a in item.args.args}
        for st in ast.walk(item):
            if isinstance(st, ast.AnnAssign) and _is_self_attr(st.target):
                ann = _annotation_name(st.annotation)
                if ann:
                    rec.attr_types[st.target.attr] = ann
            if not isinstance(st, ast.Assign):
                continue
            for tgt in st.targets:
                if not _is_self_attr(tgt):
                    continue
                attr = tgt.attr
                if isinstance(st.value, ast.Call):
                    kind = _lock_kind_from_call(st.value)
                    if kind:
                        rec.own_locks[attr] = Lock(
                            key=f"{node.name}.{attr}", name=attr, kind=kind,
                            owner=node.name, file=sf.rel, line=st.lineno)
                        continue
                    ctor = dotted_name(st.value.func)
                    if ctor:
                        rec.attr_types[attr] = ctor.split(".")[-1]
                elif isinstance(st.value, ast.Name):
                    src = st.value.id
                    ann = _annotation_name(params.get(src))
                    if ann in LOCK_FACTORIES:
                        rec.own_locks[attr] = Lock(
                            key=f"{node.name}.{attr}", name=attr, kind=ann,
                            owner=node.name, file=sf.rel, line=st.lineno)
                    elif "lock" in attr.lower() and "lock" in src.lower():
                        # injected lock with no annotation: kind unknown —
                        # reentrancy checks stay quiet rather than guess
                        rec.own_locks[attr] = Lock(
                            key=f"{node.name}.{attr}", name=attr, kind="unknown",
                            owner=node.name, file=sf.rel, line=st.lineno)
                    elif ann:
                        rec.attr_types[attr] = ann
    return rec


def _is_self_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self")


def _module_locks(sf: SourceFile) -> dict:
    out = {}
    for st in sf.tree.body:
        if isinstance(st, ast.Assign) and isinstance(st.value, ast.Call):
            kind = _lock_kind_from_call(st.value)
            if kind:
                for tgt in st.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = Lock(
                            key=f"{sf.rel}:{tgt.id}", name=tgt.id, kind=kind,
                            owner=sf.rel, file=sf.rel, line=st.lineno)
    return out


# ---------------------------------------------------------------- pass B

class _MethodWalker:
    """Walks one method body tracking the set of held locks."""

    def __init__(self, cls: ClassRec, mrec: MethodRec, locks: dict,
                 attr_types: dict, method_names: set, module_locks: dict,
                 class_index: dict) -> None:
        self.cls = cls
        self.mrec = mrec
        self.locks = locks            # attr name -> Lock (effective for class)
        self.attr_types = attr_types
        self.method_names = method_names
        self.module_locks = module_locks
        self.index = class_index
        self.held: tuple = ()
        self.nested = 0
        self.local_types: dict[str, str] = {}

    # -- helpers -----------------------------------------------------------
    def _lock_of(self, expr: ast.AST) -> Optional[Lock]:
        if _is_self_attr(expr) and expr.attr in self.locks:
            return self.locks[expr.attr]
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return self.module_locks[expr.id]
        return None

    def _note_access(self, attr: str, write: bool, node: ast.AST) -> None:
        if attr in self.locks:
            return
        self.mrec.accesses.append(Access(
            attr, write, node.lineno, getattr(node, "end_lineno", node.lineno),
            frozenset(self.held), self.nested > 0))

    def _note_call(self, chain: str, target, node: ast.AST) -> None:
        parts = chain.split(".")
        untimed = (isinstance(node, ast.Call) and parts[-1] in ("wait", "join")
                   and len(parts) > 1 and not node.args
                   and not any(k.arg == "timeout" for k in node.keywords)
                   and not (parts[0] == "self" and len(parts) == 3
                            and parts[1] in self.locks))
        self.mrec.calls.append(CallSite(
            chain, target, node.lineno,
            getattr(node, "end_lineno", node.lineno), frozenset(self.held),
            untimed))

    # -- statements --------------------------------------------------------
    def body(self, stmts) -> None:
        for st in stmts:
            self.stmt(st)

    def stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in st.items:
                lk = self._lock_of(item.context_expr)
                if lk is not None:
                    self.mrec.acquires.append(
                        (lk.key, st.lineno, frozenset(self.held)))
                    acquired.append(lk.key)
                else:
                    self.expr(item.context_expr)
            saved = self.held
            self.held = tuple(dict.fromkeys([*self.held, *acquired]))
            self.body(st.body)
            self.held = saved
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            saved, self.held = self.held, ()
            self.nested += 1
            self.body(st.body)
            self.nested -= 1
            self.held = saved
        elif isinstance(st, ast.Assign):
            if (isinstance(st.value, ast.Call)
                    and isinstance(st.targets[0], ast.Name)):
                ctor = dotted_name(st.value.func)
                if ctor and ctor.split(".")[-1] in self.index:
                    self.local_types[st.targets[0].id] = ctor.split(".")[-1]
            self.expr(st.value)
            for tgt in st.targets:
                self.target(tgt)
        elif isinstance(st, ast.AugAssign):
            self.expr(st.value)
            if _is_self_attr(st.target):
                self._note_access(st.target.attr, True, st.target)
            else:
                self.target(st.target)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self.expr(st.value)
            self.target(st.target)
        elif isinstance(st, ast.Delete):
            for tgt in st.targets:
                self.target(tgt)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self.expr(st.iter)
            self.target(st.target)
            self.body(st.body)
            self.body(st.orelse)
        elif isinstance(st, ast.While):
            self.expr(st.test)
            self.body(st.body)
            self.body(st.orelse)
        elif isinstance(st, ast.If):
            self.expr(st.test)
            self.body(st.body)
            self.body(st.orelse)
        elif isinstance(st, ast.Try):
            self.body(st.body)
            for h in st.handlers:
                self.body(h.body)
            self.body(st.orelse)
            self.body(st.finalbody)
        elif isinstance(st, (ast.Return, ast.Expr)):
            if st.value is not None:
                self.expr(st.value)
        elif isinstance(st, ast.Raise):
            if st.exc is not None:
                self.expr(st.exc)
        elif isinstance(st, ast.Assert):
            self.expr(st.test)
        elif isinstance(st, ast.ClassDef):
            pass  # nested class bodies: out of scope
        else:
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self.expr(child)
                elif isinstance(child, ast.stmt):
                    self.stmt(child)

    # -- expressions -------------------------------------------------------
    def target(self, node: ast.AST) -> None:
        """Assignment/deletion target: classify self-attribute writes."""
        if _is_self_attr(node):
            self._note_access(node.attr, True, node)
        elif isinstance(node, ast.Subscript):
            if _is_self_attr(node.value):
                self._note_access(node.value.attr, True, node)
            else:
                self.expr(node.value)
            self.expr(node.slice)
        elif isinstance(node, ast.Attribute):
            self.expr(node.value)
        elif isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                self.target(elt)
        elif isinstance(node, ast.Starred):
            self.target(node.value)
        # bare Name targets are locals — no state access

    def expr(self, node: Optional[ast.AST]) -> None:
        if node is None:
            return
        if isinstance(node, ast.Attribute):
            if _is_self_attr(node):
                self._note_access(node.attr, False, node)
            else:
                self.expr(node.value)
        elif isinstance(node, ast.Call):
            self.call(node)
        elif isinstance(node, ast.Lambda):
            saved, self.held = self.held, ()
            self.nested += 1
            self.expr(node.body)
            self.nested -= 1
            self.held = saved
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                self.expr(gen.iter)
                for cond in gen.ifs:
                    self.expr(cond)
            if isinstance(node, ast.DictComp):
                self.expr(node.key)
                self.expr(node.value)
            else:
                self.expr(node.elt)
        else:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self.expr(child)

    def call(self, node: ast.Call) -> None:
        chain = dotted_name(node.func)
        if chain is None:
            self.expr(node.func)
        else:
            parts = chain.split(".")
            target = None
            if parts[0] == "self" and len(parts) == 2:
                if parts[1] in self.method_names:
                    target = (self.cls.name, parts[1])
                else:  # callable attribute (self._step_fn(...)) — a read
                    self._note_access(parts[1], False, node.func)
            elif parts[0] == "self" and len(parts) == 3:
                attr, meth = parts[1], parts[2]
                self._note_access(attr, meth in MUTATORS, node.func)
                tcls = self.attr_types.get(attr)
                if tcls in self.index:
                    target = (tcls, meth)
            elif parts[0] == "self":  # self.a.b.c(...): reads 'a' at least
                self._note_access(parts[1], False, node.func)
            elif len(parts) == 2 and parts[0] in self.local_types:
                target = (self.local_types[parts[0]], parts[1])
            self._note_call(chain, target, node)
        for a in node.args:
            self.expr(a)
        for kw in node.keywords:
            self.expr(kw.value)


# ------------------------------------------------------------------ analysis

class LockAnalysis:
    def __init__(self, project: Project) -> None:
        self.project = project
        self.index: dict[str, ClassRec] = {}
        self.dup_names: set[str] = set()
        self.module_locks: dict[str, dict] = {}
        self.locks: dict[str, Lock] = {}
        self.edges: dict[tuple, tuple] = {}  # (a,b) -> (file,line,desc)
        self.findings: list[Finding] = []
        self._run()

    # -- summary used by the runner / tests --------------------------------
    def summary(self) -> dict:
        classes = sorted({lk.owner for lk in self.locks.values()
                          if ":" not in lk.key})
        return {
            "classes_holding_locks": classes,
            "num_classes": len(classes),
            "num_locks": len(self.locks),
            "num_edges": len(self.edges),
            "edges": sorted(f"{a} -> {b}" for a, b in self.edges),
        }

    def _run(self) -> None:
        files = self.project.files()
        for sf in files:
            self.module_locks[sf.rel] = _module_locks(sf)
            for lk in self.module_locks[sf.rel].values():
                self.locks[lk.key] = lk
            for node in sf.tree.body:
                if isinstance(node, ast.ClassDef):
                    rec = _collect_class(sf, node)
                    if node.name in self.index:
                        self.dup_names.add(node.name)
                    self.index[node.name] = rec
        for name in self.dup_names:  # ambiguous resolution target: drop
            self.index.pop(name, None)

        analyzed: list[ClassRec] = []
        for rec in self.index.values():
            eff = rec.effective_locks(self.index)
            if not eff:
                continue
            for lk in rec.own_locks.values():
                self.locks[lk.key] = lk
            attr_types = rec.effective_attr_types(self.index)
            names = rec.method_names(self.index)
            for mrec in rec.methods.values():
                walker = _MethodWalker(rec, mrec, eff, attr_types, names,
                                       self.module_locks.get(rec.sf.rel, {}),
                                       self.index)
                walker.body(mrec.node.body)
            analyzed.append(rec)

        # two rounds so ancestor call-site held-sets settle before overrides
        # consult them, whatever order the classes were discovered in
        for _ in range(2):
            for rec in analyzed:
                self._propagate_held(rec, rec.effective_locks(self.index))

        for rec in analyzed:
            self._infer_guards(rec)
        for rec in analyzed:
            self._check_guarded(rec)
            self._check_acquires_and_blocking(rec)
        self._build_edges(analyzed)
        self._check_cycles()

    # -- held propagation: private helpers called only under the lock ------
    def _propagate_held(self, rec: ClassRec, eff: dict) -> None:
        sole = list(eff.values())[0].key if len(eff) == 1 else None
        # Greatest fixpoint: seed private helpers at TOP (all class locks) and
        # intersect downward. Starting at bottom would let a recursive helper
        # (e.g. RESP _read_reply calling itself for nested arrays) pin its own
        # inherited set at empty via its self-call site.
        top = frozenset(lk.key for lk in eff.values())
        private = [m for m in rec.methods.values()
                   if m.name.startswith("_") and not m.name.startswith("__")]
        for mrec in private:
            mrec.inherited_held = top
        # `self._m()` in a base class dispatches to a subclass override, so an
        # override's call sites include the ancestors' (KVBlockIndex.apply
        # calling self._store under lock reaches CostAwareKVBlockIndex._store).
        chain = [rec, *rec._ancestors(self.index)]
        for _ in range(len(rec.methods) * (len(top) + 1) + 2):
            changed = False
            for mrec in private:
                sites = [
                    (c, caller) for cls in chain
                    for caller in cls.methods.values()
                    for c in caller.calls
                    if c.target == (cls.name, mrec.name)
                ]
                if sites:
                    held = None
                    for c, caller in sites:
                        h = c.held | caller.inherited_held
                        held = h if held is None else held & h
                    held = frozenset(held or ())
                elif mrec.name.endswith("_locked") and sole:
                    # convention: *_locked runs with the class's lock held
                    held = frozenset({sole})
                else:
                    held = frozenset()
                if held != mrec.inherited_held:
                    mrec.inherited_held = held
                    changed = True
            if not changed:
                break

    # -- guarded-attribute inference + explicit annotations -----------------
    def _infer_guards(self, rec: ClassRec) -> None:
        eff = rec.effective_locks(self.index)
        keys = {lk.key for lk in eff.values()
                if lk.kind not in SEMAPHORE_KINDS}
        keys |= {lk.key for lk in self.module_locks.get(rec.sf.rel, {}).values()
                 if lk.kind not in SEMAPHORE_KINDS}
        for mrec in rec.methods.values():
            if mrec.name in EXEMPT_METHODS:
                continue
            for acc in mrec.accesses:
                if not acc.write or acc.nested:
                    continue
                held = (acc.held | mrec.inherited_held) & keys
                for k in held:
                    rec.guards.setdefault(acc.attr, set()).add(k)
        # explicit "# guarded-by: <lock>" on an initialising assignment
        for line, lockname in rec.sf.guarded_by.items():
            if not (rec.node.lineno <= line <= (rec.node.end_lineno or line)):
                continue
            lk = eff.get(lockname) or self.module_locks.get(
                rec.sf.rel, {}).get(lockname)
            attrs = {a.attr for m in rec.methods.values() for a in m.accesses
                     if a.write and a.line <= line <= a.end_line}
            if lk is None:
                self.findings.append(Finding(
                    "guard-unknown-lock", rec.sf.rel, line,
                    f"{rec.name}: '# guarded-by: {lockname}' names no lock "
                    f"of this class", end_line=line))
            elif lk.kind in SEMAPHORE_KINDS:
                self.findings.append(Finding(
                    "guard-unknown-lock", rec.sf.rel, line,
                    f"{rec.name}: '# guarded-by: {lockname}' names a "
                    f"semaphore — it bounds concurrency, it does not guard "
                    f"data", end_line=line))
            elif not attrs:
                self.findings.append(Finding(
                    "guard-unresolved", rec.sf.rel, line,
                    f"{rec.name}: '# guarded-by: {lockname}' is not attached "
                    f"to a self-attribute assignment", end_line=line))
            else:
                for attr in attrs:
                    rec.guards.setdefault(attr, set()).add(lk.key)

    def _check_guarded(self, rec: ClassRec) -> None:
        guards = rec.effective_guards(self.index)
        if not guards:
            return
        lock_by_key = {k: lk for k, lk in self.locks.items()}
        for mrec in rec.methods.values():
            if mrec.name in EXEMPT_METHODS:
                continue
            for acc in mrec.accesses:
                want = guards.get(acc.attr)
                if not want:
                    continue
                held = acc.held | mrec.inherited_held
                if held & want:
                    continue
                names = "/".join(sorted(
                    lock_by_key[k].name if k in lock_by_key else k
                    for k in want))
                kind = "write" if acc.write else "read"
                self.findings.append(Finding(
                    f"lock-unguarded-{kind}", rec.sf.rel, acc.line,
                    f"{rec.name}.{mrec.name}: {kind} of '{acc.attr}' "
                    f"(guarded by '{names}') without holding it",
                    end_line=acc.end_line))

    # -- acquisition order + blocking calls ---------------------------------
    def _check_acquires_and_blocking(self, rec: ClassRec) -> None:
        for mrec in rec.methods.values():
            inh = mrec.inherited_held
            for key, line, held in mrec.acquires:
                held = held | inh
                lk = self.locks.get(key)
                if key in held and lk is not None and not lk.reentrant:
                    self.findings.append(Finding(
                        "lock-order-cycle", rec.sf.rel, line,
                        f"{rec.name}.{mrec.name}: re-acquires non-reentrant "
                        f"lock '{lk.name}' already held — guaranteed "
                        f"self-deadlock", end_line=line))
            for c in mrec.calls:
                if not (c.held | inh):
                    continue
                if self._is_blocking(c):
                    locks = ", ".join(sorted(
                        self.locks[k].key if k in self.locks else k
                        for k in (c.held | inh)))
                    self.findings.append(Finding(
                        "lock-blocking-call", rec.sf.rel, c.line,
                        f"{rec.name}.{mrec.name}: blocking call "
                        f"'{c.chain}' while holding {locks}",
                        end_line=c.end_line))

    def _is_blocking(self, c: CallSite) -> bool:
        cfg = self.project.config
        chain = c.chain
        parts = chain.split(".")
        if chain in cfg.blocking_call_names:
            return True
        if len(parts) == 1 and parts[0] in cfg.blocking_bare_names:
            return True
        if cfg.blocking_untimed_waits and c.untimed_wait:
            return True
        return len(parts) > 1 and parts[-1] in cfg.blocking_call_attrs

    # -- cross-class acquisition graph --------------------------------------
    def _build_edges(self, analyzed: list) -> None:
        # may-acquire set per (class, method), transitive through resolved calls
        acq: dict[tuple, set] = {}
        calls: dict[tuple, list] = {}
        for rec in analyzed:
            for mrec in rec.methods.values():
                node = (rec.name, mrec.name)
                acq[node] = {key for key, _, _ in mrec.acquires}
                calls[node] = [c.target for c in mrec.calls
                               if c.target is not None]
        for _ in range(len(acq) + 1):
            changed = False
            for node, targets in calls.items():
                for t in targets:
                    extra = acq.get(t, set()) - acq[node]
                    if extra:
                        acq[node] |= extra
                        changed = True
            if not changed:
                break

        def add_edge(a: str, b: str, file: str, line: int, desc: str) -> None:
            if a == b:
                return  # self re-acquire handled per-site with reentrancy
            self.edges.setdefault((a, b), (file, line, desc))

        for rec in analyzed:
            for mrec in rec.methods.values():
                inh = mrec.inherited_held
                where = f"{rec.name}.{mrec.name}"
                for key, line, held in mrec.acquires:
                    for h in held | inh:
                        add_edge(h, key, rec.sf.rel, line, where)
                for c in mrec.calls:
                    held = c.held | inh
                    if not held or c.target is None:
                        continue
                    for k2 in acq.get(c.target, ()):
                        for h in held:
                            add_edge(h, k2, rec.sf.rel, c.line,
                                     f"{where} -> {c.chain}")

    def _check_cycles(self) -> None:
        graph: dict[str, set] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        for scc in _sccs(graph):
            if len(scc) < 2:
                continue
            nodes = sorted(scc)
            prov = [f"{a} -> {b} ({self.edges[(a, b)][0]}:{self.edges[(a, b)][1]}"
                    f" in {self.edges[(a, b)][2]})"
                    for (a, b) in self.edges
                    if a in scc and b in scc]
            f0 = next(((self.edges[(a, b)][0], self.edges[(a, b)][1])
                       for (a, b) in self.edges if a in scc and b in scc),
                      ("", 0))
            self.findings.append(Finding(
                "lock-order-cycle", f0[0], f0[1],
                "lock-order cycle (potential deadlock): "
                + ", ".join(nodes) + " — " + "; ".join(sorted(prov))))


def _sccs(graph: dict) -> list:
    """Tarjan strongly-connected components."""
    idx: dict = {}
    low: dict = {}
    on: set = set()
    stack: list = []
    out: list = []
    counter = [0]

    def strong(v):
        idx[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in graph.get(v, ()):
            if w not in idx:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], idx[w])
        if low[v] == idx[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            out.append(comp)

    for v in list(graph):
        if v not in idx:
            strong(v)
    return out


def analyze(project: Project) -> LockAnalysis:
    cached = getattr(project, "_lock_analysis", None)
    if cached is None:
        cached = LockAnalysis(project)
        project._lock_analysis = cached
    return cached


def run(project: Project) -> list[Finding]:
    return list(analyze(project).findings)


def summary(project: Project) -> dict:
    return analyze(project).summary()
