"""Hot-path purity analyzer (the port's copy of ``tools/llmd_lint/hotpath.py``).

Over the declared hot-path set (``LintConfig.hot_paths``: the engine's
step/dispatch/verify/sample functions, the eager programs and the forward,
every op kernel) this flags the bug classes a serving loop cannot afford:

* ``hot-host-sync`` — device→host synchronization. In the reference's
  dialect (JAX): ``.item()``, ``.tolist()``, ``.block_until_ready()``,
  ``np.asarray``/``np.array`` and ``jax.device_get``, plus
  ``float()``/``int()``/``bool()`` over a value a local-dataflow pass saw
  come out of a ``jnp``/``jax`` call. In the port's (torch): ``.item()`` and
  ``.cpu()`` / ``.to("cpu")`` on anything not known to be on the host,
  ``.tolist()`` / ``.numpy()`` / ``np.asarray`` / ``np.array`` /
  ``float()`` / ``int()`` / ``bool()`` of a device value,
  ``torch.cuda.synchronize`` and ``.synchronize()`` on a stream or event,
  and the calls whose output shape depends on the data (``torch.nonzero``,
  ``torch.unique``, ``torch.masked_select``, ``repeat_interleave`` with
  tensor repeats and no ``output_size``, indexing a device value with a
  device boolean mask): the host must read the device to size the result.
  Each sync stalls the dispatch pipeline for a full device round trip; the
  designed sync points carry inline allows with their justification.
* ``hot-implicit-bool`` — branching directly on a device value (``if x:``)
  forces the same transfer without spelling it.
* ``hot-jit-in-loop`` / ``hot-jit-call`` — a program build inside a loop
  of a hot function, or anywhere in one: ``jax.jit``/``jax.pmap`` in the
  reference; ``torch.compile``, a CUDA graph capture or a native build in
  the port. Per-request tracing or compilation is never acceptable.
* ``hot-token-loop`` — a Python-level per-token loop (``for _ in
  range(<...token...>)``) in a hot function: work that belongs inside the
  compiled program.

The dataflow is local and deliberately shallow — silence over noise. JAX: a
name becomes "device" when assigned from ``jnp.*``/``jax.*`` (except the
host-returning calls), from a compiled-program attribute call
(``self._*_fn(...)``), or by indexing another device value. torch: see
:class:`_TorchFnChecker`.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Optional, Union

from .core import Finding, Project, SourceFile, dotted_name

# jnp/jax calls that already return host values — not device producers
_HOST_RETURNING = {"jax.device_get", "jnp.save", "jax.debug.print"}
_DEVICE_ROOTS = ("jnp.", "jax.numpy.", "jax.lax.", "jax.nn.", "jax.random.")


def _hot_functions(spec, sf: SourceFile) -> Optional[object]:
    for pattern, funcs in spec.items():
        if fnmatch.fnmatch(sf.rel, pattern):
            return funcs
    return None


def _selected(funcs, name: str) -> bool:
    if funcs == "*":
        return True
    if funcs and funcs[0] == "*":
        return f"!{name}" not in funcs
    return any(name == f or (f.endswith("_") and name.startswith(f))
               for f in funcs)


class _FnChecker:
    """The reference's checker (JAX dialect), its catalogues from the
    configuration."""

    def __init__(self, sf: SourceFile, fn: Union[ast.FunctionDef,
                                                 ast.AsyncFunctionDef],
                 qual: str, findings: list, cfg) -> None:
        self.sf = sf
        self.fn = fn
        self.qual = qual
        self.findings = findings
        self.cfg = cfg
        self.device_vars: set[str] = set()
        self.loop_depth = 0

    def _emit(self, check: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(
            check, self.sf.rel, node.lineno, f"{self.qual}: {msg}",
            end_line=getattr(node, "end_lineno", node.lineno)))

    def _is_device_expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.device_vars
        if isinstance(node, ast.Subscript):
            return self._is_device_expr(node.value)
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if name in _HOST_RETURNING:
                return False
            if name.startswith(_DEVICE_ROOTS):
                return True
            # compiled-program handles: self._unified_fn(...), self._verify_fn(...)
            return name.startswith("self._") and name.endswith("_fn")
        if isinstance(node, ast.Attribute):
            return self._is_device_expr(node.value)
        if isinstance(node, ast.BinOp):
            return (self._is_device_expr(node.left)
                    or self._is_device_expr(node.right))
        return False

    def check(self) -> None:
        self._body(self.fn.body)

    def _body(self, stmts) -> None:
        for st in stmts:
            self._stmt(st)

    def _assign(self, st: ast.Assign) -> None:
        self._expr(st.value)
        devicey = self._is_device_expr(st.value)
        for tgt in st.targets:
            if isinstance(tgt, ast.Name):
                (self.device_vars.add if devicey
                 else self.device_vars.discard)(tgt.id)
            elif isinstance(tgt, ast.Tuple) and devicey:
                for elt in tgt.elts:
                    if isinstance(elt, ast.Name):
                        self.device_vars.add(elt.id)

    def _stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._expr(st.iter)
            self._check_token_loop(st)
            self.loop_depth += 1
            self._body(st.body)
            self._body(st.orelse)
            self.loop_depth -= 1
        elif isinstance(st, ast.While):
            self._expr(st.test)
            self.loop_depth += 1
            self._body(st.body)
            self._body(st.orelse)
            self.loop_depth -= 1
        elif isinstance(st, ast.If):
            if self._is_device_expr(st.test):
                self._emit("hot-implicit-bool", st.test,
                           "branch on a device value forces a device->host "
                           "sync; compare on host state or fold the branch "
                           "into the compiled program")
            self._expr(st.test)
            self._body(st.body)
            self._body(st.orelse)
        elif isinstance(st, ast.Assign):
            self._assign(st)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._body(st.body)  # nested helpers inherit hot-path rules
        elif isinstance(st, ast.Try):
            self._body(st.body)
            for h in st.handlers:
                self._body(h.body)
            self._body(st.orelse)
            self._body(st.finalbody)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._expr(item.context_expr)
            self._body(st.body)
        else:
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self._expr(child)
                elif isinstance(child, ast.stmt):
                    self._stmt(child)

    def _check_token_loop(self, st) -> None:
        it = st.iter
        if not (isinstance(it, ast.Call)
                and dotted_name(it.func) == "range" and it.args):
            return
        src = ast.dump(it.args[-1]).lower()
        if "token" in src:
            self._emit("hot-token-loop", st,
                       "Python-level per-token loop — per-token work belongs "
                       "inside the compiled program")

    def _expr(self, node: Optional[ast.AST]) -> None:
        if node is None:
            return
        if isinstance(node, ast.Call):
            self._call(node)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _jit(self, node: ast.Call, name: str) -> None:
        if self.loop_depth > 0:
            self._emit("hot-jit-in-loop", node,
                       f"'{name}' inside a loop — a fresh compiled "
                       f"callable per iteration (recompile storm)")
        else:
            self._emit("hot-jit-call", node,
                       f"'{name}' in a hot function — per-request "
                       f"tracing/compilation; build the program once at "
                       f"startup")

    def _call(self, node: ast.Call) -> None:
        name = dotted_name(node.func) or ""
        parts = name.split(".")
        if name in self.cfg.jit_call_names:
            self._jit(node, name)
        elif parts[-1] in self.cfg.sync_call_attrs and len(parts) > 1:
            self._emit("hot-host-sync", node,
                       f"'.{parts[-1]}()' is a device->host sync")
        elif name in self.cfg.sync_call_names:
            self._emit("hot-host-sync", node,
                       f"'{name}' copies device memory to host")
        elif name in ("float", "int", "bool") and node.args \
                and self._is_device_expr(node.args[0]):
            self._emit("hot-host-sync", node,
                       f"'{name}()' on a device value is an implicit "
                       f"device->host sync")
        for a in node.args:
            self._expr(a)
        for kw in node.keywords:
            self._expr(kw.value)


# ------------------------------------------------------------ torch dialect

DEVICE, MASK, HOST = "device", "mask", "host"  # MASK: a device boolean tensor

_TENSOR_ANNOTATIONS = {"torch.Tensor", "Tensor"}
_HOST_ANNOTATIONS = {"np.ndarray", "numpy.ndarray", "int", "float", "bool",
                     "str"}
# torch factories: device values only when given a device other than "cpu"
_FACTORIES = {"empty", "zeros", "ones", "full", "arange", "tensor", "as_tensor",
              "randn", "rand", "randint", "linspace", "eye", "empty_strided"}
# torch calls that return no tensor, or a host one
_TORCH_NOT_DEVICE = {"torch.from_numpy", "torch.is_tensor", "torch.finfo",
                     "torch.iinfo", "torch.device", "torch.Generator",
                     "torch.Size", "torch.no_grad", "torch.inference_mode",
                     "torch.get_default_dtype", "torch.manual_seed",
                     "torch.is_floating_point", "torch.numel",
                     "torch.get_num_threads", "torch.set_num_threads"}
_MASK_FNS = {"isnan", "isinf", "isfinite", "logical_and", "logical_or",
             "logical_not", "logical_xor", "eq", "ne", "lt", "le", "gt", "ge",
             "bool", "isin", "isclose", "signbit"}
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "is_sparse"}
_HOST_BUILTINS = {"len", "int", "float", "bool", "str", "range", "list",
                  "tuple", "dict", "set", "sum", "min", "max", "abs", "round",
                  "sorted", "zip", "enumerate", "isinstance", "hasattr",
                  "getattr", "id", "repr", "any", "all", "divmod", "hash"}
# calls whose output shape depends on the data: the host reads the device
_DATA_SHAPED = {"nonzero", "unique", "masked_select", "unique_consecutive",
                "argwhere"}
_TO_HOST_METHODS = {"cpu", "numpy", "tolist", "item"}
# tensor methods that answer from the tensor's metadata, on the host
_META_METHODS = {"numel", "dim", "size", "element_size", "nelement", "data_ptr",
                 "stride", "is_contiguous", "storage_offset", "get_device",
                 "is_pinned", "is_floating_point", "is_complex", "untyped_storage"}


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"``, ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and dotted_name(node.func) == "torch.device":
        return bool(node.args) and _is_cpu(node.args[0])
    return False


def _kw(node: ast.Call, name: str) -> Optional[ast.AST]:
    for k in node.keywords:
        if k.arg == name:
            return k.value
    return None


class _TorchFnChecker(_FnChecker):
    """The port's dataflow. A name is a device value (DEVICE, or MASK for a
    device boolean tensor) when assigned from:

    * a parameter annotated ``torch.Tensor``;
    * a ``torch.*`` / ``F.*`` call that returns a tensor (a factory only with
      a ``device=`` other than ``"cpu"``; any call with a device argument);
    * a tensor method on a device value, indexing or an arithmetic of one;
    * a program call (``LintConfig.program_calls``: ``self._op(...)``), a
      compiled-program handle ``self._*_fn(...)``, or a CUDA graph's
      ``.replay()``.

    Host values (HOST): ``np.*`` results, ``torch.from_numpy``, factories
    without a device, what ``.cpu()`` / ``.numpy()`` / ``.tolist()`` /
    ``.item()`` returned (the pinned buffers the engine reads after their
    event: ``host = rec["host"].numpy()``), literals, ``len``/``int``/...,
    parameters annotated as numpy arrays or scalars. Anything else is
    unknown, and an unknown value's ``.tolist()``, ``np.array`` or ``int()``
    is not a finding: a host list is the common case."""

    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        self.kinds: dict[str, str] = {}
        self.aliases = _from_imports(self.sf)
        args = self.fn.args
        for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
            ann = a.annotation
            name = (ann.value if isinstance(ann, ast.Constant)
                    and isinstance(ann.value, str) else dotted_name(ann)
                    if ann is not None else None)
            if name in _TENSOR_ANNOTATIONS:
                self.kinds[a.arg] = DEVICE
            elif name in _HOST_ANNOTATIONS:
                self.kinds[a.arg] = HOST

    # -- classification ----------------------------------------------------
    def _kind(self, node: Optional[ast.AST]) -> Optional[str]:
        if node is None:
            return None
        if isinstance(node, ast.Name):
            return self.kinds.get(node.id)
        if isinstance(node, (ast.Constant, ast.JoinedStr, ast.Dict,
                             ast.ListComp, ast.DictComp, ast.SetComp)):
            return HOST
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            kinds = [self._kind(e) for e in node.elts]
            if any(k in (DEVICE, MASK) for k in kinds):
                return DEVICE
            return HOST if all(k == HOST for k in kinds) else None
        if isinstance(node, ast.Subscript):
            k = self._kind(node.value)
            return DEVICE if k == MASK else k
        if isinstance(node, ast.Attribute):
            if node.attr in _META_ATTRS:
                return HOST
            k = self._kind(node.value)
            return k if k in (DEVICE, MASK, HOST) else None
        if isinstance(node, ast.BinOp):
            l, r = self._kind(node.left), self._kind(node.right)
            if MASK in (l, r) and isinstance(node.op, (ast.BitAnd, ast.BitOr,
                                                       ast.BitXor)):
                return MASK
            if l in (DEVICE, MASK) or r in (DEVICE, MASK):
                return DEVICE
            return HOST if l == r == HOST else None
        if isinstance(node, ast.UnaryOp):
            k = self._kind(node.operand)
            if isinstance(node.op, ast.Not):
                return HOST
            return MASK if k == MASK or (k == DEVICE and isinstance(
                node.op, ast.Invert)) else k
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return HOST
            kinds = [self._kind(node.left)] + [self._kind(c)
                                               for c in node.comparators]
            if any(k in (DEVICE, MASK) for k in kinds):
                return MASK
            return HOST if all(k == HOST for k in kinds) else None
        if isinstance(node, ast.IfExp):
            a, b = self._kind(node.body), self._kind(node.orelse)
            if DEVICE in (a, b) or MASK in (a, b):
                return DEVICE
            return HOST if a == b == HOST else None
        if isinstance(node, ast.Call):
            return self._call_kind(node)
        return None

    def _call_kind(self, node: ast.Call) -> Optional[str]:
        name = dotted_name(node.func) or ""
        func = node.func
        if name in self.cfg.program_calls or (
                name.startswith("self._") and name.endswith("_fn")):
            return DEVICE
        if name.startswith(("np.", "numpy.")):
            return HOST
        if name in _HOST_BUILTINS:
            return HOST
        if name.startswith(("torch.", "F.", "torch.nn.functional.")):
            if name in _TORCH_NOT_DEVICE or name.startswith(("torch.cuda.",
                                                             "torch.distributed.")):
                return HOST if name == "torch.from_numpy" else None
            leaf = name.split(".")[-1]
            dev = _kw(node, "device")
            if leaf in _FACTORIES:
                if dev is not None and not _is_cpu(dev):
                    return DEVICE
                return HOST
            if leaf.endswith("_like") and node.args:
                if dev is not None:
                    return HOST if _is_cpu(dev) else DEVICE
                return self._kind(node.args[0])
            kinds = [self._kind(a) for a in node.args]
            if kinds and all(k == HOST for k in kinds) and dev is None:
                return HOST
            return MASK if leaf in _MASK_FNS else DEVICE
        if isinstance(func, ast.Attribute):
            recv = self._kind(func.value)
            meth = func.attr
            if meth in _TO_HOST_METHODS or meth in _META_METHODS:
                return HOST
            if meth == "to" and (any(_is_cpu(a) for a in node.args)
                                 or _is_cpu(_kw(node, "device") or ast.Constant(None))):
                return HOST
            if meth == "replay":
                return DEVICE
            if recv in (DEVICE, MASK):
                return MASK if meth in _MASK_FNS else DEVICE
            if recv == HOST:
                return HOST
        return None

    def _is_device_expr(self, node: ast.AST) -> bool:
        return self._kind(node) in (DEVICE, MASK)

    # -- statements ----------------------------------------------------------
    def _bind(self, tgt: ast.AST, kind: Optional[str]) -> None:
        if isinstance(tgt, ast.Name):
            if kind is None:
                self.kinds.pop(tgt.id, None)
            else:
                self.kinds[tgt.id] = kind
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:  # unpacking a device value gives device rows
                self._bind(elt, DEVICE if kind == MASK else kind)
        elif isinstance(tgt, ast.Starred):
            self._bind(tgt.value, None)
        else:  # subscript / attribute store: a masked store syncs too
            self._expr(tgt)

    def _assign(self, st: ast.Assign) -> None:
        self._expr(st.value)
        for tgt in st.targets:
            if isinstance(tgt, (ast.Tuple, ast.List)) and isinstance(
                    st.value, (ast.Tuple, ast.List)) and len(tgt.elts) == len(st.value.elts):
                for t, v in zip(tgt.elts, st.value.elts):
                    self._bind(t, self._kind(v))
            else:
                self._bind(tgt, self._kind(st.value))

    def _stmt(self, st: ast.stmt) -> None:
        if isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._expr(st.value)
                self._bind(st.target, self._kind(st.value))
            return
        if isinstance(st, ast.AugAssign):
            self._expr(st.value)
            if not isinstance(st.target, ast.Name):
                self._expr(st.target)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._bind(st.target, None)
        super()._stmt(st)

    # -- expressions -----------------------------------------------------------
    def _expr(self, node: Optional[ast.AST]) -> None:
        if isinstance(node, ast.Subscript) and self._kind(node.value) in (DEVICE, MASK) \
                and self._kind(node.slice) == MASK:
            self._emit("hot-host-sync", node,
                       "indexing with a device boolean mask: the result's "
                       "size is read from the device (device->host sync)")
        if isinstance(node, ast.Lambda):
            return  # built here, run elsewhere
        super()._expr(node)

    def _call(self, node: ast.Call) -> None:
        name = dotted_name(node.func) or ""
        head, _, rest = name.partition(".")
        if head in self.aliases:  # from x.y import load -> x.y.load
            name = self.aliases[head] + ("." + rest if rest else "")
        func = node.func
        meth = func.attr if isinstance(func, ast.Attribute) else None
        recv = self._kind(func.value) if meth else None
        first = self._kind(node.args[0]) if node.args else None
        msg = None
        if name in self.cfg.jit_call_names or meth in self.cfg.jit_call_attrs:
            self._jit(node, name or f".{meth}")
        elif name in self.cfg.sync_call_names and name.startswith("torch."):
            msg = f"'{name}' waits for the device"
        elif meth == "synchronize":
            msg = "'.synchronize()' waits for the device"
        elif meth in ("item", "cpu") and recv != HOST:
            msg = f"'.{meth}()' is a device->host sync"
        elif meth in ("tolist", "numpy") and recv in (DEVICE, MASK):
            msg = f"'.{meth}()' of a device value is a device->host sync"
        elif meth == "to" and recv != HOST and (
                any(_is_cpu(a) for a in node.args)
                or _is_cpu(_kw(node, "device") or ast.Constant(None))):
            msg = "'.to(\"cpu\")' is a device->host sync"
        elif name in self.cfg.sync_call_names and first in (DEVICE, MASK):
            msg = f"'{name}' of a device value copies device memory to host"
        elif name in ("float", "int", "bool") and first in (DEVICE, MASK):
            msg = f"'{name}()' on a device value is an implicit device->host sync"
        elif name.startswith("torch.") and name.split(".")[-1] in _DATA_SHAPED \
                and first != HOST:
            msg = f"'{name}' sizes its output from the data (device->host sync)"
        elif meth in _DATA_SHAPED and recv in (DEVICE, MASK):
            msg = f"'.{meth}()' sizes its output from the data (device->host sync)"
        elif (name == "torch.repeat_interleave" or meth == "repeat_interleave") \
                and _kw(node, "output_size") is None:
            data = first if name == "torch.repeat_interleave" else recv
            reps = node.args[1] if name == "torch.repeat_interleave" and len(node.args) > 1 \
                else node.args[0] if meth and node.args else _kw(node, "repeats")
            if data != HOST and self._kind(reps) != HOST:
                msg = ("'repeat_interleave' with tensor repeats and no output_size "
                       "sizes its output from the data (device->host sync)")
        if msg:
            self._emit("hot-host-sync", node, msg)
        if meth:
            self._expr(func.value)
        for a in node.args:
            self._expr(a)
        for kw in node.keywords:
            self._expr(kw.value)


def _from_imports(sf: SourceFile) -> dict:
    """Local name -> dotted origin of every absolute ``from m import n`` in
    the file (function-level imports included)."""
    out = getattr(sf, "_from_imports", None)
    if out is None:
        out = {}
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        sf._from_imports = out
    return out


def _checker(cfg):
    return _TorchFnChecker if cfg.dialect == "torch" else _FnChecker


def run(project: Project, hot_paths: Optional[dict] = None) -> list[Finding]:
    cfg = project.config
    spec = cfg.hot_paths if hot_paths is None else hot_paths
    make = _checker(cfg)
    findings: list[Finding] = []
    for sf in project.files():
        funcs = _hot_functions(spec, sf)
        if funcs is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and _selected(funcs, item.name):
                    make(sf, item, f"{node.name}.{item.name}", findings,
                         cfg).check()
        for item in sf.tree.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and _selected(funcs, item.name):
                make(sf, item, item.name, findings, cfg).check()
    return findings
