"""llmd-lint core: the shared contract-lint framework (the port's copy of
``tools/llmd_lint/core.py``; standard library only).

Every analyzer (lock discipline, hot-path purity, env/config contract, and
the migrated metrics/events doc-contract linters) plugs into the same three
pieces:

* :class:`Project` — file discovery + a parse cache. One ``ast.parse`` per
  file per run, shared across analyzers, with the per-line annotation maps
  (``# guarded-by:`` / ``# llmd-lint: allow[...]``) the AST itself drops.
* :class:`Finding` — the uniform result model: ``check`` id, ``file:line``,
  message, and the allowlist disposition (``allowed`` + justification).
* the allowlist — inline ``# llmd-lint: allow[<check>] <justification>``
  comments for line-anchored findings, plus the central table in
  ``config.ALLOWLIST`` for findings that have no single line (lock-order
  cycles, contract-table rows). A justification string is MANDATORY in both
  forms; an empty one is itself a finding, and so is an allow entry that no
  longer matches anything (stale suppressions must not accumulate).

Analyzer modules expose ``run(project) -> list[Finding]``; the runner in
``__main__`` applies the allowlist, renders ``file:line`` text or ``--json``,
and exits non-zero on any unallowlisted finding.

What the reference fixes in module constants (discovery globs, hot-path set,
sync and blocking catalogues, contract sources, the allowlist) a
:class:`Project` carries here as its :class:`~.config.LintConfig`: the
default is the port's configuration (``config.PORT``), and the same code run
with the reference's values reproduces the reference suite's findings.
"""

from __future__ import annotations

import ast
import re
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING, Iterable, Optional, Sequence

if TYPE_CHECKING:
    from .config import LintConfig

REPO_ROOT = Path(__file__).resolve().parents[3]

# generated protobuf modules are machine-written and exempt from
# hand-written-code discipline
EXCLUDE_NAMES = ("_pb2.py",)

GUARDED_BY_PAT = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")
ALLOW_PAT = re.compile(r"#\s*llmd-lint:\s*allow\[([a-z][a-z0-9-]*)\]\s*(.*)$")


@dataclass
class Finding:
    """One analyzer result, anchored to a repo-relative ``file:line``."""

    check: str  # stable id, e.g. "lock-unguarded-write"
    file: str  # repo-relative path ("" for repo-level contract findings)
    line: int  # 1-based; 0 when the finding has no single line
    message: str
    end_line: int = 0  # last line of the flagged statement (allow-comment scan)
    allowed: bool = False
    justification: str = ""

    def location(self) -> str:
        return f"{self.file}:{self.line}" if self.file else "<repo>"

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class AllowEntry:
    """Central allowlist row for findings without a single source line.

    ``match`` is a substring of the finding message; ``justification`` is
    mandatory and echoed in the lint output next to the suppression.
    """

    check: str
    match: str
    justification: str
    used: bool = field(default=False, compare=False)


_PARSED: dict[tuple, "SourceFile"] = {}


class SourceFile:
    """One parsed module plus the line-level annotations ast drops."""

    def __init__(self, path: Path, root: Path) -> None:
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text(errors="replace")
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=self.rel)
        # line -> lock name from "# guarded-by: <lock>"
        self.guarded_by: dict[int, str] = {}
        # line -> [(check, justification), ...] from "# llmd-lint: allow[...]"
        self.allows: dict[int, list[tuple[str, str]]] = {}
        self._stmt_end: Optional[dict[int, int]] = None
        self._scan_annotations()

    @classmethod
    def load(cls, path: Path, root: Path) -> "SourceFile":
        """One parse per file version per process: projects over the same
        tree (a suite run, then its tests) share the trees."""
        st = path.stat()
        key = (str(path), str(root), st.st_mtime_ns, st.st_size)
        sf = _PARSED.get(key)
        if sf is None:
            sf = _PARSED[key] = cls(path, root)
        return sf

    @property
    def stmt_end(self) -> dict[int, int]:
        """stmt start line -> last line: an allow on a statement's first line
        covers the whole statement (multi-line call args, continuations).
        Built at the first use: only files with allows need it."""
        if self._stmt_end is None:
            self._stmt_end = {}
            for node in ast.walk(self.tree):
                if isinstance(node, ast.stmt) and node.end_lineno is not None:
                    self._stmt_end[node.lineno] = max(
                        self._stmt_end.get(node.lineno, 0), node.end_lineno)
        return self._stmt_end

    def _scan_annotations(self) -> None:
        """Attach each annotation comment to its own line; a standalone
        comment line annotates the next line that carries code instead."""
        pending: list[tuple[str, object]] = []  # ("guard"|"allow", payload)
        for i, line in enumerate(self.lines, start=1):
            stripped = line.strip()
            code = line.split("#", 1)[0].strip()
            gm = GUARDED_BY_PAT.search(line)
            am = ALLOW_PAT.search(line)
            if code:  # line carries code: annotations (incl. pending) land here
                for kind, payload in pending:
                    self._attach(kind, i, payload)
                pending = []
                if gm:
                    self._attach("guard", i, gm.group(1))
                if am:
                    self._attach("allow", i, (am.group(1), am.group(2).strip()))
            elif stripped.startswith("#") and (gm or am):
                if gm:
                    pending.append(("guard", gm.group(1)))
                if am:
                    pending.append(("allow", (am.group(1), am.group(2).strip())))

    def _attach(self, kind: str, line: int, payload) -> None:
        if kind == "guard":
            self.guarded_by[line] = payload
        else:
            self.allows.setdefault(line, []).append(payload)

    def covering_allow_lines(self, check: str, line: int,
                             end_line: int = 0) -> list[int]:
        """Attach-lines of allows for ``check`` whose statement span
        intersects [line, end_line]."""
        hi = max(line, end_line or line)
        out = []
        for ln, entries in self.allows.items():
            span_end = max(self.stmt_end.get(ln, ln), ln)
            if ln <= hi and span_end >= line \
                    and any(chk == check for chk, _ in entries):
                out.append(ln)
        return out

    def allow_for(self, check: str, line: int,
                  end_line: int = 0) -> Optional[tuple[str, str]]:
        """The (check, justification) allow covering any line of the flagged
        statement, or None."""
        for ln in self.covering_allow_lines(check, line, end_line):
            for chk, just in self.allows.get(ln, ()):
                if chk == check:
                    return chk, just
        return None


class Project:
    """File discovery + parse cache shared by every analyzer in a run.
    ``config`` defaults to the port's; ``globs`` overrides its discovery
    set."""

    def __init__(self, root: Path | str = REPO_ROOT,
                 globs: Optional[Sequence[str]] = None,
                 config: "Optional[LintConfig]" = None) -> None:
        from .config import PORT

        self.root = Path(root)
        self.config = config or PORT
        self.globs = tuple(globs or self.config.globs)
        self._cache: dict[str, SourceFile] = {}
        self._listed: dict[tuple, list[Path]] = {}
        self.syntax_errors: list[Finding] = []

    def paths(self, globs: Optional[Sequence[str]] = None) -> list[Path]:
        key = tuple(globs) if globs else self.globs
        if key not in self._listed:
            out: list[Path] = []
            for pattern in key:
                hits = ([self.root / pattern] if not any(c in pattern for c in "*?[")
                        else self.root.glob(pattern))
                for p in hits:
                    if (p.is_file() and p.suffix == ".py"
                            and not any(p.name.endswith(x) for x in EXCLUDE_NAMES)):
                        out.append(p)
            self._listed[key] = sorted(set(out))
        return self._listed[key]

    def files(self, globs: Optional[Sequence[str]] = None) -> list[SourceFile]:
        out = []
        for p in self.paths(globs):
            rel = p.relative_to(self.root).as_posix()
            if rel not in self._cache:
                try:
                    self._cache[rel] = SourceFile.load(p, self.root)
                except SyntaxError as e:  # unparseable source is its own finding
                    self.syntax_errors.append(Finding(
                        "syntax-error", rel, e.lineno or 0, str(e)))
                    continue
            out.append(self._cache[rel])
        return out

    def file(self, rel: str) -> Optional[SourceFile]:
        if rel not in self._cache:
            p = self.root / rel
            if not p.is_file():
                return None
            try:
                self._cache[rel] = SourceFile.load(p, self.root)
            except SyntaxError:
                return None
        return self._cache[rel]


def apply_inline_allows(project: Project, findings: list[Finding]) -> None:
    """Mark findings covered by an inline allow comment; an allow with an
    empty justification does NOT suppress — the runner reports it."""
    for f in findings:
        if not f.file or not f.line:
            continue
        sf = project.file(f.file)
        if sf is None:
            continue
        hit = sf.allow_for(f.check, f.line, f.end_line)
        if hit is not None and hit[1]:
            f.allowed = True
            f.justification = hit[1]


def apply_central_allowlist(findings: list[Finding],
                            entries: Iterable[AllowEntry]) -> None:
    for f in findings:
        if f.allowed:
            continue
        for entry in entries:
            if entry.check == f.check and entry.match in f.message:
                f.allowed = True
                f.justification = entry.justification
                entry.used = True
                break


def annotation_findings(project: Project,
                        findings: list[Finding]) -> list[Finding]:
    """Lint the allowlist itself: empty justifications and allows that no
    finding matched (stale suppressions) are findings of their own. Only
    meaningful when the full analyzer suite ran over ``project``."""
    out: list[Finding] = []
    matched: set[tuple[str, str, int]] = set()
    for f in findings:
        if f.allowed and f.file and f.line:
            sf = project.file(f.file)
            if sf is None:
                continue
            for ln in sf.covering_allow_lines(f.check, f.line, f.end_line):
                matched.add((f.file, f.check, ln))
    for sf in project.files():
        for ln, entries in sorted(sf.allows.items()):
            for check, just in entries:
                if not just:
                    out.append(Finding(
                        "allow-missing-justification", sf.rel, ln,
                        f"allow[{check}] has no justification — every "
                        f"suppression must say why", end_line=ln))
                elif (sf.rel, check, ln) not in matched:
                    out.append(Finding(
                        "allow-unused", sf.rel, ln,
                        f"allow[{check}] matches no finding — stale "
                        f"suppression, remove it", end_line=ln))
    return out


# --------------------------------------------------------------- AST helpers

def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, None for anything dynamic."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
