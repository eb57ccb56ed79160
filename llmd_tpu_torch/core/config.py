"""Plugin-graph configuration (the EndpointPickerConfig; copy of
``llmd_tpu/core/config.py``).

One YAML document declares plugin instances (nodes) and wires them into
``schedulingProfiles``, ``flowControl``, ``saturationDetector``, ``dataLayer``,
``parser`` and ``featureGates``. Validation: every reference resolves, instance
names are unique, band priorities and profile names are unique. Defaulting: a
``default`` profile over every declared plugin when none is declared, and a
``max-score`` picker injected into any profile lacking a picker. The config is
read once at startup.

The card's Python has no PyYAML, so :func:`load_yaml` reads the subset of YAML
that EPP configs use, with PyYAML's ``safe_load`` results: block and flow
mappings and sequences, plain scalars resolved as YAML 1.1 does (null, bool,
int, float, else str), single- and double-quoted scalars, comments and one
leading ``---``, and literal block scalars (``|``, ``|-``, ``|+``: a
ConfigMap's embedded file). Anything outside the subset (anchors, aliases,
tags, folded block scalars and indentation indicators, multi-line plain
scalars, timestamps, sexagesimal numbers, several documents) raises
``ConfigError`` with its line number; nothing is mis-read in silence. :func:`load_yaml_all` reads several documents of the subset, as
``yaml.safe_load_all`` does (the manifests of ``core/crds.py``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional

class ConfigError(ValueError):
    pass


# -- the YAML subset ---------------------------------------------------------
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL_TRUE = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_BOOL_FALSE = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(r"""^(?:(?P<bin>[-+]?0b[0-1_]+)
                    |(?P<oct>[-+]?0[0-7_]+)
                    |(?P<dec>[-+]?(?:0|[1-9][0-9_]*))
                    |(?P<hex>[-+]?0x[0-9a-fA-F_]+))$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$""", re.X)
_FLOAT_SPECIAL = re.compile(r"^(?:(?P<inf>[-+]?\.(?:inf|Inf|INF))|\.(?:nan|NaN|NAN))$")
# resolved by PyYAML to types the subset does not carry: refused, not guessed
_OUTSIDE = re.compile(r"""^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
                    |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt ].*)?
                    |<<|=)$""", re.X)
_INDICATORS = "&*!|>%@`?"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}


def _resolve_plain(text: str, line: int) -> Any:
    if _NULL.match(text):
        return None
    if _BOOL_TRUE.match(text):
        return True
    if _BOOL_FALSE.match(text):
        return False
    m = _INT.match(text)
    if m:
        s = text.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if m.group("bin"):
            return sign * int(s[2:], 2)
        if m.group("hex"):
            return sign * int(s[2:], 16)
        if m.group("oct"):
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    m = _FLOAT_SPECIAL.match(text)
    if m:
        if m.group("inf"):
            return float("-inf") if text[0] == "-" else float("inf")
        return float("nan")
    if _OUTSIDE.match(text):
        raise ConfigError(f"line {line}: {text!r} is outside the YAML subset "
                          "(timestamps, sexagesimal numbers and merge keys are not read)")
    return text


class _Flow:
    """Reader of one flow collection or scalar inside ``text`` (a flow value
    may span lines: ``text`` is the lines joined, ``line`` the first one)."""

    def __init__(self, text: str, line: int) -> None:
        self.s, self.i, self.line = text, 0, line

    def error(self, what: str) -> ConfigError:
        return ConfigError(f"line {self.line}: {what} (column {self.i + 1})")

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def value(self, ends: str) -> Any:
        self.ws()
        if self.i >= len(self.s):
            raise self.error("value expected")
        c = self.s[self.i]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.map()
        if c in "'\"":
            return self.quoted()
        return self.plain(ends)

    def seq(self) -> list:
        self.i += 1
        out: list = []
        while True:
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == "]":
                self.i += 1
                return out
            item = self.value(",]")
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == ":":
                raise self.error("single-pair mappings in a flow sequence are outside the subset")
            out.append(item)
            self.sep("]")

    def map(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == "}":
                self.i += 1
                return out
            key = self.value(",}:")
            if isinstance(key, (list, dict)):
                raise self.error("collection keys are outside the subset")
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == ":":
                self.i += 1
                self.ws()
                if self.i < len(self.s) and self.s[self.i] in ",}":
                    out[key] = None
                else:
                    out[key] = self.value(",}")
            else:
                out[key] = None
            self.sep("}")

    def sep(self, close: str) -> None:
        self.ws()
        if self.i >= len(self.s):
            raise self.error(f"unterminated flow collection (missing {close!r})")
        c = self.s[self.i]
        if c == ",":
            self.i += 1
        elif c != close:
            raise self.error(f"expected ',' or {close!r}, found {c!r}")

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise self.error("unterminated quoted scalar")
            c = self.s[self.i]
            if c == q:
                if q == "'" and self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if c == "\n":
                raise self.error("multi-line quoted scalars are outside the subset")
            if q == '"' and c == "\\":
                esc = self.s[self.i + 1:self.i + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    self.i += 2
                    continue
                width = {"x": 2, "u": 4, "U": 8}.get(esc)
                digits = self.s[self.i + 2:self.i + 2 + (width or 0)]
                if width is None or not re.fullmatch(r"[0-9a-fA-F]+", digits or "-") \
                        or len(digits) != width:
                    raise self.error(f"unknown escape \\{esc}")
                out.append(chr(int(digits, 16)))
                self.i += 2 + width
                continue
            out.append(c)
            self.i += 1

    def plain(self, ends: str) -> Any:
        start = self.i
        if self.s[start] in _INDICATORS or self.s[start:start + 2] in ("- ", "-\n"):
            raise self.error(f"{self.s[start]!r} starts something outside the subset "
                             "(anchors, aliases, tags, block scalars, complex keys)")
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in ends and c != ":":
                break
            if c == ":" and ":" in ends and (self.i + 1 == len(self.s)
                                              or self.s[self.i + 1] in " \t\n,[]{}"):
                break
            if c == "#" and self.i > start and self.s[self.i - 1] in " \t":
                break
            if c in "[]{}" and ends != "":
                raise self.error(f"{c!r} inside a plain scalar")
            self.i += 1
        text = self.s[start:self.i].strip()
        if "\n" in text:
            raise self.error("multi-line plain scalars are outside the subset")
        return _resolve_plain(text, self.line)


def _outside_quotes(text: str, openers: str):
    """(index, char) of each character of ``text`` outside quoted scalars. A
    quote opens at the start or after one of ``openers``; inside a
    single-quoted scalar ``''`` is an escaped quote, inside a double-quoted
    one a backslash escapes the next character."""
    quote, i = None, 0
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    i += 1  # '' inside '...': a literal quote
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in openers):
            quote = c
        else:
            yield i, c
        i += 1


def _strip_comment(text: str) -> str:
    """Drop a trailing comment: '#' at the start or after a blank, outside quotes."""
    for i, c in _outside_quotes(text, " \t[{,:-"):
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _depth(text: str) -> int:
    """Net bracket depth of a line (quotes skipped), to join multi-line flows."""
    depth = 0
    for _, c in _outside_quotes(text, " \t[{,:"):
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth


def _key_split(text: str) -> Optional[int]:
    """Index of the ':' that ends a block mapping key in ``text``, else None."""
    quote = None
    depth = 0
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
            continue
        if c in "'\"" and i == 0:
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] in " \t"):
            return i
    return None


# a literal block scalar's header ending a line: after "key:" or "-"
_BLOCK_SCALAR = re.compile(r"(?:^-|:)[ \t]+\|([-+]?)$|^-?[ \t]*\|([-+]?)$")
_BLOCK_MARK = "\x00"  # stands in the line for the scalar read from the raw lines


def _literal_block(raw: list[str], n: int, parent: int, chomp: str) -> tuple[str, int]:
    """The literal block scalar whose lines start at ``raw[n]``, more indented
    than ``parent``, and the index of the first line after it. Lines keep
    their text past the block's indent (comments are content); ``chomp`` is
    the header's indicator: '' keeps one final newline, '-' none, '+' all."""
    body: list[str] = []
    indent = None
    while n < len(raw):
        ln = raw[n]
        if not ln.strip():
            body.append("")
            n += 1
            continue
        ind = len(ln) - len(ln.lstrip(" "))
        if indent is None:
            if ind <= parent:
                break
            indent = ind
        if ind < indent:
            break
        body.append(ln[indent:])
        n += 1
    last = len(body)
    while last and not body[last - 1]:
        last -= 1
    trailing = len(body) - last  # blank lines after the content
    if not last:
        return ("\n" * trailing if chomp == "+" else ""), n
    text = "\n".join(body[:last])
    end = "" if chomp == "-" else "\n" * (trailing + 1) if chomp == "+" else "\n"
    return text + end, n


class _Block:
    def __init__(self, text: str) -> None:
        for n, ln in enumerate(text.splitlines(), 1):
            if "\t" in ln[:len(ln) - len(ln.lstrip(" \t"))]:
                raise ConfigError(f"line {n}: tabs in indentation")
        self.lines: list[tuple[int, int, str]] = []  # (line number, indent, text)
        self.scalars: dict[int, str] = {}  # line number -> its literal block scalar
        raw = text.splitlines()
        n = 0
        seen_doc = False
        while n < len(raw):
            body = _strip_comment(raw[n])
            n += 1
            stripped = body.strip()
            if not stripped:
                continue
            block = _BLOCK_SCALAR.search(stripped)
            if block is not None:
                indent = len(body) - len(body.lstrip(" "))
                self.scalars[n], after = _literal_block(
                    raw, n, indent, block.group(1) or block.group(2) or "")
                self.lines.append((n, indent, stripped[:stripped.rindex("|")] + _BLOCK_MARK))
                n = after
                continue
            if body.startswith("%"):
                raise ConfigError(f"line {n}: directives are outside the YAML subset")
            if stripped in ("---", "...") or body.startswith("--- ") or body.startswith("... "):
                if stripped != "---" or seen_doc or self.lines:
                    raise ConfigError(f"line {n}: several documents, or document markers "
                                      "after content, are outside the YAML subset")
                seen_doc = True
                continue
            first = n
            depth = _depth(body)
            while depth > 0 and n < len(raw):
                more = _strip_comment(raw[n])
                n += 1
                body = body + "\n" + more
                depth += _depth(more)
            self.lines.append((first, len(body) - len(body.lstrip(" ")), body.strip()))
        self.pos = 0

    def peek(self) -> Optional[tuple[int, int, str]]:
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def parse(self) -> Any:
        if not self.lines:
            return None
        value = self.node()
        if self.peek() is not None:
            raise ConfigError(f"line {self.peek()[0]}: content after the document's "
                              "top-level node (bad indentation)")
        return value

    def node(self) -> Any:
        """The node starting at the current line, at that line's indent."""
        ln, ind, text = self.peek()
        if text == "-" or text.startswith("- "):
            return self.seq(ind)
        if _key_split(text) is not None:
            return self.map(ind)
        self.pos += 1
        value = self.inline(text, ln)
        nxt = self.peek()
        if nxt is not None and nxt[1] > ind:
            raise ConfigError(f"line {nxt[0]}: multi-line plain scalars are outside the subset")
        return value

    def inline(self, text: str, line: int) -> Any:
        if text == _BLOCK_MARK:
            return self.scalars[line]
        f = _Flow(text, line)
        value = f.value("")
        f.ws()
        if f.i != len(f.s):
            raise f.error(f"unexpected {f.s[f.i:f.i + 10]!r} after the value")
        return value

    def after_key(self, indent: int) -> Any:
        """The value of a key with nothing after its ':' on the line."""
        nxt = self.peek()
        if nxt is None:
            return None
        if nxt[1] > indent:
            return self.node()
        if nxt[1] == indent and (nxt[2] == "-" or nxt[2].startswith("- ")):
            return self.seq(indent)  # compact sequence under a key
        return None

    def map(self, indent: int) -> dict:
        out: dict = {}
        while True:
            nxt = self.peek()
            if nxt is None or nxt[1] < indent:
                return out
            ln, ind, text = nxt
            if ind > indent:
                raise ConfigError(f"line {ln}: bad indentation in a mapping")
            if text == "-" or text.startswith("- "):
                if out:
                    return out  # a compact sequence of the parent
                raise ConfigError(f"line {ln}: a sequence entry where a mapping key was expected")
            k = _key_split(text)
            if k is None:
                raise ConfigError(f"line {ln}: expected 'key: value'")
            self.pos += 1
            key = self.inline(text[:k].strip(), ln)
            if isinstance(key, (list, dict)):
                raise ConfigError(f"line {ln}: collection keys are outside the subset")
            rest = text[k + 1:].strip()
            if rest:
                out[key] = self.inline(rest, ln)
                nxt = self.peek()
                if nxt is not None and nxt[1] > indent:
                    raise ConfigError(f"line {nxt[0]}: multi-line plain scalars are "
                                      "outside the subset")
            else:
                out[key] = self.after_key(indent)

    def seq(self, indent: int) -> list:
        out: list = []
        while True:
            nxt = self.peek()
            if nxt is None or nxt[1] < indent:
                return out
            ln, ind, text = nxt
            if ind > indent:
                raise ConfigError(f"line {ln}: bad indentation in a sequence")
            if not (text == "-" or text.startswith("- ")):
                return out
            rest = text[1:].lstrip(" ")
            if not rest:
                self.pos += 1
                nxt = self.peek()
                out.append(self.node() if nxt is not None and nxt[1] > indent else None)
                continue
            # the entry's content sits at its own column: re-read it as a line there
            self.lines[self.pos] = (ln, ind + len(text) - len(rest), rest)
            out.append(self.node())


def load_yaml(text: str) -> Any:
    """``yaml.safe_load`` for the subset EPP configs use (see the module
    docstring); raises ``ConfigError`` naming the line of anything else."""
    return _Block(text).parse()


_DOC_START = re.compile(r"^---[ \t]*(?:#.*)?$")
_DOC_END = re.compile(r"^\.\.\.[ \t]*(?:#.*)?$")


def load_yaml_all(text: str) -> list:
    """``list(yaml.safe_load_all(text))`` for the same subset: the documents
    split at ``---`` lines (an empty one reads as None; content before the
    first marker is a document only when it is not blank or comments), a
    ``...`` line ending a document. Each document is read by ``load_yaml``
    with the lines of the others blanked, so an error names its line in
    ``text``."""
    lines = text.splitlines()
    starts = [i for i, ln in enumerate(lines) if _DOC_START.match(ln)]
    bounds = list(zip([-1] + starts, starts + [len(lines)]))
    docs = []
    for k, (lo, hi) in enumerate(bounds):
        body = lines[lo + 1:hi]
        end = next((i for i, ln in enumerate(body) if _DOC_END.match(ln)), None)
        if end is not None:
            after = [j for j in range(end + 1, len(body)) if _strip_comment(body[j]).strip()]
            if after:
                raise ConfigError(f"line {lo + 2 + after[0]}: content after a document's "
                                  "'...' is outside the YAML subset")
            body = body[:end]
        if k == 0 and lo < 0 and not any(_strip_comment(ln).strip() for ln in body):
            continue  # only blanks or comments before the first marker
        docs.append(_Block("\n" * (lo + 1) + "\n".join(body)).parse())
    return docs


@dataclass
class PluginSpec:
    name: str
    type: str
    params: dict[str, Any] = field(default_factory=dict)


@dataclass
class ProfilePluginRef:
    plugin_ref: str
    weight: float = 1.0


@dataclass
class SchedulingProfileSpec:
    name: str
    plugins: list[ProfilePluginRef] = field(default_factory=list)


@dataclass
class PriorityBandSpec:
    """Flow-control priority band (flow-control.md:242-254)."""

    priority: int
    name: str = ""
    max_bytes: int = 1 << 30
    max_requests: int = 10000
    fairness_policy: str = "round-robin"  # or "global-strict"
    ordering_policy: str = "fcfs"  # or "edf", "slo-deadline"
    ttl_s: float = 60.0


@dataclass
class FlowControlSpec:
    enabled: bool = False
    bands: list[PriorityBandSpec] = field(default_factory=list)
    saturation_detector: str = "utilization-detector"


@dataclass
class FrameworkConfig:
    plugins: list[PluginSpec] = field(default_factory=list)
    scheduling_profiles: list[SchedulingProfileSpec] = field(default_factory=list)
    profile_handler: str = "single-profile"
    flow_control: FlowControlSpec = field(default_factory=FlowControlSpec)
    parser: str = "openai-parser"
    feature_gates: dict[str, bool] = field(default_factory=dict)
    data_sources: list[PluginSpec] = field(default_factory=list)
    raw: dict[str, Any] = field(default_factory=dict)

    def plugin(self, name: str) -> PluginSpec:
        for p in self.plugins:
            if p.name == name:
                return p
        raise ConfigError(f"unknown plugin ref {name!r}")

    @classmethod
    def from_yaml(cls, text: str, known_types: Optional[set[str]] = None) -> "FrameworkConfig":
        doc = load_yaml(text) or {}
        return cls.from_dict(doc, known_types)

    @classmethod
    def from_dict(cls, doc: dict[str, Any], known_types: Optional[set[str]] = None) -> "FrameworkConfig":
        cfg = cls(raw=doc)
        for p in doc.get("plugins", []) or []:
            if "type" not in p:
                raise ConfigError(f"plugin missing type: {p}")
            cfg.plugins.append(
                PluginSpec(name=p.get("name", p["type"]), type=p["type"],
                           params=p.get("params", {}) or {})
            )
        for prof in doc.get("schedulingProfiles", []) or []:
            refs = [
                ProfilePluginRef(plugin_ref=r["pluginRef"], weight=float(r.get("weight", 1.0)))
                for r in prof.get("plugins", []) or []
            ]
            cfg.scheduling_profiles.append(
                SchedulingProfileSpec(name=prof.get("name", "default"), plugins=refs)
            )
        cfg.profile_handler = doc.get("profileHandler", "single-profile")
        cfg.parser = doc.get("parser", "openai-parser")
        cfg.feature_gates = dict(doc.get("featureGates", {}) or {})
        fc = doc.get("flowControl", {}) or {}
        cfg.flow_control = FlowControlSpec(
            enabled=bool(fc.get("enabled", cfg.feature_gates.get("flowControl", False))),
            saturation_detector=fc.get("saturationDetector", "utilization-detector"),
            bands=[
                PriorityBandSpec(
                    priority=int(b["priority"]), name=b.get("name", str(b["priority"])),
                    max_bytes=int(b.get("maxBytes", 1 << 30)),
                    max_requests=int(b.get("maxRequests", 10000)),
                    fairness_policy=b.get("fairnessPolicy", "round-robin"),
                    ordering_policy=b.get("orderingPolicy", "fcfs"),
                    ttl_s=float(b.get("ttl", 60.0)),
                )
                for b in fc.get("bands", []) or []
            ],
        )
        for s in (doc.get("dataLayer") or {}).get("sources") or []:
            cfg.data_sources.append(
                PluginSpec(name=s.get("name", s["type"]), type=s["type"],
                           params=s.get("params", {}) or {})
            )
        cfg._validate(known_types)
        cfg._apply_defaults()
        return cfg

    def _validate(self, known_types: Optional[set[str]]) -> None:
        names = [p.name for p in self.plugins]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ConfigError(f"duplicate plugin names: {sorted(dupes)}")
        if known_types is not None:
            for p in self.plugins + self.data_sources:
                if p.type not in known_types:
                    raise ConfigError(f"unknown plugin type {p.type!r} (plugin {p.name!r})")
        nameset = set(names)
        for prof in self.scheduling_profiles:
            for ref in prof.plugins:
                if ref.plugin_ref not in nameset:
                    raise ConfigError(
                        f"profile {prof.name!r} references unknown plugin {ref.plugin_ref!r}"
                    )
        profs = [p.name for p in self.scheduling_profiles]
        if len(profs) != len(set(profs)):
            raise ConfigError("duplicate scheduling profile names")
        bands = [b.priority for b in self.flow_control.bands]
        if len(bands) != len(set(bands)):
            raise ConfigError("duplicate flow-control band priorities")

    def _apply_defaults(self) -> None:
        # Auto 'default' profile over every declared plugin (configuration.md:150-166).
        if not self.scheduling_profiles:
            self.scheduling_profiles.append(
                SchedulingProfileSpec(
                    name="default",
                    plugins=[ProfilePluginRef(plugin_ref=p.name) for p in self.plugins],
                )
            )
        # Auto max-score picker injection (scheduling.md:104-108).
        picker_types = {"max-score-picker", "random-picker", "weighted-random-picker"}
        by_name = {p.name: p for p in self.plugins}
        for prof in self.scheduling_profiles:
            has_picker = any(
                by_name.get(r.plugin_ref) and by_name[r.plugin_ref].type in picker_types
                for r in prof.plugins
            )
            if not has_picker:
                if "max-score-picker" not in by_name:
                    spec = PluginSpec(name="max-score-picker", type="max-score-picker")
                    self.plugins.append(spec)
                    by_name[spec.name] = spec
                prof.plugins.append(ProfilePluginRef(plugin_ref="max-score-picker"))


def load_config(path: str, known_types: Optional[set[str]] = None) -> FrameworkConfig:
    with open(path) as f:
        return FrameworkConfig.from_yaml(f.read(), known_types)
