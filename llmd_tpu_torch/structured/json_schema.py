"""JSON Schema -> regex translation (+ a matching subset validator).

A copy of ``llmd_tpu/structured/json_schema.py`` (numpy and the standard library only); tests hold
it against the original.

The Outlines recipe (Willard & Louf 2023): lower a schema to a regular
expression describing its *serialized* form, then compile that through
``regex_dfa``. The emitted language is compact JSON — no inter-token
whitespace — which keeps the DFA small and, more importantly, keeps greedy
decoding from parking on a whitespace self-loop forever.

Supported subset (anything else raises ``ValueError`` -> HTTP 400):

* ``type``: string (minLength/maxLength/pattern), integer, number, boolean,
  null, object, array; a list of types becomes an alternation
* ``enum`` / ``const`` of scalars
* object: ``properties`` emitted in declaration order; when ``required`` is
  present, exactly the required properties are emitted (optional-property
  comma placement is the classic DFA blow-up — out of scope)
* array: ``items`` schema with ``minItems``/``maxItems``

``validate_instance`` checks a parsed value against the same subset, so
tests and ``tools/structured_check.py`` can assert corpus validity without a
jsonschema dependency (the image does not ship one).
"""

from __future__ import annotations

import json
import os

from llmd_tpu_torch.structured.regex_dfa import MAX_REPEAT, escape_literal

# JSON string *content* chars: the universe minus `"`, `\`, and the raw
# control chars JSON forbids unescaped (we never emit escape sequences).
_STR_CHAR = '[^"\\\\\\t\\n\\r]'
_INTEGER = "-?(0|[1-9][0-9]*)"
_NUMBER = r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?"

# Generic `response_format: {"type": "json_object"}` has no schema to guide
# it; a DFA cannot count brackets, so nesting is bounded (XGrammar's pushdown
# avoids this; a depth-bounded FSM is the honest regex-only version).
DEFAULT_JSON_DEPTH = 3


def json_object_depth() -> int:
    try:
        return max(1, int(os.environ.get("LLMD_STRUCTURED_JSON_DEPTH",
                                         str(DEFAULT_JSON_DEPTH))))
    except ValueError:
        return DEFAULT_JSON_DEPTH


def _string_regex(schema: dict) -> str:
    if "pattern" in schema:
        pat = str(schema["pattern"])
        return '"' + pat.lstrip("^").rstrip("$") + '"'
    lo = int(schema.get("minLength", 0))
    hi = schema.get("maxLength")
    if hi is None:
        body = f"{_STR_CHAR}*" if lo == 0 else f"{_STR_CHAR}{{{lo},}}"
    else:
        if int(hi) > MAX_REPEAT:
            raise ValueError(f"maxLength {hi} exceeds supported {MAX_REPEAT}")
        body = f"{_STR_CHAR}{{{lo},{int(hi)}}}"
    return f'"{body}"'


def _literal_regex(value) -> str:
    if isinstance(value, (dict, list)):
        raise ValueError("enum/const members must be scalars")
    return escape_literal(json.dumps(value))


def _array_regex(schema: dict) -> str:
    item = regex_for_schema(schema.get("items", {"type": "string"}))
    lo = int(schema.get("minItems", 0))
    hi = schema.get("maxItems")
    if hi is not None and (int(hi) < lo or int(hi) > MAX_REPEAT):
        raise ValueError(f"bad minItems/maxItems ({lo}, {hi})")
    if hi is not None and int(hi) == 0:
        return r"\[\]"
    head = ",".join([item] * max(lo, 1))
    if hi is None:
        tail = f"(,{item})*"
    else:
        tail = f"(,{item}){{0,{int(hi) - max(lo, 1)}}}" if int(hi) > max(lo, 1) else ""
    body = head + tail
    if lo == 0:
        body = f"({body})?"
    return rf"\[{body}\]"


def _object_regex(schema: dict) -> str:
    props = schema.get("properties", {})
    if not isinstance(props, dict):
        raise ValueError("object properties must be a mapping")
    required = schema.get("required")
    if required is not None:
        missing = [k for k in required if k not in props]
        if missing:
            raise ValueError(f"required properties without a schema: {missing}")
        emit = [k for k in props if k in set(required)]
    else:
        emit = list(props)
    if not emit:
        return r"\{\}"
    fields = ",".join(
        f'"{escape_literal(k)}":{regex_for_schema(props[k])}' for k in emit)
    return rf"\{{{fields}\}}"


def regex_for_schema(schema: dict) -> str:
    """Regex for the compact serialization of values matching ``schema``."""
    if not isinstance(schema, dict):
        raise ValueError("schema must be an object")
    if "enum" in schema:
        return "(" + "|".join(_literal_regex(v) for v in schema["enum"]) + ")"
    if "const" in schema:
        return _literal_regex(schema["const"])
    typ = schema.get("type")
    if isinstance(typ, list):
        return ("(" + "|".join(regex_for_schema({**schema, "type": t})
                               for t in typ) + ")")
    if typ == "string":
        return _string_regex(schema)
    if typ == "integer":
        return _INTEGER
    if typ == "number":
        return _NUMBER
    if typ == "boolean":
        return "(true|false)"
    if typ == "null":
        return "null"
    if typ == "object":
        return _object_regex(schema)
    if typ == "array":
        return _array_regex(schema)
    if typ is None:
        raise ValueError("schema needs a type, enum, or const")
    raise ValueError(f"unsupported schema type {typ!r}")


def json_object_regex(depth: int | None = None) -> str:
    """Regex for generic JSON (``json_object`` mode), nesting bounded."""
    scalar = f'("{_STR_CHAR}*"|{_NUMBER}|true|false|null)'
    value = scalar
    obj = ""
    for _ in range(depth if depth is not None else json_object_depth()):
        member = f'"{_STR_CHAR}*":{value}'
        obj = rf"\{{({member}(,{member})*)?\}}"
        arr = rf"\[({value}(,{value})*)?\]"
        value = f"({scalar}|{obj}|{arr})"
    return obj  # OpenAI json_object mode: the top level must be an object


# ------------------------------------------------------------- validator


def validate_instance(value, schema: dict) -> bool:
    """Subset validator matching regex_for_schema's semantics."""
    if "enum" in schema:
        return value in schema["enum"]
    if "const" in schema:
        return value == schema["const"]
    typ = schema.get("type")
    if isinstance(typ, list):
        return any(validate_instance(value, {**schema, "type": t})
                   for t in typ)
    if typ == "string":
        if not isinstance(value, str):
            return False
        if len(value) < int(schema.get("minLength", 0)):
            return False
        hi = schema.get("maxLength")
        return hi is None or len(value) <= int(hi)
    if typ == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if typ == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if typ == "boolean":
        return isinstance(value, bool)
    if typ == "null":
        return value is None
    if typ == "object":
        if not isinstance(value, dict):
            return False
        props = schema.get("properties", {})
        for k in schema.get("required", list(props)):
            if k not in value:
                return False
        return all(k not in props or validate_instance(v, props[k])
                   for k, v in value.items())
    if typ == "array":
        if not isinstance(value, list):
            return False
        if len(value) < int(schema.get("minItems", 0)):
            return False
        hi = schema.get("maxItems")
        if hi is not None and len(value) > int(hi):
            return False
        item = schema.get("items")
        return item is None or all(validate_instance(v, item) for v in value)
    return True
