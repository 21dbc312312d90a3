"""JSON-schema -> regex translation (subset).

Replaces the reference's outlines JSON-schema support
(guided_decoding/outlines_logits_processors.py JSONLogitsProcessor).
Supported: type string/integer/number/boolean/null, enum/const, object
with `properties` (+required subset ordering as written), array of items
with minItems/maxItems, nested combinations, anyOf.
"""

import json
from typing import Any, Dict

# Building blocks (whitespace kept minimal: a single optional space after
# separators keeps DFAs small while accepting pretty-printed-lite JSON).
WS = "( )?"
STRING_RE = r'"([^"\\]|\\.)*"'
INT_RE = r"-?(0|[1-9][0-9]*)"
NUMBER_RE = r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?"
BOOL_RE = r"(true|false)"
NULL_RE = r"null"

# Generic JSON value to bounded nesting depth (full recursion would need
# a pushdown automaton; depth-3 covers typical "json_object" usage).
def _json_value(depth: int) -> str:
    scalar = f"({STRING_RE}|{NUMBER_RE}|{BOOL_RE}|{NULL_RE})"
    if depth <= 0:
        return scalar
    inner = _json_value(depth - 1)
    obj = (rf"\{{{WS}({STRING_RE}{WS}:{WS}{inner}"
           rf"({WS},{WS}{STRING_RE}{WS}:{WS}{inner})*)?{WS}\}}")
    arr = rf"\[{WS}({inner}({WS},{WS}{inner})*)?{WS}\]"
    return f"({scalar}|{obj}|{arr})"


ANY_JSON_OBJECT_REGEX = (
    rf"\{{{WS}({STRING_RE}{WS}:{WS}{_json_value(2)}"
    rf"({WS},{WS}{STRING_RE}{WS}:{WS}{_json_value(2)})*)?{WS}\}}")


def _escape_literal(text: str) -> str:
    out = []
    for c in text:
        if c in ".*+?()[]{}|\\^$":
            out.append("\\" + c)
        else:
            out.append(c)
    return "".join(out)


def schema_to_regex(schema: Dict[str, Any], depth: int = 4) -> str:
    if depth <= 0:
        return _json_value(1)
    if "enum" in schema:
        parts = [_escape_literal(json.dumps(v)) for v in schema["enum"]]
        return "(" + "|".join(parts) + ")"
    if "const" in schema:
        return _escape_literal(json.dumps(schema["const"]))
    if "anyOf" in schema:
        return "(" + "|".join(
            schema_to_regex(s, depth - 1) for s in schema["anyOf"]) + ")"
    stype = schema.get("type")
    if stype == "string":
        return STRING_RE
    if stype == "integer":
        return INT_RE
    if stype == "number":
        return NUMBER_RE
    if stype == "boolean":
        return BOOL_RE
    if stype == "null":
        return NULL_RE
    if stype == "array":
        item = schema_to_regex(schema.get("items", {}), depth - 1)
        min_items = int(schema.get("minItems", 0))
        max_items = schema.get("maxItems")
        if max_items is None:
            if min_items == 0:
                body = f"({item}({WS},{WS}{item})*)?"
            else:
                body = (f"{item}" +
                        f"({WS},{WS}{item})" + "{" + str(min_items - 1) +
                        ",}")
        else:
            max_items = int(max_items)
            if min_items == 0:
                if max_items == 0:
                    body = ""
                else:
                    body = (f"({item}({WS},{WS}{item})" + "{0," +
                            str(max_items - 1) + "})?")
            else:
                body = (f"{item}({WS},{WS}{item})" + "{" +
                        str(min_items - 1) + "," + str(max_items - 1) +
                        "}")
        return rf"\[{WS}{body}{WS}\]"
    if stype == "object" or "properties" in schema:
        props = schema.get("properties", {})
        if not props:
            return ANY_JSON_OBJECT_REGEX
        required = set(schema.get("required", list(props.keys())))
        parts = []
        first = True
        # Properties in declaration order; optional ones may be skipped
        # (a simplification: optional properties are emitted in order or
        # omitted, which matches how models write schema'd JSON).
        for name, sub in props.items():
            key = _escape_literal(json.dumps(name))
            val = schema_to_regex(sub, depth - 1)
            piece = f"{key}{WS}:{WS}{val}"
            if first:
                seg = piece if name in required else f"({piece})?"
                first = False
            else:
                seg = (f"{WS},{WS}{piece}" if name in required else
                       f"({WS},{WS}{piece})?")
            parts.append(seg)
        body = "".join(parts)
        return rf"\{{{WS}{body}{WS}\}}"
    # Unconstrained.
    return _json_value(2)
