"""Tool-call extraction from model output (counterpart of
aphrodite_tpu/endpoints/openai/tool_parsers.py: the Hermes and Mistral
parsers). Non-streaming extraction: the generated text is scanned for
the model family's tool-call envelope and converted to OpenAI tool_calls.
"""

import json
import re
import uuid
from typing import Any, Dict, List, Optional, Tuple

HERMES_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>",
                       re.DOTALL)
MISTRAL_PREFIX = "[TOOL_CALLS]"


def _mk_call(name: str, arguments: Any) -> Dict[str, Any]:
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments)
    return {
        "id": f"call_{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


def parse_hermes(text: str) -> Tuple[Optional[str], List[Dict[str, Any]]]:
    """Hermes format: <tool_call>{"name": ..., "arguments": ...}</tool_call>.
    Returns (content_without_calls, tool_calls)."""
    calls = []
    for m in HERMES_RE.finditer(text):
        try:
            obj = json.loads(m.group(1))
            calls.append(_mk_call(obj["name"], obj.get("arguments", {})))
        except (json.JSONDecodeError, KeyError):
            continue
    if not calls:
        return text, []
    content = HERMES_RE.sub("", text).strip() or None
    return content, calls


def parse_mistral(text: str) -> Tuple[Optional[str], List[Dict[str, Any]]]:
    """Mistral format: [TOOL_CALLS] [{"name": ..., "arguments": ...}, ...]."""
    idx = text.find(MISTRAL_PREFIX)
    if idx < 0:
        return text, []
    payload = text[idx + len(MISTRAL_PREFIX):].strip()
    try:
        arr = json.loads(payload)
        calls = [_mk_call(o["name"], o.get("arguments", {})) for o in arr]
    except (json.JSONDecodeError, KeyError, TypeError):
        return text, []
    content = text[:idx].strip() or None
    return content, calls


_PARSERS = {"hermes": parse_hermes, "mistral": parse_mistral}


def parse_tool_calls(text: str, parser: str = "auto"
                     ) -> Tuple[Optional[str], List[Dict[str, Any]]]:
    if parser in _PARSERS:
        return _PARSERS[parser](text)
    # auto: try each format.
    for fn in (parse_hermes, parse_mistral):
        content, calls = fn(text)
        if calls:
            return content, calls
    return text, []
