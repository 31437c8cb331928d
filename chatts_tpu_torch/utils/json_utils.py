"""Tolerant JSON extraction from LLM output: the port's copy of
``chatts_tpu/utils/json_utils.py``.

Replacement for the reference's ``json-repair`` dependency
(reference: chatts/utils/llm_utils.py:344-348): strips code fences and prose,
extracts the outermost JSON object/array, and repairs the common LLM
malformations (single quotes, trailing commas, Python literals).
"""
from __future__ import annotations

import json
import re
from typing import Any, Optional


def _extract_json_span(text: str) -> Optional[str]:
    """Find the first balanced {...} or [...] span."""
    for opener, closer in (("{", "}"), ("[", "]")):
        start = text.find(opener)
        if start == -1:
            continue
        depth = 0
        in_str = False
        escape = False
        for i in range(start, len(text)):
            c = text[i]
            if in_str:
                if escape:
                    escape = False
                elif c == "\\":
                    escape = True
                elif c == '"':
                    in_str = False
                continue
            if c == '"':
                in_str = True
            elif c == opener:
                depth += 1
            elif c == closer:
                depth -= 1
                if depth == 0:
                    return text[start : i + 1]
    return None


def _repair(text: str) -> str:
    # Python literals -> JSON.
    text = re.sub(r"\bTrue\b", "true", text)
    text = re.sub(r"\bFalse\b", "false", text)
    text = re.sub(r"\bNone\b", "null", text)
    # Trailing commas.
    text = re.sub(r",\s*([}\]])", r"\1", text)
    return text


def parse_llm_json(text: str) -> Optional[Any]:
    """Best-effort JSON parse of an LLM response; None on failure."""
    if text is None:
        return None
    # Prefer fenced blocks.
    fence = re.search(r"```(?:json)?\s*(.*?)```", text, re.DOTALL)
    candidates = []
    if fence:
        candidates.append(fence.group(1))
    candidates.append(text)
    span = _extract_json_span(text)
    if span:
        candidates.append(span)
    for cand in candidates:
        for attempt in (cand, _repair(cand), _repair(cand).replace("'", '"')):
            try:
                return json.loads(attempt)
            except (json.JSONDecodeError, TypeError):
                continue
    return None
