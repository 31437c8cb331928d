"""Interactive streaming QA REPL: the port's copy of
``chatts_tpu/serve/stream_qa.py`` over the port's ``ServeEngine``.

Behavioral re-implementation of the reference streaming demo
(reference: chatts/utils/vllm_stream_qa.py:34-110): inline
``<ts>[...]</ts>`` series extraction from typed input, manual Qwen
chat-template assembly with conversation history, and token-by-token
streaming output — here over the continuous-batching ServeEngine instead of
vLLM's AsyncLLMEngine.
"""
from __future__ import annotations

import re
import sys
from typing import List, Optional, Tuple

import numpy as np

from chatts_tpu_torch.serve.scheduler import Request, SamplingParams, ServeEngine

_INLINE_TS = re.compile(r"<ts>(\[.*?\])</ts>", re.DOTALL)


def extract_and_remove_ts(text: str) -> Tuple[str, List[np.ndarray]]:
    """Pull inline ``<ts>[1,2,3]</ts>`` series out of typed input, replacing
    each with a ``<ts><ts/>`` hole (reference: vllm_stream_qa.py:41-50)."""
    series: List[np.ndarray] = []

    def repl(match):
        import json

        values = json.loads(match.group(1))
        series.append(np.asarray(values, dtype=np.float64))
        return "<ts><ts/>"

    cleaned = _INLINE_TS.sub(repl, text)
    return cleaned, series


def build_chat_prompt(history: List[Tuple[str, str]], user_text: str) -> str:
    """Qwen chat template with history (reference:
    vllm_stream_qa.py:91-94)."""
    parts = ["<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"]
    for q, a in history:
        parts.append(f"<|im_start|>user\n{q}<|im_end|>\n")
        parts.append(f"<|im_start|>assistant\n{a}<|im_end|>\n")
    parts.append(f"<|im_start|>user\n{user_text}<|im_end|>\n")
    parts.append("<|im_start|>assistant\n")
    return "".join(parts)


def stream_answer(
    engine: ServeEngine,
    tokenizer,
    prompt: str,
    series: List[np.ndarray],
    params: Optional[SamplingParams] = None,
    out=sys.stdout,
) -> str:
    """Submit and print tokens as they arrive; returns the full text."""
    req = Request(prompt, series, params or SamplingParams(max_tokens=512,
                                                           temperature=0.2))
    engine.submit(req)
    pieces: List[str] = []
    while True:
        chunk = req.stream_queue.get()
        if chunk is None:
            break
        text = tokenizer.decode(chunk, skip_special_tokens=True)
        pieces.append(text)
        out.write(text)
        out.flush()
    out.write("\n")
    if req.error:
        raise RuntimeError(req.error)
    return "".join(pieces)


def repl(engine: ServeEngine, tokenizer, max_history: int = 8) -> None:
    """Interactive loop.  Type series inline as <ts>[1,2,3]</ts>; 'exit' to
    quit, 'clear' to reset history."""
    engine.start()
    history: List[Tuple[str, str]] = []
    all_series: List[np.ndarray] = []
    print("ChatTS streaming REPL. Inline series: <ts>[1,2,3]</ts>. "
          "'clear' resets, 'exit' quits.")
    while True:
        try:
            user = input("user> ")
        except (EOFError, KeyboardInterrupt):
            break
        if user.strip() in ("exit", "quit"):
            break
        if user.strip() == "clear":
            history.clear()
            all_series.clear()
            continue
        cleaned, series = extract_and_remove_ts(user)
        all_series.extend(series)
        prompt = build_chat_prompt(history, cleaned)
        try:
            answer = stream_answer(engine, tokenizer, prompt, list(all_series))
        except RuntimeError as err:
            print(f"[error] {err}")
            continue
        history.append((cleaned, answer))
        history = history[-max_history:]
