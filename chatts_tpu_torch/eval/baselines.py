"""GPT baselines: text, vision, and ReAct-agent evaluation harnesses.

The port's copy of ``chatts_tpu/eval/baselines.py``.

Behavioral re-implementation of the reference baselines
(reference: evaluation/evaluate_gpt_text_models.py,
evaluate_gpt_vision_models.py:40-77, evaluate_gpt_agent_models.py): series
rendered either as ``%.2f`` CSV text, as base64 JPEG plots, or analyzed by
the tool-using ReAct agent; all with resume-by-idx (already-answered samples
skipped on rerun — the reference's job-level resume, SURVEY §5).

Parallelism uses a thread pool over the (network-bound) LLM client rather
than the reference's process pool.
"""
from __future__ import annotations

import base64
import io
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np


def render_series_text(timeseries: Sequence) -> str:
    """Values inlined as %.2f CSV (reference:
    evaluate_gpt_text_models.py:42-46)."""
    parts = []
    for i, ts in enumerate(timeseries):
        values = ", ".join(f"{float(v):.2f}" for v in np.asarray(ts).reshape(-1))
        parts.append(f"Time series {i + 1}: {values}")
    return "\n".join(parts)


def render_series_image(timeseries: Sequence, dpi: int = 72) -> str:
    """Matplotlib render -> base64 JPEG (reference:
    evaluate_gpt_vision_models.py:40-77)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(timeseries)
    fig, axes = plt.subplots(n, 1, figsize=(8, 2.2 * n), dpi=dpi, squeeze=False)
    for i, ts in enumerate(timeseries):
        ax = axes[i][0]
        ax.plot(np.asarray(ts).reshape(-1))
        ax.set_title(f"Time series {i + 1}", fontsize=9)
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    buf = io.BytesIO()
    fig.savefig(buf, format="jpeg")
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode()


def _load_done(output_path: str) -> dict:
    """Resume support: map idx -> existing answers (reference:
    evaluate_gpt_text_models.py:104-111)."""
    if not os.path.exists(output_path):
        return {}
    try:
        with open(output_path) as f:
            return {item["idx"]: item for item in json.load(f)}
    except (json.JSONDecodeError, KeyError):
        return {}


def _run_pool(
    dataset: Sequence[dict],
    answer_fn: Callable[[int, dict], dict],
    output_path: str,
    num_workers: int,
) -> List[dict]:
    done = _load_done(output_path)
    lock = threading.Lock()
    results = dict(done)

    def work(idx):
        if idx in results:
            return
        try:
            item = answer_fn(idx, dataset[idx])
        except Exception as err:
            item = {"idx": idx, "response": "", "error": str(err), "num_tokens": 0}
        with lock:
            results[idx] = item
            # Periodic checkpointing so reruns resume.
            if len(results) % 10 == 0:
                _save(results, output_path)

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        list(pool.map(work, range(len(dataset))))
    _save(results, output_path)
    return [results[i] for i in sorted(results)]


def _save(results: dict, output_path: str) -> None:
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(sorted(results.values(), key=lambda r: r["idx"]), f,
                  ensure_ascii=False, indent=4)


def evaluate_gpt_text(
    dataset: Sequence[dict],
    client,
    output_path: str,
    num_workers: int = 32,
) -> List[dict]:
    """Text baseline: values in the prompt as CSV."""

    def answer(idx, sample):
        question = sample["question"].replace("<ts><ts/>", "")
        prompt = (
            "You are a time series analysis expert. Analyze the following "
            "time series data and answer the question.\n"
            + render_series_text(sample["timeseries"])
            + "\nQuestion: " + question
        )
        response = client(prompt)
        return {"idx": idx, "response": response,
                "num_tokens": len(prompt.split()) + len(response.split())}

    return _run_pool(dataset, answer, output_path, num_workers)


def evaluate_gpt_vision(
    dataset: Sequence[dict],
    client,
    output_path: str,
    num_workers: int = 8,
) -> List[dict]:
    """Vision baseline: plots as base64 JPEG content parts.  ``client`` must
    expose ``chat(messages)`` (OpenAIClient qualifies)."""

    def answer(idx, sample):
        question = sample["question"].replace("<ts><ts/>", "")
        image_b64 = render_series_image(sample["timeseries"])
        messages = [{
            "role": "user",
            "content": [
                {"type": "text", "text":
                 "You are a time series analysis expert. Analyze the time "
                 "series shown in the image and answer the question.\n"
                 "Question: " + question},
                {"type": "image_url", "image_url": {
                    "url": f"data:image/jpeg;base64,{image_b64}"}},
            ],
        }]
        response = client.chat(messages)
        return {"idx": idx, "response": response,
                "num_tokens": len(question.split()) + len(response.split())}

    return _run_pool(dataset, answer, output_path, num_workers)


def evaluate_gpt_agent(
    dataset: Sequence[dict],
    llm: Callable[[str], str],
    output_path: str,
    num_workers: int = 8,
    rocket_path: Optional[str] = None,
) -> List[dict]:
    """ReAct-agent baseline over the native tool suite."""
    from chatts_tpu_torch.eval.react_agent import answer_question_react

    def answer(idx, sample):
        cols = sample.get("cols") or [
            f"Time series {i + 1}" for i in range(len(sample["timeseries"]))
        ]
        question = sample["question"].replace("<ts><ts/>", "")
        response = answer_question_react(
            question, sample["timeseries"], cols, llm, rocket_path
        )
        return {"idx": idx, "response": response,
                "num_tokens": len(question.split()) + len(response.split())}

    return _run_pool(dataset, answer, output_path, num_workers)
