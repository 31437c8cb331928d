"""Judge-LLM configuration loader (TOML).

The port's copy of ``chatts_tpu/eval/judge_config.py``.

Parity with the reference's RAGAS config layer
(reference: evaluation/ragas/config.py:22-93 + config/config.toml): a TOML
file selects the judge model/endpoint, with a ``CONFIG_PATH`` env override.
stdlib ``tomllib`` — no langchain factory needed since the judge speaks the
OpenAI chat API directly.

Schema (all optional):
    [llm]
    model = "gpt-4o-mini"
    api_base = "https://api.openai.com/v1"
    api_key = "sk-..."
    temperature = 0.0
    [data]
    data_dir = "data"
"""
from __future__ import annotations

import os
import tomllib
from typing import Any, Dict, Optional

DEFAULT_CONFIG_PATH = "config/judge_config.toml"


def load_config(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or os.environ.get("CONFIG_PATH", DEFAULT_CONFIG_PATH)
    if not os.path.exists(path):
        return {}
    with open(path, "rb") as f:
        return tomllib.load(f)


def load_judge(path: Optional[str] = None):
    """Build an AnswerCorrectnessJudge from the TOML config; None when no
    endpoint is configured (callers fall back to null_judge's 0.0 scores,
    matching the reference's missing-API-key behavior)."""
    cfg = load_config(path)
    llm_cfg = cfg.get("llm", {})
    api_base = llm_cfg.get("api_base") or os.environ.get("CHATTS_JUDGE_URL")
    if not api_base:
        return None
    from chatts_tpu_torch.eval.openai_client import OpenAIClient
    from chatts_tpu_torch.eval.ragas_judge import AnswerCorrectnessJudge

    client = OpenAIClient(
        base_url=api_base,
        api_key=llm_cfg.get("api_key", os.environ.get("OPENAI_API_KEY", "EMPTY")),
        model=llm_cfg.get("model", "gpt-4o-mini"),
        temperature=float(llm_cfg.get("temperature", 0.0)),
    )
    data_dir = cfg.get("data", {}).get("data_dir", "data")
    return AnswerCorrectnessJudge(client, data_dir=data_dir)
