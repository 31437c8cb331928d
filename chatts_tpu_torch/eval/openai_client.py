"""Minimal OpenAI-compatible chat client on stdlib urllib (zero extra deps).

The port's copy of ``chatts_tpu/eval/openai_client.py``.

Serves two roles the reference fills with the ``openai`` package + langchain
(reference: evaluation/ragas/config.py:41-93, evaluate_gpt_text_models.py):
the judge-LLM transport and the GPT-baseline transport.  Includes the
reference's retry-on-timeout loop (reference:
evaluate_gpt_text_models.py:57-72, 10 retries).
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import List, Optional


class OpenAIClient:
    """Callable ``prompt -> completion text`` against any /v1/chat/completions
    endpoint (including :mod:`chatts_tpu_torch.serve.server`)."""

    def __init__(
        self,
        base_url: str = "http://localhost:12345/v1",
        api_key: str = "EMPTY",
        model: str = "gpt-4o-mini",
        temperature: float = 0.0,
        max_tokens: int = 1024,
        timeout_s: float = 60.0,
        max_retries: int = 10,
        system_prompt: Optional[str] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.model = model
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.system_prompt = system_prompt

    def chat(self, messages: List[dict], **overrides) -> str:
        payload = {
            "model": overrides.get("model", self.model),
            "messages": messages,
            "temperature": overrides.get("temperature", self.temperature),
            "max_tokens": overrides.get("max_tokens", self.max_tokens),
        }
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions",
            data=body,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.api_key}",
            },
        )
        last_err: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                    data = json.loads(resp.read())
                return data["choices"][0]["message"]["content"]
            except (urllib.error.URLError, TimeoutError, OSError) as err:
                last_err = err
                time.sleep(min(2.0 * (attempt + 1), 10.0))
        raise RuntimeError(f"chat completion failed after retries: {last_err}")

    def __call__(self, prompt: str) -> str:
        messages = []
        if self.system_prompt:
            messages.append({"role": "system", "content": self.system_prompt})
        messages.append({"role": "user", "content": prompt})
        return self.chat(messages)
