"""LLMClient: batched generation dispatcher for datagen and eval pipelines.

The port's copy of ``chatts_tpu/utils/llm_client.py`` over the port's
``ServeEngine``.  Counterpart of the reference's multiprocess GPU worker pool
(reference: chatts/utils/llm_utils.py:228-341).  The reference spawns one
process per GPU group with CUDA_VISIBLE_DEVICES pinning and Manager queues;
here one process owns the card and the engine batches, so the pool becomes a
thread-based dispatcher over engines.  The engine names are the interface of
``eval/`` and ``datagen/`` and stay the JAX package's: ``"tpu"`` and
``"tpu-ts"`` name the in-process engine, which runs on the card here.

* ``tpu-ts``  — in-process ChatTS ServeEngine (multimodal; the vllm-ts analog,
                prefix caching off per reference llm_utils.py:154)
* ``tpu``     — same engine, text-only prompts (the vllm analog)
* ``openai``  — any OpenAI-compatible HTTP endpoint (covers multi-host
                serving and external judge/datagen LLMs; the llama analog)
* ``dryrun``  — 0.1 s sleeping fake with canned outputs, preserving the
                reference's test strategy of exercising orchestration without
                hardware (reference: llm_utils.py:192-224, SURVEY §4.1)

Answers are keyed by index so out-of-order completion cannot scramble results
(reference: llm_utils.py:282-333).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

BATCH_SIZE = 32  # reference batching cap (llm_utils.py:35)


class LLMClient:
    def __init__(
        self,
        engine: str = "dryrun",
        *,
        serve_engine=None,  # ServeEngine for tpu/tpu-ts
        openai_client=None,  # OpenAIClient for openai engine
        dryrun_output: str = '{"result": "this is a dryrun result"}',
        dryrun_sleep_s: float = 0.1,
        max_concurrency: int = 32,
        sampling_params: Optional[dict] = None,
    ):
        if engine not in ("tpu", "tpu-ts", "openai", "dryrun"):
            raise ValueError(f"unknown engine: {engine}")
        self.engine = engine
        self.serve_engine = serve_engine
        self.openai_client = openai_client
        self.dryrun_output = dryrun_output
        self.dryrun_sleep_s = dryrun_sleep_s
        self.max_concurrency = max_concurrency
        self.sampling_params = sampling_params or {
            "max_tokens": 512,
            "temperature": 0.2,
        }
        self._killed = threading.Event()

        if engine in ("tpu", "tpu-ts"):
            if serve_engine is None:
                raise ValueError(f"engine {engine} requires serve_engine")
            serve_engine.start()

    def wait_for_ready(self) -> None:
        """Barrier analog (reference: llm_utils.py:270-273); engines here are
        ready at construction."""
        return None

    def _generate_one(self, idx: int, prompt: str, ts: Optional[List[np.ndarray]]):
        if self._killed.is_set():
            return idx, None
        if self.engine == "dryrun":
            time.sleep(self.dryrun_sleep_s)
            return idx, self.dryrun_output
        if self.engine == "openai":
            return idx, self.openai_client(prompt)
        # tpu / tpu-ts: the in-process engine
        from chatts_tpu_torch.serve.scheduler import SamplingParams

        params = SamplingParams(
            max_tokens=self.sampling_params.get("max_tokens", 512),
            temperature=self.sampling_params.get("temperature", 0.2),
            top_p=self.sampling_params.get("top_p", 1.0),
        )
        series = [np.asarray(t) for t in (ts or [])]
        if self.engine == "tpu" and series:
            raise ValueError("engine 'tpu' is text-only; use 'tpu-ts'")
        req = self.serve_engine.generate_sync(prompt, series, params)
        tokenizer = getattr(self.serve_engine.processor, "tokenizer", None)
        if tokenizer is not None and hasattr(tokenizer, "decode"):
            return idx, tokenizer.decode(req.output_tokens, skip_special_tokens=True)
        return idx, req.output_tokens

    def llm_batch_generate(
        self,
        prompts: Sequence[str],
        ts_list: Optional[Sequence[Optional[List[np.ndarray]]]] = None,
        progress_callback: Optional[Callable[[int, int], None]] = None,
    ) -> List[Optional[str]]:
        """Generate for every prompt; results returned in input order."""
        if ts_list is None:
            ts_list = [None] * len(prompts)
        results: Dict[int, Any] = {}
        workers = min(self.max_concurrency, max(len(prompts), 1), BATCH_SIZE)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [
                pool.submit(self._generate_one, i, p, t)
                for i, (p, t) in enumerate(zip(prompts, ts_list))
            ]
            done = 0
            for fut in futures:
                idx, out = fut.result()
                results[idx] = out
                done += 1
                if progress_callback:
                    progress_callback(done, len(prompts))
        return [results.get(i) for i in range(len(prompts))]

    def kill(self) -> None:
        """Stop accepting work and shut down owned engines
        (reference: llm_utils.py:335-341)."""
        self._killed.set()
        if self.serve_engine is not None:
            self.serve_engine.stop()
