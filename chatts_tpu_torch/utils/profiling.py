"""Request-level metrics for the serving engine: the port's own copy of
``RequestRecord`` and ``MetricsAggregator`` from
``chatts_tpu/utils/profiling.py`` (TTFT / TPOT / throughput percentiles over
served requests).  Device traces on the card come from ``torch.profiler``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List


@dataclasses.dataclass
class RequestRecord:
    ttft_s: float
    tpot_s: float
    prompt_tokens: int
    output_tokens: int
    total_s: float


class MetricsAggregator:
    """Thread-safe TTFT/TPOT/throughput aggregation over served requests."""

    def __init__(self, max_records: int = 10000):
        self._records: List[RequestRecord] = []
        self._lock = threading.Lock()
        self.max_records = max_records

    def record(self, *, ttft_s: float, tpot_s: float, prompt_tokens: int,
               output_tokens: int, total_s: float) -> None:
        with self._lock:
            self._records.append(RequestRecord(
                ttft_s, tpot_s, prompt_tokens, output_tokens, total_s
            ))
            if len(self._records) > self.max_records:
                self._records = self._records[-self.max_records:]

    def record_request(self, req) -> None:
        """Record a finished serve Request."""
        if req.first_token_s is None or req.finished_s is None:
            return
        n_out = len(req.output_tokens)
        decode = req.finished_s - req.first_token_s
        self.record(
            ttft_s=req.ttft_s or 0.0,
            tpot_s=decode / max(n_out - 1, 1),
            prompt_tokens=req.prompt_tokens,
            output_tokens=n_out,
            total_s=req.finished_s - req.created_s,
        )

    @staticmethod
    def _percentile(values: List[float], p: float) -> float:
        if not values:
            return 0.0
        values = sorted(values)
        idx = min(int(len(values) * p / 100), len(values) - 1)
        return values[idx]

    def summary(self) -> Dict[str, float]:
        with self._lock:
            records = list(self._records)
        if not records:
            return {"requests": 0}
        ttfts = [r.ttft_s for r in records]
        tpots = [r.tpot_s for r in records]
        total_out = sum(r.output_tokens for r in records)
        total_time = sum(r.total_s for r in records)
        return {
            "requests": len(records),
            "p50_ttft_ms": self._percentile(ttfts, 50) * 1e3,
            "p99_ttft_ms": self._percentile(ttfts, 99) * 1e3,
            "p50_tpot_ms": self._percentile(tpots, 50) * 1e3,
            "p99_tpot_ms": self._percentile(tpots, 99) * 1e3,
            "mean_output_tokens": total_out / len(records),
            "tokens_per_sec": total_out / total_time if total_time else 0.0,
        }
