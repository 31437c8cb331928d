"""Metrics for the serving engine.

Request-level: the port's own copy of ``RequestRecord`` and
``MetricsAggregator`` from ``chatts_tpu/utils/profiling.py`` (TTFT / TPOT /
throughput percentiles over served requests).

Round-level, the engine's span record (``ServeEngine._log_round``): host
spans of the loop's phases (``SpanTimer``, under the names of ``SPANS``) and,
on the card, timing events of its rounds read on the same host clock
(``DeviceClock``).  Device traces on the card come from ``torch.profiler``,
which sees every span as a range of its name while it records.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

# The loop phases a round-log entry times, by field (host seconds, on
# ``time.perf_counter``), and the name of each as a ``torch.profiler`` range.
SPANS = {
    "dispatch_s": "round.dispatch",  # launching the round
    "wait_s": "round.wait",  # blocked in the fetch's device sync
    "apply_s": "round.apply",  # applying the fetched result
    "grace_s": "admit.grace",  # waiting for replacement requests
    "select_s": "admit.select",  # choosing the wave from the queue
    "process_s": "admit.process",  # the ChatTSProcessor calls
    "embed_s": "admit.embed",  # launching the TS encoder and the merge
    "stage_s": "admit.stage",  # staging, or the monolithic prefill
    "idle_s": "loop.idle",  # waiting with no work
}


class SpanTimer:
    """Host spans of one thread, on ``time.perf_counter``.  ``timer(into,
    field)`` is a context manager that adds the span's self time (its
    seconds less those of the spans opened inside it) to ``into[field]``, so
    the fields of nested spans add up to the outer one's duration.  While a
    ``torch.profiler`` run records on the thread, the span is also a
    ``record_function`` range named ``SPANS[field]``; otherwise it costs one
    flag check."""

    def __init__(self):
        self._inner: List[float] = []  # seconds of the spans inside each open span

    def __call__(self, into: Dict[str, float], field: str) -> "_Span":
        return _Span(self, into, field)


class _Span:
    __slots__ = ("timer", "into", "field", "range", "t0")

    def __init__(self, timer: SpanTimer, into: Dict[str, float], field: str):
        self.timer, self.into, self.field = timer, into, field

    def __enter__(self) -> "_Span":
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(SPANS[self.field])
            self.range.__enter__()
        self.timer._inner.append(0.0)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        seconds = time.perf_counter() - self.t0
        inner = self.timer._inner
        self.into[self.field] = self.into.get(self.field, 0.0) + seconds - inner.pop()
        if inner:
            inner[-1] += seconds
        if self.range is not None:
            self.range.__exit__(*exc)


# A timing event and the anchor it is read against.
Mark = Tuple["torch.cuda.Event", Tuple["torch.cuda.Event", float]]


class DeviceClock:
    """Timing events on the CUDA stream current where it is made (the
    thread's), read as ``time.perf_counter`` seconds.  Each mark is read
    against the anchor current when it was recorded: an event recorded where
    the stream holds no work, so the device stamps it as the host records
    it, at a known host time.  ``anchor()`` is called just after a sync, and
    re-takes the anchor once it is ``ANCHOR_S`` old, which bounds the drift
    between the two clocks (about 5 us a second on an H100).  A mark is read
    only once the stream has passed it (after a later sync), so reading
    never waits; ``release`` then returns its event for reuse."""

    ANCHOR_S = 1.0

    def __init__(self):
        self._stream = torch.cuda.current_stream()
        self._free: List["torch.cuda.Event"] = []
        self._anchor: Optional[Tuple["torch.cuda.Event", float]] = None
        self.anchor()

    def anchor(self) -> None:
        if self._anchor is not None and time.perf_counter() - self._anchor[1] < self.ANCHOR_S:
            return
        event = torch.cuda.Event(enable_timing=True)
        event.record(self._stream)
        self._anchor = (event, time.perf_counter())

    def mark(self) -> Mark:
        event = self._free.pop() if self._free else torch.cuda.Event(enable_timing=True)
        event.record(self._stream)
        return event, self._anchor

    def release(self, marks) -> None:
        self._free.extend(event for event, _ in marks)

    @staticmethod
    def host_s(mark: Mark) -> float:
        """The mark's time on ``time.perf_counter``."""
        event, (anchor, at) = mark
        return at + anchor.elapsed_time(event) * 1e-3

    @staticmethod
    def seconds(start: Mark, end: Mark) -> float:
        return start[0].elapsed_time(end[0]) * 1e-3


def device_gap_s(entries) -> Optional[float]:
    """Device seconds between consecutive rounds of the round-log
    ``entries`` (ordered by ``dev_start``) that neither round nor the work
    launched between them (``pre_dev_s``) covers; None where no entry
    carries device stamps."""
    rounds = sorted((e for e in entries if e.get("dev_start") is not None),
                    key=lambda e: e["dev_start"])
    if not rounds:
        return None
    return sum(max(0.0, b["dev_start"] - a["dev_end"] - b["pre_dev_s"])
               for a, b in zip(rounds, rounds[1:]))


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
