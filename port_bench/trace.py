"""What a traced run (``--trace 1``) adds: the shapes of the port's kernel
launches, labels for what the host is doing, and a ``torch.profiler`` trace
of a steady sub-window, reduced to device time by kernel, busy time, idle
gaps and the bounds of the launches the sub-window ran.

The profiler sees the kernels inside a CUDA graph's replay (checked on the
H100 with PyTorch 2.11 and CUDA 12.8), so a replayed launch counts at the
shape it was captured with: while a graph is captured, the wrappers record
the shapes of one step, and each replay of that step is counted with them.
A scan-sliced round's prefill attention changes its query span every step,
so its bounds are worked out from the admission the round consumes.

The wrappers stand in for the names ``models/qwen.py`` calls
(``int4_matmul``, ``attention``) and for the engine's graph classes; they
record host tuples only and launch nothing.  Every profiler call is made on
the engine's thread, between rounds, right after a round's host fetch, when
the device has finished the round and no other thread launches work: the
profiler is started and stopped once after the first round (its first start
takes seconds), and the sub-window, the profiler and the recording of
launches start and stop together at two round ends.  The profiler's state
belongs to the thread that started it; started or stopped from the main
thread while the engine launched graphs, it hung one run and crashed others
on the card.  Its stop takes seconds of the engine's thread, in the drain,
which is why a mix's ``drain_s`` leaves room.  Host phases (a round's
dispatch, the fetch, an admission) are noted on the host clock and mapped
onto the trace's clock through a marker recorded at a known host time.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from port_bench import flops
from port_bench.stats import merge_intervals

INT4_KERNELS = ("int4_mma_kernel", "int4_splitk_reduce_kernel")
FLASH_KERNELS = ("flash_mma_kernel",)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC = "port_bench.sync"


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


class Tracer:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.recording = False
        self._capture: Optional[List[Tuple[int, int, int]]] = None
        self.int4_bound = 0.0
        self.int4_calls = 0
        self.flash_bound = 0.0
        self.flash_calls = 0
        self._flash_eager: List[tuple] = []
        self.flash_unknown = 0
        self.replays: Dict[str, int] = {}
        self._saved: List[tuple] = []
        self.warmed = False
        self._prof = None
        self._sync: Optional[float] = None
        self._stopping: Optional[float] = None  # host clock; while the profiler stops
        self._stopped_s = 0.0
        self.window: Optional[Tuple[float, float]] = None  # host clock
        self.phases: List[Tuple[float, float, str]] = []  # host clock

    # -- wrappers -------------------------------------------------------------

    def install(self) -> None:
        """Put the wrappers in place; before the engine is built, so that
        every graph it captures is recorded."""
        from chatts_tpu_torch.models import qwen
        from chatts_tpu_torch.serve import scheduler

        tracer = self
        int4, attention = qwen.int4_matmul, qwen.attention

        def int4_spy(x, packed, scales, *args, **kw):
            shape = (x.shape[0], x.shape[1], packed.shape[1])
            if _capturing():
                if tracer._capture is not None:
                    tracer._capture.append(shape)
            elif tracer.recording:
                tracer.int4_calls += 1
                tracer.int4_bound += flops.int4_bound_s(*shape)
            return int4(x, packed, scales, *args, **kw)

        def attention_spy(q, k, v, **kw):
            if tracer.recording and not _capturing():
                # A prompt block's prefill attends the block itself: queries
                # and keys at positions 0 .. T - 1, valid below each length.
                if kw.get("impl", "auto") == "auto" and q.shape[1] == k.shape[1]:
                    tracer._flash_eager.append((q.shape[2], k.shape[2], q.shape[3],
                                                kw["kv_valid"]))
                else:
                    tracer.flash_unknown += 1
            return attention(q, k, v, **kw)

        def graph_class(base, kind):
            class Recorded(base):
                def __init__(self, *args, **kw):
                    tracer._capture = []
                    try:
                        super().__init__(*args, **kw)
                    finally:
                        self.bench_int4, tracer._capture = tracer._capture, None

                def round(self):
                    if tracer.recording:
                        n = self.chunk_size
                        tracer.int4_calls += n * len(self.bench_int4)
                        tracer.int4_bound += n * sum(flops.int4_bound_s(*s)
                                                     for s in self.bench_int4)
                        tracer.replays[kind] = tracer.replays.get(kind, 0) + n
                    return super().round()

            Recorded.__name__ = base.__name__
            return Recorded

        for owner, name, value in (
                (qwen, "int4_matmul", int4_spy), (qwen, "attention", attention_spy),
                (scheduler, "_DecodeStepGraph",
                 graph_class(scheduler._DecodeStepGraph, "decode")),
                (scheduler, "_MixedStepGraph",
                 graph_class(scheduler._MixedStepGraph, "mixed"))):
            self._saved.append((owner, name, getattr(owner, name)))
            setattr(owner, name, value)

    def uninstall(self) -> None:
        for owner, name, value in reversed(self._saved):
            setattr(owner, name, value)
        self._saved = []

    def attach(self, engine) -> None:
        """Note the engine's host phases while the profiler runs, and work
        out the prefill attention bounds of each scan-sliced round."""
        tracer = self
        op_round, admit, complete = engine._op_round, engine._admit, engine._complete_round
        dispatch_mixed = engine._dispatch_mixed

        def noted(name_of, inner):
            def call(*args):
                if tracer._prof is None:
                    return inner(*args)
                name, t0 = name_of(), time.perf_counter()
                try:
                    return inner(*args)
                finally:
                    tracer.phases.append((t0, time.perf_counter(), name))
            return call

        def round_kind():
            st = engine._pending_mixed
            return "round." + (st["mode"] if st is not None else "decode")

        def mixed_round():
            if tracer.recording:
                tracer._mixed_flash(engine)
            return dispatch_mixed()

        engine._op_round = noted(round_kind, op_round)
        engine._admit = noted(lambda: "admit", admit)
        engine._complete_round = noted(lambda: "fetch", complete)
        engine._dispatch_mixed = mixed_round

    def _mixed_flash(self, engine) -> None:
        """The prefill attention launches of the scan-sliced round about to
        run: ``decode_chunk`` steps, each taking ``npt`` prompt tokens of
        every row from the round's offset, each query attending its causal
        prefix."""
        st = engine._pending_mixed
        cfg = self.cfg
        lengths = [r.prompt_tokens for r in st["reqs"]]
        npt, o = st["npt"], st["o"]
        for s in range(engine.decode_chunk):
            start = o + s * npt
            queries = sum(max(0, min(start + npt, n) - start) for n in lengths)
            keys = sum(min(n, start + npt) for n in lengths if start < n)
            pairs = sum(flops.span_pairs(start, min(start + npt, n)) for n in lengths)
            one = flops.flash_bound_s(cfg["num_attention_heads"], cfg["num_key_value_heads"],
                                      cfg["head_dim"], queries, keys, pairs)
            self.flash_bound += cfg["num_hidden_layers"] * one
            self.flash_calls += cfg["num_hidden_layers"]

    # -- the profiled sub-window ---------------------------------------------

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def warm(self) -> None:
        """Start and stop the profiler once: its first start takes seconds."""
        with self._profile():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        self.warmed = True

    def start(self, now: float) -> None:
        """At a round's end: the profiler, the recording and the sub-window
        start."""
        prof = self._profile()
        prof.__enter__()
        with torch.profiler.record_function(SYNC):
            self._sync = time.perf_counter()
        self._prof = prof
        self.recording = True
        self.window = (now, float("inf"))

    def stop(self, now: float) -> None:
        """At a later round's end: the sub-window, the recording and the
        profiler stop (the profiler's state belongs to the thread that
        started it)."""
        self.recording = False
        self.window = (self.window[0], now)
        self._stopping = time.perf_counter()
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._stopped_s += time.perf_counter() - self._stopping
        self._stopping = None

    def stall_s(self) -> float:
        """Seconds the engine's thread has spent stopping the profiler, so
        far: the drain waits that much longer."""
        now = time.perf_counter()
        return self._stopped_s + (now - self._stopping if self._stopping is not None else 0.0)

    def read(self) -> dict:
        """Reduce the trace: device seconds by kernel, busy and window
        seconds, the idle gaps labelled by the host phase they began in, and
        the bounds of the recorded launches."""
        for h, kvh, d, valid in self._flash_eager:
            lens = valid.sum(dim=1).tolist()
            self.flash_bound += flops.flash_bound_s(
                h, kvh, d, sum(lens), sum(lens), flops.prefix_pairs(lens))
            self.flash_calls += 1
        self._flash_eager = []
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        sync = next(e for e in events if e.get("name") == SYNC and "ts" in e)
        offset = float(sync["ts"]) - self._sync * 1e6  # trace us = host s * 1e6 + offset
        w0, w1 = (x * 1e6 + offset for x in self.window)
        labels = [(a * 1e6 + offset, b * 1e6 + offset, name) for a, b, name in self.phases]
        device = []
        by_kernel: Dict[str, float] = {}
        for e in events:
            if "dur" not in e or e.get("cat") not in DEVICE_CATS:
                continue
            s, t = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
            if t > s:
                device.append((s, t))
                by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + (t - s) * 1e-6
        busy = merge_intervals(device)
        gaps = []
        edges = [w0] + [x for span in busy for x in span] + [w1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                gaps.append((g1 - g0, _label_at(labels, g0)))
        gaps.sort(reverse=True)

        def total(names):
            return sum(v for k, v in by_kernel.items() if any(n in k for n in names))

        summary = dict(
            window_s=(w1 - w0) * 1e-6,
            busy_s=sum(t - s for s, t in busy) * 1e-6,
            by_kernel=by_kernel,
            gaps=[(label, g * 1e-6) for g, label in gaps],
            int4_device_s=total(INT4_KERNELS), int4_bound_s=self.int4_bound,
            int4_calls=self.int4_calls,
            flash_device_s=total(FLASH_KERNELS), flash_bound_s=self.flash_bound,
            flash_calls=self.flash_calls, flash_unknown=self.flash_unknown,
            graph_replays=dict(self.replays),
        )
        self._prof = None
        return summary


def _label_at(labels, t: float) -> str:
    """The innermost host phase running at ``t``, or ``host`` (the loop's
    own work: waiting for requests, bookkeeping)."""
    best = None
    for s, e, name in labels:
        if s <= t < e and (best is None or s >= best[0]):
            best = (s, name)
    return best[1] if best else "host"
