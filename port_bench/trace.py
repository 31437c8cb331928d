"""What a traced run (``--trace 1``) adds: the bounds of the port's kernel
launches, labels for what the host is doing, and a ``torch.profiler`` trace
of a steady sub-window, reduced to device time by kernel, busy time, idle
gaps and the bounds of the launches the sub-window ran.

Which kernels there are, and how each launch's bound follows from its
arguments, is the configuration's family's (``families/<family>.py``:
``KERNELS``, ``spies``, ``mixed_launches``); the counting is shared.  A
family's wrappers stand in for the port's Python entry points and hand each
launch to the tracer, which counts it under the family's key: at once while
the sub-window records, or, while the engine captures a CUDA graph, with
the capture.  The profiler sees the kernels inside a graph's replay (checked
on the H100 with PyTorch 2.11 and CUDA 12.8), so each replay of a captured
step counts the step's launches at the shapes they were captured with.  A
launch whose shapes a capture cannot give (a scan-sliced round's prefill
attention changes its query span every step) is counted eagerly only, and
the family works out the mixed step's from the admission the round consumes.
The wrappers record host numbers only and launch nothing.

Every profiler call is made on the engine's thread, between rounds, right
after a round's host fetch, when the device has finished the round and no
other thread launches work: the profiler is started and stopped once after
the first round (its first start takes seconds), and the sub-window, the
profiler and the recording of launches start and stop together at two round
ends.  The profiler's state belongs to the thread that started it; started
or stopped from the main thread while the engine launched graphs, it hung
one run and crashed others on the card.  Its stop takes seconds of the
engine's thread, in the drain, which is why a mix's ``drain_s`` leaves room.
Host phases (a round's dispatch, the fetch, an admission) are noted on the
host clock and mapped onto the trace's clock through a marker recorded at a
known host time.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import torch

from port_bench.stats import merge_intervals

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC = "port_bench.sync"


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


class Tracer:
    def __init__(self, cfg: dict, family: ModuleType):
        self.cfg = cfg
        self.family = family
        self.recording = False
        # While a graph is captured: its launches' bounds by key.
        self._capture: Optional[Dict[str, List[float]]] = None
        keys = list(family.KERNELS)
        self.calls: Dict[str, int] = dict.fromkeys(keys, 0)
        self.bound: Dict[str, float] = dict.fromkeys(keys, 0.0)
        self.unknown: Dict[str, int] = dict.fromkeys(keys, 0)
        self._eager: List[Tuple[str, Callable, tuple]] = []  # bounds worked out at read
        self.replays: Dict[str, int] = {}
        self._saved: List[tuple] = []
        self.warmed = False
        self._prof = None
        self._sync: Optional[float] = None
        self._stopping: Optional[float] = None  # host clock; while the profiler stops
        self._stopped_s = 0.0
        self.window: Optional[Tuple[float, float]] = None  # host clock
        self.phases: List[Tuple[float, float, str]] = []  # host clock

    # -- what the family's wrappers call ---------------------------------------

    def launch(self, key: str, bound: Callable[..., float], *args) -> None:
        """A launch of ``key`` whose bound is ``bound(*args)``: recorded with
        the graph being captured (each replay counts it), else counted while
        the sub-window records."""
        if _capturing():
            if self._capture is not None:
                self._capture.setdefault(key, []).append(bound(*args))
        elif self.recording:
            self.calls[key] += 1
            self.bound[key] += bound(*args)

    def counts_eager(self) -> bool:
        """Whether an eager launch counts now: the sub-window records and no
        graph is being captured."""
        return self.recording and not _capturing()

    def eager(self, key: str, bound: Optional[Callable[..., float]], *args) -> None:
        """An eager launch of ``key`` (``counts_eager``), its bound
        ``bound(*args)`` worked out when the trace is read, or None where it
        cannot be: then the kernel's roofline is not read."""
        if bound is None:
            self.unknown[key] += 1
        else:
            self._eager.append((key, bound, args))

    # -- wrappers -------------------------------------------------------------

    def install(self) -> None:
        """Put the family's wrappers and the graph classes' in place; before
        the engine is built, so that every graph it captures is recorded."""
        from chatts_tpu_torch.serve import scheduler

        tracer = self

        def graph_class(base, kind):
            class Recorded(base):
                def __init__(self, *args, **kw):
                    tracer._capture = {}
                    try:
                        super().__init__(*args, **kw)
                    finally:
                        self.bench_launches, tracer._capture = tracer._capture, None

                def round(self):
                    if tracer.recording:
                        n = self.chunk_size
                        for key, bounds in self.bench_launches.items():
                            tracer.calls[key] += n * len(bounds)
                            tracer.bound[key] += n * sum(bounds)
                        tracer.replays[kind] = tracer.replays.get(kind, 0) + n
                    return super().round()

            Recorded.__name__ = base.__name__
            return Recorded

        for owner, name, value in self.family.spies(self) + [
                (scheduler, "_DecodeStepGraph",
                 graph_class(scheduler._DecodeStepGraph, "decode")),
                (scheduler, "_MixedStepGraph",
                 graph_class(scheduler._MixedStepGraph, "mixed"))]:
            self._saved.append((owner, name, getattr(owner, name)))
            setattr(owner, name, value)

    def uninstall(self) -> None:
        for owner, name, value in reversed(self._saved):
            setattr(owner, name, value)
        self._saved = []

    def attach(self, engine) -> None:
        """Note the engine's host phases while the profiler runs, and count
        the launches of each scan-sliced round that its capture cannot give
        (the family's ``mixed_launches``)."""
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
                for key, calls, bound in tracer.family.mixed_launches(tracer.cfg, engine):
                    tracer.calls[key] += calls
                    tracer.bound[key] += bound
            return dispatch_mixed()

        engine._op_round = noted(round_kind, op_round)
        engine._admit = noted(lambda: "admit", admit)
        engine._complete_round = noted(lambda: "fetch", complete)
        engine._dispatch_mixed = mixed_round

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
        for each of the family's kernel keys its device seconds, its
        recorded launches' bounds and count, and its launches of unknown
        bound (``<key>_device_s``, ``_bound_s``, ``_calls``, ``_unknown``)."""
        for key, bound, args in self._eager:
            self.bound[key] += bound(*args)
            self.calls[key] += 1
        self._eager = []
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
        )
        for key, names in self.family.KERNELS.items():
            summary.update({f"{key}_device_s": total(names), f"{key}_bound_s": self.bound[key],
                            f"{key}_calls": self.calls[key],
                            f"{key}_unknown": self.unknown[key]})
        summary["graph_replays"] = dict(self.replays)
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
