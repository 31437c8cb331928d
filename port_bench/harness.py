"""One run of one cell: the port's ``ServeEngine`` under the cell's traffic,
its metrics, and the check of what it served.

The run builds the weights on the device from the seed and the port's model
from them, both by the configuration's decoder family
(``families/<family>.py``), builds the engine
(``configs/<config>.json``'s ``engine``), captures the graph of every
scan-sliced round that a wave of the mix can run (``capture_mixed``), and
starts the traffic: its ramp is the rest of the warm-up, so the window opens
on an engine that has admitted, captured its decode graph and reached the
mix's steady state with this cell's own shapes and no others.  Set-up is everything from the process's start to the
window's opening.  After the window the requests due in it are drained, the
peak memory is read, the engine is freed, and a sample of what it served is
held to the family's plain reference (``check.py``).

Timing is by the host clock throughout: every request records when each of
its tokens reached its stream (``_Stream``), and every engine round when it
ended (``RoundClock``), so rates are taken over whole rounds and tails over
every request due in the window.
"""
from __future__ import annotations

import dataclasses
import gc
import queue
import sys
import time
import traceback
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from port_bench import check, stats
from port_bench.cells import Bench, Cell
from port_bench.reference.processor import WordTokenizer
from port_bench.trace import Tracer
from port_bench.traffic import Spec, Traffic

# A traced run profiles the last ``trace_s`` seconds of its window (a traffic
# file's key: the sub-window holds a few rounds of the mix), from one round
# end to the first after the window, and reads the round-log metrics before
# it.


def log(msg: str) -> None:
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Record:
    """One request as its client sees it."""

    spec: Spec
    client: int
    due: float  # when it was due (open loop) or sent (closed loop)
    req: object = None  # the engine's Request
    sent: float = 0.0
    puts: List[Tuple[float, int]] = dataclasses.field(default_factory=list)
    done: Optional[float] = None
    route: Optional[str] = None  # the admission that took it: mono, block or mixed

    @property
    def ok(self) -> bool:
        return self.done is not None and self.req.error is None

    @property
    def tokens(self) -> int:
        return sum(n for _, n in self.puts)


class _Stream(queue.Queue):
    """A request's stream queue that notes when each batch of its tokens
    arrives and tells the driver when the request ends."""

    def __init__(self, record: Record, ended: "queue.Queue[Record]"):
        super().__init__()
        self.record, self.ended = record, ended

    def put(self, item, block=True, timeout=None):
        now = time.perf_counter()
        if item is None:
            if self.record.done is None:
                self.record.done = now
                self.ended.put(self.record)
        else:
            self.record.puts.append((now, len(item)))


class RoundClock:
    """Stamps each entry of the engine's round log with the time it ended,
    and runs the traced run's sub-window from one round end to another."""

    def __init__(self, engine, tracer: Optional[Tracer]):
        self.entries: List[dict] = []
        self.tracer = tracer
        self.trace_from = self.trace_until = float("inf")
        self.trace_error: Optional[str] = None
        self.captures: List[Tuple[float, str, tuple, float]] = []
        self.routes: Dict[int, str] = {}  # id of a Request: its admission's route
        inner, inner_capture = engine._log_round, engine._log_capture
        inner_prefill = engine._prefill_requests

        def prefill_requests(reqs, slots, batch, keep_rows, mode="mono"):
            for r in reqs:
                self.routes[id(r)] = mode
            return inner_prefill(reqs, slots, batch, keep_rows, mode)

        def log_round(**entry):
            entry["t"] = time.perf_counter()
            self.entries.append(entry)
            inner(**entry)
            if self.tracer is not None and self.trace_error is None:
                try:
                    self._maybe_trace(entry["t"])
                except Exception:  # the run reports it and prints no result
                    self.trace_error = traceback.format_exc()

        def log_capture(kind, key, graph, seconds):
            self.captures.append((time.perf_counter(), kind, tuple(key), seconds))
            inner_capture(kind, key, graph, seconds)

        inner_dispatch = engine._dispatch_round

        def dispatch_round():
            # The loop's top, on the engine's thread: where no round ends
            # after the window (the engine idle), the sub-window ends here.
            tr = self.tracer
            if (tr is not None and tr.window is not None and tr.window[1] == float("inf")
                    and engine._pending_mixed is None and not engine.live_host.any()):
                now = time.perf_counter()
                if now >= self.trace_until and self.trace_error is None:
                    try:
                        tr.stop(now)
                    except Exception:  # the run reports it and prints no result
                        self.trace_error = traceback.format_exc()
            return inner_dispatch()

        engine._log_round, engine._log_capture = log_round, log_capture
        engine._prefill_requests = prefill_requests
        engine._dispatch_round = dispatch_round

    def _maybe_trace(self, now: float) -> None:
        tr = self.tracer
        if tr is None:
            return
        if not tr.warmed:
            tr.warm()
        elif tr.window is None and now >= self.trace_from:
            tr.start(now)
        elif tr.window is not None and tr.window[1] == float("inf") \
                and now >= self.trace_until:
            tr.stop(now)

    def stamps(self) -> List[float]:
        return [e["t"] for e in self.entries]


@dataclasses.dataclass
class RunRecord:
    """What the per-layer readers read: the configuration and its family,
    the rounds of the measured part of the window, the requests, and a traced
    run's trace."""

    cfg: dict
    engine: dict
    rounds: List[dict]
    span: Tuple[float, float]  # first and last round end of the measured part
    records: List[Record]
    trace: Optional[dict]
    family: Optional[ModuleType] = None


def engine_kwargs(cfg: dict) -> dict:
    """The ``ServeEngine``'s keyword arguments from the configuration's
    ``engine``, unless its family gives its own (``engine_kwargs``)."""
    e = dict(cfg["engine"])
    e["cache_dtype"] = {"int8": torch.int8, "bfloat16": torch.bfloat16}[e["cache_dtype"]]
    return e


def open_plan(traffic: Traffic, seconds: float) -> Tuple[np.ndarray, List[Spec]]:
    """An open loop's due times (from the ramp's start) and requests, made
    before the ramp starts."""
    offsets = traffic.arrivals(seconds)
    return offsets, [traffic.spec(i) for i in range(len(offsets))]


def padded_lengths(processor, traffic: Traffic) -> List[int]:
    """The padded prompt lengths of the mix: the processor's length for each
    of its request shapes alone.  A wave pads to its longest request's, so
    these are every length a wave can have."""
    lengths = set()
    for i in range(traffic.pool):
        spec = traffic.spec(i)
        lengths.add(int(processor([spec.prompt], spec.series).input_ids.shape[1]))
    return sorted(lengths)


def mixed_keys(engine, lengths: List[int]) -> List[tuple]:
    """The (a, npt, kv_limit) of every scan-sliced round that a wave of
    these padded lengths can run: each admission row count up to the
    engine's bucket, routed and sized by the engine's own rules, and each
    round of the admission."""
    keys: List[tuple] = []
    for n in range(1, engine._a_bucket + 1):
        for t in lengths:
            if engine._block_eligible(n, t):
                continue
            a, npt, c, t_pad = engine._mixed_plan(n, t)
            if t_pad > engine.max_model_len:
                continue  # monolithic
            for o in range(0, t_pad, c):
                # The span limit of the round at offset o (_dispatch_mixed).
                kv_limit = min(engine.max_model_len, -(-min(o + c, t_pad) // 512) * 512)
                if (a, npt, kv_limit) not in keys:
                    keys.append((a, npt, kv_limit))
    return keys


def capture_mixed(engine, keys: List[tuple]) -> None:
    """Capture the scan-sliced step's graph of each key before the engine
    starts, as its first round with that key would (``_dispatch_mixed``), so
    that no capture, about a second each, falls in the window.  The inputs
    are zeros: no decode row is live and every admission row is a pad, so
    the warm-up step writes only pad spans into a slot that no request holds
    yet.  Off the card the engine runs its rounds eagerly and captures
    nothing."""
    if engine.eager_decode_reason is not None or not keys:
        return
    from chatts_tpu_torch.serve import scheduler

    with torch.inference_mode():  # as the engine's loop runs
        probe = engine.model.llm.embed(
            torch.zeros((1, 1), dtype=torch.int64, device=engine.device))
        for key in keys:
            _capture_one(engine, scheduler, key, probe.shape[-1], probe.dtype)


def _capture_one(engine, scheduler, key: tuple, hdim: int, dtype) -> None:
    a, npt, kv_limit = key
    if key in engine._mixed_graphs:
        return
    inp = engine._mixed_inputs.get((a, npt))
    if inp is None:
        inp = engine._mixed_inputs[(a, npt)] = scheduler._MixedInputs(
            engine.max_batch_size, a, npt, engine.decode_chunk, hdim, dtype, engine.device)
    if engine._mixed_pool is None:
        engine._mixed_pool = torch.cuda.graph_pool_handle()
    args = (engine.model, engine.decode_chunk, npt, kv_limit, engine.caches, engine.tokens,
            engine.cur_lens, engine._active_device(), engine.temperature, engine.top_p,
            engine._eos_dev, engine.budget, engine.generator, inp)
    start = time.perf_counter()
    graph = engine._mixed_graphs[key] = scheduler._MixedStepGraph(*args, pool=engine._mixed_pool)
    engine._log_capture("mixed", key, graph, time.perf_counter() - start)


def drive(engine, traffic: Traffic, seconds: float, records: List[Record],
          t_start: float, plan=None) -> dict:
    """Send the traffic from ``t_start``: the ramp, then the window of
    ``seconds``; return when the window closes.  ``plan`` is an open loop's
    ``open_plan``.  Returns the window's times, how late the sends ran and
    the waiting queue's length at both ends."""
    from chatts_tpu_torch.serve.scheduler import Request, SamplingParams

    mix = traffic.mix
    t_open = t_start + float(mix["ramp_s"])
    t_close = t_open + seconds
    ended: "queue.Queue[Record]" = queue.Queue()
    queue_at: Dict[str, int] = {}

    def send(rec: Record) -> None:
        rec.req = Request(rec.spec.prompt, rec.spec.series,
                          SamplingParams(max_tokens=rec.spec.max_tokens,
                                         temperature=rec.spec.temperature),
                          stream_queue=_Stream(rec, ended))
        rec.sent = time.perf_counter()
        records.append(rec)
        engine.submit(rec.req)

    def note_queue(now: float) -> None:
        if "open" not in queue_at and now >= t_open:
            queue_at["open"] = engine.waiting.qsize()

    if traffic.loop == "closed":
        n = 0
        for c in range(int(mix["clients"])):
            send(Record(traffic.spec(n), c, time.perf_counter()))
            n += 1
        while True:
            now = time.perf_counter()
            note_queue(now)
            if now >= t_close:
                break
            try:
                rec = ended.get(timeout=min(0.05, t_close - now))
            except queue.Empty:
                continue
            send(Record(traffic.spec(n), rec.client, time.perf_counter()))
            n += 1
        late = 0.0
    else:
        offsets, specs = plan
        late = 0.0
        for i, (t, spec) in enumerate(zip(offsets + t_start, specs)):
            while True:
                now = time.perf_counter()
                note_queue(now)
                if now >= t:
                    break
                time.sleep(min(t - now, 0.05))
            late = max(late, time.perf_counter() - t)
            send(Record(spec, i, float(t)))
        while time.perf_counter() < t_close:
            note_queue(time.perf_counter())
            time.sleep(min(0.05, max(0.0, t_close - time.perf_counter())))
    queue_at.setdefault("open", engine.waiting.qsize())
    queue_at["close"] = engine.waiting.qsize()
    return dict(t_open=t_open, t_close=t_close, late_s=late, queue=queue_at)


def in_window(records: List[Record], loop: str, t_open: float, t_close: float) -> List[Record]:
    """The requests a run answers for: due in the window (open loop), or
    finished or in flight in it (closed loop)."""
    if loop == "open":
        return [r for r in records if t_open <= r.due < t_close]
    return [r for r in records if r.sent < t_close and (r.done is None or r.done > t_open)]


def drain(records: List[Record], limit_s: float, stall_s=lambda: 0.0) -> None:
    """Wait until every record is done, for ``limit_s`` seconds of the
    engine's time: ``stall_s()`` is the time its thread spent on the traced
    run's profiler meanwhile, which is added."""
    start = time.perf_counter()
    for r in records:
        while r.done is None and time.perf_counter() < start + limit_s + stall_s():
            time.sleep(0.01)


def end_to_end(cell: Cell, records: List[Record], clock: RoundClock, w: dict,
               setup_s: float) -> Dict[str, float]:
    """The cell's end-to-end metrics."""
    due = in_window(records, cell.traffic["loop"], w["t_open"], w["t_close"])
    done = [r for r in due if r.ok and r.puts]
    values = {"setup_s": setup_s}
    span = stats.round_window(clock.stamps(), w["t_open"], w["t_close"])
    if span is not None:
        lo, hi = span
        puts = [p for r in records for p in r.puts]
        values["output_tok_s"] = stats.count_in(puts, lo, hi) / (hi - lo)
    ttft = [(r.puts[0][0] - r.due) * 1e3 for r in done]
    tpot = [(r.puts[-1][0] - r.puts[0][0]) * 1e3 / (r.tokens - 1) for r in done if r.tokens > 1]
    for name, vals in (("ttft", ttft), ("tpot", tpot)):
        for p in (50, 80, 90, 95, 99):
            v = stats.percentile(vals, p)
            if v is not None:
                values[f"{name}_p{p}_ms"] = v
    return values


def run(bench: Bench, name: str, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda", rate: Optional[float] = None, control: bool = False) -> dict:
    """One run of cell ``name``.  Returns the result: the JSON line's keys,
    the numbers the check compared, and the run's own readings."""
    cell = bench.cell(name)
    cfg = cell.config
    mix = dict(cell.traffic, rate=rate) if rate is not None else cell.traffic
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    from chatts_tpu_torch.processor.processor import ChatTSProcessor
    from chatts_tpu_torch.serve.scheduler import ServeEngine

    if dev.type == "cuda":
        # The kernels and the host packer are built here, in set-up: only the
        # first run in a checkout compiles them.
        from chatts_tpu_torch.kernels import build
        build.build()
    family = bench.family(cfg["family"])
    w = family.make(cfg, seed, dev)
    pcfg, model = family.port_model(cfg, w)
    processor = ChatTSProcessor(WordTokenizer(), pcfg)
    processor(["build <ts><ts/>"], [np.zeros(16)])
    tracer = Tracer(cfg, family) if trace else None
    if tracer is not None:
        tracer.install()
    try:
        engine = ServeEngine(model, pcfg, processor, device=dev, seed=seed % (1 << 63),
                             **getattr(family, "engine_kwargs", engine_kwargs)(cfg))
        if tracer is not None:
            tracer.attach(engine)
        clock = RoundClock(engine, tracer)
        traffic = Traffic(mix, seed)
        keys = mixed_keys(engine, padded_lengths(processor, traffic))
        capture_mixed(engine, keys)
        records: List[Record] = []
        plan = open_plan(traffic, seconds) if traffic.loop == "open" else None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        engine.start()
        t_start = time.perf_counter()
        t_close = t_start + float(mix["ramp_s"]) + seconds
        if tracer is not None:
            clock.trace_from = t_close - float(mix["trace_s"])
            clock.trace_until = t_close
        w_info = drive(engine, traffic, seconds, records, t_start, plan)
        setup_s = w_info["t_open"] - t0
        due = in_window(records, mix["loop"], w_info["t_open"], w_info["t_close"])
        drain(due, float(mix["drain_s"]), tracer.stall_s if tracer is not None else lambda: 0.0)
        for r in records:
            r.route = clock.routes.get(id(r.req))
        if tracer is not None and tracer.window is not None:
            deadline = time.perf_counter() + 10
            while tracer.window[1] == float("inf") and time.perf_counter() < deadline:
                time.sleep(0.01)
        engine.stop()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        values = end_to_end(cell, records, clock, w_info, setup_s)
        failed = [r for r in due if not r.ok or r.tokens != r.spec.max_tokens]
        # The rounds whose metrics the readers take: the window's, up to the
        # traced sub-window.
        traced = tracer is not None and tracer.window is not None \
            and tracer.window[1] != float("inf")
        hi = tracer.window[0] if traced else w_info["t_close"]
        span = stats.round_window(clock.stamps(), w_info["t_open"], hi) or (0.0, 0.0)
        rounds = [e for e in clock.entries if span[0] < e["t"] <= span[1]]
        summary = tracer.read() if traced else None
        run_record = RunRecord(cfg, cfg["engine"], rounds, span, records, summary, family)
        routes: Dict[str, int] = {}
        for r in due:
            routes[str(r.route)] = routes.get(str(r.route), 0) + 1
        info = dict(window=w_info, rounds=len(rounds), captures=len(clock.captures),
                    mixed_keys=len(keys), routes=routes,
                    trace_error=clock.trace_error,
                    captures_in_window=[c for c in clock.captures
                                        if w_info["t_open"] <= c[0] <= w_info["t_close"]])
    finally:
        if tracer is not None:
            tracer.uninstall()
    # The program's state goes before the reference runs.
    del engine, model, clock
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    verdict = check.check(family, cfg, w, due, seed, control=control)
    del w
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(cell=cell, values=values, run_record=run_record, attempted=len(due),
                failed=len(failed), verdict=verdict, peak=peak, info=info)
