"""The engine's span record on the CPU: every round-log entry carries the
host phases of the loop (``utils/profiling.py::SPANS``) beside its old
fields, which keep their meaning; the phases nest within ``round_s`` and
``admit_s``; requests carry their submission and admission stamps and
route; the device stamps are None off the card; ``stats()`` reads the
record; ``torch.profiler`` sees the spans as ranges while it records, and
only then.  Also the benchmark's readers of the record, on hand-built runs.

The engine's loop runs on the test's own thread (``drive``), so the order of
submissions and rounds is fixed: a runner admitted alone while the device is
idle, then a wave submitted after its admission, which takes the route each
case sets up."""
import os
import time

import numpy as np
import pytest
import torch

from chatts_tpu_torch.core.config import tiny_config
from chatts_tpu_torch.models.chatts import init_params
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.serve.scheduler import Request, SamplingParams, ServeEngine
from chatts_tpu_torch.utils.profiling import SPANS
from tests.helpers import FakeTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OLD = ("kind", "admit_s", "round_s", "live", "a", "rows", "emitted", "gap_s")
ROUND_PHASES = ("dispatch_s", "wait_s", "apply_s")
ADMIT_PHASES = ("grace_s", "select_s", "process_s", "embed_s", "stage_s")
DEVICE = ("dev_start", "dev_end", "pre_dev_s", "embed_dev_s")
# The round kinds an admission of each route ends in (its first tokens).
ROUTE_KINDS = {"mono": {"mono"}, "block": {"block", "block_pre"}, "mixed": {"mixed"}}
EPS = 1e-6
# name: (engine options, the runner's max_tokens, the wave's requests).
CASES = {
    "block_pre": (dict(block_early_emit=True), 40, 2),
    "block": (dict(block_early_emit=False), 40, 2),
    "mixed": (dict(block_budget=0), 40, 2),
    # The runner ends in the first decode round, so the wave is admitted
    # after that round with no slot live: monolithically, inside the
    # round's admission.
    "mono_after_round": (dict(), 5, 1),
}


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    cfg = tiny_config(vocab_size=512, hidden_size=64, intermediate_size=128,
                      max_sequence_length=64)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    return cfg, model, ChatTSProcessor(FakeTokenizer(vocab_limit=200), cfg)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_engine(tiny, block_budget=8192, **kw):
    cfg, model, proc = tiny
    eng = ServeEngine(model, cfg, proc, device="cpu", max_batch_size=4, max_model_len=256,
                      cache_dtype=torch.float32, decode_chunk=4, **kw)
    eng.block_token_budget = block_budget
    return eng


def _req(prompt, n_points, max_tokens):
    return Request(prompt, [np.arange(float(n_points))],
                   SamplingParams(max_tokens=max_tokens, temperature=0.0))


class Watch:
    """Wraps the engine's loop methods, as the benchmark does, to note when
    each ran: the rounds dispatched and fetched, the admissions, and the
    round kind in which each request got its first token."""

    def __init__(self, eng):
        self.entries, self.dispatched, self.fetched, self.admits = [], [], [], []
        self.first_kind = {}
        self._kind = None
        dispatch, complete, admit = eng._dispatch_round, eng._complete_round, eng._admit
        finalize, log = eng._finalize_admission, eng._log_round

        def dispatch_round():
            t = time.perf_counter()
            handle = dispatch()
            if handle is not None:
                self.dispatched.append(t)
            return handle

        def complete_round(handle):
            t = time.perf_counter()
            self._kind = handle[0]
            try:
                complete(handle)
            finally:
                self._kind = None
            self.fetched.append((t, time.perf_counter()))

        def admit_():
            t = time.perf_counter()
            admit()
            self.admits.append((t, time.perf_counter()))

        def finalize_admission(reqs, *args, **kw):
            for r in reqs:
                self.first_kind[id(r)] = self._kind or "mono"
            return finalize(reqs, *args, **kw)

        def log_round(**entry):
            entry["t"] = time.perf_counter()
            self.entries.append(entry)
            log(**entry)

        eng._dispatch_round, eng._complete_round, eng._admit = (
            dispatch_round, complete_round, admit_)
        eng._finalize_admission, eng._log_round = finalize_admission, log_round


def drive(eng, runner_tokens=40, wave=2, timeout=60.0):
    """Run the engine's loop on this thread: a runner first, then after its
    admission a wave of ``wave`` requests; the loop stops when every request
    has ended.  Returns the runner, the wave and the ``Watch``."""
    runner = eng.submit(_req("runner <ts><ts/> keeps going", 16, runner_tokens))
    wave_reqs = [_req(f"wave {i} <ts><ts/> of a few words", 12, 6) for i in range(wave)]
    watch = Watch(eng)
    deadline = time.time() + timeout
    log, dispatch = eng._log_round, eng._dispatch_round

    def log_round(**entry):
        log(**entry)
        if entry["kind"] == "mono" and runner.route == "mono" and wave_reqs[0].submitted_s is None:
            for r in wave_reqs:
                eng.submit(r)
        if all(r.finished_s is not None or r.error is not None for r in [runner, *wave_reqs]):
            eng._stop.set()

    def dispatch_round():
        if time.time() > deadline:
            eng._stop.set()
        return dispatch()

    eng._log_round, eng._dispatch_round = log_round, dispatch_round
    eng._loop()
    assert time.time() <= deadline, "the requests did not end in time"
    for r in [runner, *wave_reqs]:
        assert r.error is None, r.error
    return runner, wave_reqs, watch


@pytest.mark.parametrize("case", list(CASES))
def test_round_log_carries_the_spans(tiny, case):
    opts, runner_tokens, wave = CASES[case]
    eng = make_engine(tiny, **opts)
    runner, wave_reqs, watch = drive(eng, runner_tokens, wave)
    entries = watch.entries
    assert entries == [dict(e, t=w["t"]) for e, w in zip(eng.round_snapshot(), entries)]
    kinds = [e["kind"] for e in entries]
    want = {"block_pre": "block_pre", "block": "block", "mixed": "mixed",
            "mono_after_round": "decode"}[case]
    assert want in kinds and kinds[0] == "mono"

    for e in entries:
        assert set(e) == set(OLD) | set(SPANS) | set(DEVICE) | {"t"}
        # Off the card no round carries device stamps.
        assert all(e[k] is None for k in DEVICE)
        assert all(e[f] >= 0.0 for f in SPANS)
        assert sum(e[f] for f in ROUND_PHASES) <= e["round_s"] + EPS
        if e["kind"] == "mono":
            # Its admission's phases go to the round it ran in or after.
            assert e["admit_s"] == 0.0 and e["gap_s"] == 0.0
            assert all(e[f] == 0.0 for f in (*ADMIT_PHASES, "idle_s"))
        else:
            # Phases run with no round in flight (idle waits, an admission
            # then) add up into the next round's entry, within its gap_s.
            assert sum(e[f] for f in (*ADMIT_PHASES, "idle_s")) <= \
                e["admit_s"] + e["gap_s"] + EPS

    # admit_s and round_s keep their meaning: round_s runs from the loop's
    # top (after the previous entry's log) to the end of the round's fetch,
    # and admit_s from there to the entry's log, holding the admissions made
    # after the round.
    rounds = [e for e in entries if e["kind"] != "mono"]
    assert len(rounds) == len(watch.dispatched) == len(watch.fetched)
    for e, d, (f0, f1) in zip(rounds, watch.dispatched, watch.fetched):
        assert d <= f0 <= f1 <= e["t"]
        assert e["round_s"] >= f1 - d - EPS
        assert e["t"] - e["admit_s"] >= f1 - EPS
        inside = [a for a in watch.admits if f1 <= a[0] and a[1] <= e["t"]]
        assert e["admit_s"] >= sum(a1 - a0 for a0, a1 in inside) - EPS
        t_prev = max((x["t"] for x in entries if x["t"] < d), default=None)
        if t_prev is None:
            continue
        assert e["round_s"] + e["admit_s"] <= e["t"] - t_prev + EPS
        # Admissions since the previous round's entry and before this round
        # ran with no round in flight: their phases are carried here.
        since = max((x["t"] for x in rounds if x["t"] < d), default=float("-inf"))
        if not [a for a in watch.admits if since <= a[0] < d] and e["idle_s"] == 0.0:
            # Nothing carried: the admission's phases nest within admit_s.
            assert sum(e[f] for f in ADMIT_PHASES) <= e["admit_s"] + EPS
            assert bool(inside) == (sum(e[f] for f in ADMIT_PHASES[1:]) > 0.0)

    for r in [runner, *wave_reqs]:
        assert r.submitted_s <= r.admitted_s <= r.first_token_s
        assert watch.first_kind[id(r)] in ROUTE_KINDS[r.route]
    assert runner.route == "mono"
    assert {r.route for r in wave_reqs} == \
        {{"block_pre": "block", "block": "block", "mixed": "mixed"}.get(case, "mono")}
    if case == "mono_after_round":
        # The wave's monolithic entry is logged inside the round's
        # admission, before the round's own entry, which holds the staging.
        i = kinds.index("mono", 1)
        assert kinds[i + 1] != "mono" and entries[i + 1]["stage_s"] > 0.0
        assert entries[i]["t"] > entries[i + 1]["t"] - entries[i + 1]["admit_s"]


def test_stats_read_the_record(tiny):
    eng = make_engine(tiny, block_budget=0)
    eng.slow_event_s = 1e-4
    runner, wave_reqs, _ = drive(eng)
    assert not hasattr(eng, "event_snapshot") and not hasattr(eng, "_event")
    assert not hasattr(eng, "events")
    rounds = eng.round_snapshot()
    stats = eng.stats()
    for field, name in SPANS.items():
        assert stats["span_s"][name] == pytest.approx(sum(r[field] for r in rounds))
    slow = sum(r[f] >= 1e-4 for r in rounds for f in SPANS)
    assert stats["slow_events"] == slow > 0
    assert stats["admissions"] == {"mono": 1, "mixed": 2}
    waits = sorted(r.admitted_s - r.submitted_s for r in [runner, *wave_reqs])
    assert stats["queue_wait_p50_ms"] == pytest.approx(waits[1] * 1e3)
    assert stats["queue_wait_p99_ms"] == pytest.approx(waits[2] * 1e3)
    assert stats["device_gap_s"] is None
    assert not [k for k in stats if k.endswith("_device_s")]
    assert stats["rounds_mixed"] >= 1 and stats["rounds_mono"] == 1


def test_profiler_sees_the_spans_and_only_when_it_records(tiny, monkeypatch):
    made = []
    inner = torch.profiler.record_function

    def counted(name, *args):
        made.append(name)
        return inner(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    drive(make_engine(tiny))
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        drive(make_engine(tiny))
    names = {e.name for e in prof.events()}
    ran = {"round.dispatch", "round.wait", "round.apply", "admit.select", "admit.process",
           "admit.embed", "admit.stage"}
    assert ran <= names and ran <= set(made)
    assert set(made) <= set(SPANS.values())


# ---------------------------------------------------------------------------
# The benchmark's readers of the record
# ---------------------------------------------------------------------------

NEW_METRICS = ("device_gap_pct.tok_s", "device_gap_pct.tpot", "decode_step_device_ms.tok_s",
               "admit_grace_pct.tok_s", "fetch_apply_pct.tok_s", "fetch_apply_pct.tpot",
               "processor_pct.tpot", "ts_embed_device_pct.tpot")


def _round(kind, dev=None, pre=0.0, embed=0.0, **host):
    entry = dict(kind=kind, admit_s=0.0, round_s=0.1, live=1, a=0, rows=0, emitted=1,
                 gap_s=0.0, t=0.0)
    entry.update({f: host.get(f, 0.0) for f in SPANS})
    entry.update(dev_start=dev[0] if dev else None, dev_end=dev[1] if dev else None,
                 pre_dev_s=pre if dev else None, embed_dev_s=embed if dev else None)
    return entry


def _read(rounds, span=(0.0, 2.0)):
    from port_bench.cells import Bench
    from port_bench.harness import RunRecord

    bench = Bench(ROOT)
    run = RunRecord(cfg={}, engine={"decode_chunk": 4, "max_batch_size": 4}, rounds=rounds,
                    span=span, records=[], trace=None)
    return {m: bench.reader(m).read(run) for m in NEW_METRICS}


def test_span_readers_on_known_rounds():
    # Out of order on purpose: the gaps are taken by dev_start.  Between the
    # decode rounds and the block round 0.1 s of idle device beside 0.05 s
    # of staging; then 0.05 s; the last pair's staging covers its gap.
    rounds = [
        _round("decode", (1.40, 1.48), apply_s=0.02),
        _round("decode", (1.00, 1.20), grace_s=0.03, apply_s=0.01),
        _round("block_pre", (1.35, 1.38), pre=0.05, embed=0.04, process_s=0.06),
        _round("decode", (1.50, 1.60), pre=0.5, embed=0.1, process_s=0.02),
    ]
    got = _read(rounds)
    # Gaps: 1.35 - 1.20 - 0.05 = 0.10, 1.40 - 1.38 = 0.02, and none: 0.12 of 2 s.
    assert got["device_gap_pct.tok_s"] == got["device_gap_pct.tpot"] == pytest.approx(6.0)
    # Decode rounds: 0.20 + 0.08 + 0.10 device seconds over 3 rounds of 4 steps.
    assert got["decode_step_device_ms.tok_s"] == pytest.approx(1e3 * 0.38 / 12)
    assert got["admit_grace_pct.tok_s"] == pytest.approx(1.5)
    assert got["fetch_apply_pct.tok_s"] == got["fetch_apply_pct.tpot"] == pytest.approx(1.5)
    assert got["processor_pct.tpot"] == pytest.approx(4.0)
    assert got["ts_embed_device_pct.tpot"] == pytest.approx(7.0)


def test_span_readers_read_none_without_the_fields():
    # Off the card: host phases read, device stamps None.
    off = _read([_round("decode", grace_s=0.2), _round("decode")])
    device = ("device_gap_pct.tok_s", "device_gap_pct.tpot", "decode_step_device_ms.tok_s",
              "ts_embed_device_pct.tpot")
    assert all(off[m] is None for m in device)
    assert off["admit_grace_pct.tok_s"] == pytest.approx(10.0)
    assert off["processor_pct.tpot"] == 0.0
    # A program whose entries lack the fields (the record before the spans),
    # and a run with no rounds: every reader None.
    old = [{k: v for k, v in _round("decode", (1.0, 1.1)).items() if k in OLD + ("t",)}]
    for rounds in (old, []):
        assert all(v is None for v in _read(rounds).values())


def test_span_metrics_are_in_the_benchmark():
    from port_bench.cells import Bench

    bench = Bench(ROOT)
    listed = {m["name"]: m for m in bench.spec["per_layer"]}
    for name in NEW_METRICS:
        m = listed[name]
        assert m["source"] == "program_span" and m["workloads"]
        for cell in m["workloads"]:
            assert name in [p.name for p in bench.cell(cell).per_layer]


def test_stats_report_the_glue_calls(tiny):
    """``stats()`` reports the decoder glue's call sites by path: on the CPU
    every forward of the model runs them eagerly, 4 a layer and the final
    norm, and no graph is captured."""
    from chatts_tpu_torch.ops import fused_glue

    eng = make_engine(tiny, block_budget=0)
    before = fused_glue.counts()
    drive(eng)
    stats = eng.stats()
    assert stats["glue_calls"] == fused_glue.counts()
    assert stats["glue_calls"]["fused"] == before["fused"]
    ran = stats["glue_calls"]["eager"] - before["eager"]
    assert ran > 0 and ran % (4 * tiny[0].llm.num_hidden_layers + 1) == 0
    assert stats["graph_captures"] == []
