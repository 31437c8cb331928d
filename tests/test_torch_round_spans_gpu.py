"""The engine's span record on the card: each round's device start and end,
from CUDA events read on the host clock, follow one another, and end before
the host's fetch of the round ends; under ``torch.profiler`` the spans
appear as ranges of their names, and only then.

Marked ``gpu``; the tests skip where there is no CUDA card.  This file
imports no JAX, so on a machine without it run it without the repository's
conftest:

    python -m pytest --noconftest -q tests/test_torch_round_spans_gpu.py
"""
import time
import zlib

import numpy as np
import pytest
import torch

from chatts_tpu_torch.core.config import tiny_config
from chatts_tpu_torch.models.quantize import init_quantized_params
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.serve.scheduler import Request, SamplingParams, ServeEngine
from chatts_tpu_torch.utils.profiling import SPANS

pytestmark = pytest.mark.gpu
# A round's end is stamped before its result is copied to the host, so the
# host's fetch ends after it; the two clocks may disagree by this much.
CLOCK_TOL_S = 0.2e-3


class WordTokenizer:
    """One id in [10, 400) per whitespace word."""

    pad_token_id = 0
    eos_token_id = 1

    def encode(self, text, add_special_tokens=False):
        return [10 + zlib.crc32(w.encode()) % 390 for w in text.split()]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{int(i)}" for i in ids)


@pytest.fixture
def tiny_int4():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # head_dim 128 and int4 widths that are multiples of 128, as the kernels take.
    cfg = tiny_config(vocab_size=512, hidden_size=256, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      head_dim=128, patch_size=4, max_sequence_length=64,
                      ts_token_start_index=500)
    model = init_quantized_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    return cfg, model, ChatTSProcessor(WordTokenizer(), cfg)


def drive(eng, timeout=120.0):
    """Run the engine's loop on this thread (as ``test_torch_round_spans.py``
    does): a runner admitted alone, then a wave of two after it; returns the
    entries logged and the host times at which each round was dispatched."""
    def req(prompt, n, max_tokens):
        return Request(prompt, [np.sin(np.arange(float(n)))],
                       SamplingParams(max_tokens=max_tokens, temperature=0.0))

    runner = eng.submit(req("runner <ts><ts/> keeps going", 40, 24))
    wave = [req(f"wave {i} <ts><ts/> of a few words", 32, 6) for i in range(2)]
    entries, dispatched = [], []
    deadline = time.time() + timeout
    log, dispatch = eng._log_round, eng._dispatch_round

    def log_round(**entry):
        entries.append(entry)
        log(**entry)
        if entry["kind"] == "mono" and wave[0].submitted_s is None:
            for r in wave:
                eng.submit(r)
        if all(r.finished_s is not None or r.error is not None for r in [runner, *wave]):
            eng._stop.set()

    def dispatch_round():
        if time.time() > deadline:
            eng._stop.set()
        t = time.perf_counter()
        handle = dispatch()
        if handle is not None:
            dispatched.append(t)
        return handle

    eng._log_round, eng._dispatch_round = log_round, dispatch_round
    eng._loop()
    assert time.time() <= deadline, "the requests did not end in time"
    for r in [runner, *wave]:
        assert r.error is None, r.error
    return entries, dispatched


def make_engine(tiny_int4, block_budget=8192):
    cfg, model, proc = tiny_int4
    eng = ServeEngine(model, cfg, proc, device="cuda", max_batch_size=4, max_model_len=256,
                      cache_dtype=torch.int8, decode_chunk=4)
    eng.block_token_budget = block_budget
    return eng


@pytest.mark.parametrize("block_budget", [8192, 0], ids=["block", "scan-sliced"])
def test_device_stamps_follow_the_rounds(tiny_int4, block_budget):
    eng = make_engine(tiny_int4, block_budget)
    fetched = []
    complete = eng._complete_round

    def complete_round(handle):
        # The fetch's own sync, made here first so its end can be stamped.
        torch.cuda.current_stream().synchronize()
        fetched.append(time.perf_counter())
        complete(handle)

    eng._complete_round = complete_round
    entries, dispatched = drive(eng)
    assert {e["kind"] for e in entries} >= {"mono", "decode",
                                           "block" if block_budget else "mixed"}
    for e in entries:
        assert e["dev_start"] < e["dev_end"] and e["pre_dev_s"] >= 0.0
        assert e["embed_dev_s"] >= 0.0
    assert sum(e["embed_dev_s"] for e in entries) > 0.0  # the wave's embedding
    ordered = sorted(entries, key=lambda e: e["dev_start"])
    for a, b in zip(ordered, ordered[1:]):
        assert b["dev_start"] >= a["dev_end"]
    rounds = [e for e in entries if e["kind"] != "mono"]
    assert len(rounds) == len(fetched) == len(dispatched)
    for e, launched, fetch_end in zip(rounds, dispatched, fetched):
        assert launched <= e["dev_start"] + CLOCK_TOL_S
        assert e["dev_end"] <= fetch_end + CLOCK_TOL_S
    assert eng.stats()["device_gap_s"] >= 0.0


def test_profiler_sees_the_spans_and_only_when_it_records(tiny_int4, monkeypatch):
    made = []
    inner = torch.profiler.record_function

    def counted(name, *args):
        made.append(name)
        return inner(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    drive(make_engine(tiny_int4))
    assert made == []
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        drive(make_engine(tiny_int4))
    names = {e.name for e in prof.events()}
    ran = {"round.dispatch", "round.wait", "round.apply", "admit.select", "admit.process",
           "admit.embed", "admit.stage"}
    assert ran <= names and ran <= set(made)
    assert set(made) <= set(SPANS.values())
