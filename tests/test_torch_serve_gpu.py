"""The port's ``ServeEngine`` on the card, built the way a user builds it:
``device="cuda"`` with no index, or no device at all (the card is the
default), and its decode rounds replayed from a CUDA graph.

Marked ``gpu``; the test skips where there is no CUDA card.  This file imports
no JAX, so on a machine without it run it without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_serve_gpu.py
"""
import zlib

import numpy as np
import pytest
import torch

from chatts_tpu_torch.models.quantize import init_quantized_params
from chatts_tpu_torch.ops import flash_attention as fa
from chatts_tpu_torch.ops import int4_matmul as i4
from chatts_tpu_torch.ops import ragged_decode_attention as rda
from chatts_tpu_torch.serve import scheduler
from chatts_tpu_torch.serve.scheduler import SamplingParams, ServeEngine
from chatts_tpu_torch.core.config import tiny_config
from chatts_tpu_torch.processor.processor import ChatTSProcessor

pytestmark = pytest.mark.gpu


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


def test_torch_serve_engine_on_unindexed_cuda_device(tiny_int4):
    cfg, model, proc = tiny_int4
    wrappers = (fa.flash_attention, i4.int4_matmul, rda.ragged_decode_attention_int8)
    before = [fn.launches for fn in wrappers]
    with ServeEngine(model, cfg, proc, device="cuda", max_batch_size=2, max_model_len=256,
                     cache_dtype=torch.int8, decode_chunk=4) as eng:
        assert eng.device == torch.device("cuda", torch.cuda.current_device())
        req = eng.generate_sync("check <ts><ts/> the series", [np.sin(np.arange(40.0))],
                                SamplingParams(max_tokens=6, temperature=0.0), timeout=60)
    assert req.error is None, req.error
    assert req.finish_reason == "length" and len(req.output_tokens) == 6
    assert all(0 <= t < cfg.llm.vocab_size for t in req.output_tokens)
    assert all(fn.launches > n for fn, n in zip(wrappers, before))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_torch_serve_decode_graph_matches_eager_rounds(tiny_int4, monkeypatch, temperature):
    """On the card every decode round replays one CUDA graph, captured in the
    first.  13 decode steps as four rounds of 4 give the tokens of the same
    rounds run eagerly (``_decode_all_slots``, the CPU's path), greedy and
    sampled: the graph draws from the engine's generator as the eager steps
    do, and the capture's warm-up step draws from none of it."""
    cfg, model, proc = tiny_int4

    class EagerRounds:
        def __init__(self, *args):
            self.args = args

        def round(self):
            return scheduler._decode_all_slots(*self.args)

    tokens, graphs = {}, {}
    for form in ("graph", "eager"):
        if form == "eager":
            monkeypatch.setattr(scheduler, "_DecodeStepGraph", EagerRounds)
        with ServeEngine(model, cfg, proc, max_batch_size=2, max_model_len=256,
                         cache_dtype=torch.int8, decode_chunk=4) as eng:
            req = eng.generate_sync("check <ts><ts/> the series", [np.sin(np.arange(40.0))],
                                    SamplingParams(max_tokens=14, temperature=temperature),
                                    timeout=120)
        # Read once the loop has stopped: the last round is logged after
        # the request it finished is marked done.
        assert req.error is None, req.error
        assert eng.stats()["rounds_decode"] == 4
        tokens[form] = req.output_tokens
        graphs[form] = type(eng._decode_graph).__name__
    assert graphs == {"graph": "_DecodeStepGraph", "eager": "EagerRounds"}
    assert len(tokens["graph"]) == 14 and tokens["graph"] == tokens["eager"]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_torch_serve_graph_replays_after_a_mixed_admission(tiny_int4, monkeypatch, temperature):
    """A scan-sliced admission runs eagerly and updates the decode state in
    place, so the decode graph captured before it replays the state after
    it: one pure decode round (the capture), then a late request admitted by
    mixed rounds next to the runner, then pure rounds to the end; the tokens
    of both requests equal those of the same schedule with every decode
    round eager.  Driven on the test thread, so the two schedules are one."""
    cfg, model, proc = tiny_int4

    class EagerRounds:
        def __init__(self, *args):
            self.args = args

        def round(self):
            return scheduler._decode_all_slots(*self.args)

    def request(prompt, n):
        return scheduler.Request(prompt, [np.sin(np.arange(40.0))],
                                 SamplingParams(max_tokens=n, temperature=temperature))

    monkeypatch.setattr(scheduler, "MIXED_NPT", 16)
    tokens, graphs = {}, {}
    for form in ("graph", "eager"):
        if form == "eager":
            monkeypatch.setattr(scheduler, "_DecodeStepGraph", EagerRounds)
        eng = ServeEngine(model, cfg, proc, max_batch_size=2, max_model_len=256,
                          cache_dtype=torch.int8, decode_chunk=4, seed=3)
        eng.block_token_budget = 0
        runner = request("runner <ts><ts/> keeps decoding the series", 20)
        late = request("late " * 40 + "<ts><ts/> joins while it decodes", 10)
        with torch.inference_mode():
            eng.submit(runner)
            eng._admit()
            eng._complete_round(eng._dispatch_round())  # a pure decode round
            eng.submit(late)
            eng._admit()
            assert eng._pending_mixed["mode"] == "mixed"
            while eng._pending_mixed is not None or eng.live_host.any():
                eng._complete_round(eng._dispatch_round())
        assert runner.error is None and late.error is None
        assert eng.mixed_rounds_run >= 2
        tokens[form] = (runner.output_tokens, late.output_tokens)
        graphs[form] = type(eng._decode_graph).__name__
    assert graphs == {"graph": "_DecodeStepGraph", "eager": "EagerRounds"}
    assert [len(t) for t in tokens["graph"]] == [20, 10]
    assert tokens["graph"] == tokens["eager"]
