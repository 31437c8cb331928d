"""The engines' rounds replayed from CUDA graphs on the card, held to the same
rounds run eagerly (the CPU's path), greedy and sampled: the batch engine's
decode chunk across calls that share a graph's key and one that does not, a
scan-sliced mixed admission, and a fused block round; and both serving
rounds over the bf16 cache at seven query heads a kv head (G = 7, the 8B
shape's grouping), where the decode graph and the mixed step's decode side
take B2.  Each eager form stands in for the graph class, as
``test_torch_serve_gpu.py`` does.

Marked ``gpu``; the tests skip where there is no CUDA card.  This file
imports no JAX, so on a machine without it run it without the repository's
conftest:

    python -m pytest --noconftest -q tests/test_torch_static_rounds_gpu.py
"""
import zlib

import numpy as np
import pytest
import torch

from chatts_tpu_torch.core.config import GenerationConfig, tiny_config
from chatts_tpu_torch.models.quantize import init_quantized_params
from chatts_tpu_torch.ops import ragged_decode_attention as rda
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.runtime import engine as engine_module
from chatts_tpu_torch.runtime.engine import InferenceEngine
from chatts_tpu_torch.serve import scheduler
from chatts_tpu_torch.serve.scheduler import Request, SamplingParams, ServeEngine

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


class EagerBatchDecode:
    """Stands in for ``InferenceEngine``'s decode graph: each chunk runs its
    steps eagerly."""

    def __init__(self, engine, state, gen_cfg):
        self.engine, self.state, self.gen_cfg = engine, state, gen_cfg

    def chunk(self, steps, generator):
        engine_module._decode_chunk(self.engine, self.state, steps, generator, self.gen_cfg)


class EagerRounds:
    """Stands in for ``ServeEngine``'s decode graph or a mixed step's graph:
    each round runs its steps eagerly."""

    def __init__(self, *args, pool=None):
        self.args = args

    def round(self):
        if len(self.args) == 14:  # a mixed step's arguments
            return scheduler._mixed_round(*self.args)
        return scheduler._decode_all_slots(*self.args)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_torch_batch_decode_graph_matches_eager(tiny_int4, monkeypatch, temperature):
    """Three ``generate`` calls: two on one batch (one key: one capture, the
    cache kept) and one on a batch of other rows (a new key: a second
    capture); 11 new tokens in chunks of 4.  The tokens equal those of the
    same calls decoded eagerly, and the sampled ones draw the same bits from
    the caller's generator."""
    cfg, model, proc = tiny_int4
    batches = [proc(["check <ts><ts/> the series", "and <ts><ts/> this longer one please"],
                    [np.sin(np.arange(40.0)), np.arange(24.0)]),
               proc(["one row <ts><ts/> alone"], [np.cos(np.arange(32.0))])]
    gen = GenerationConfig(max_new_tokens=11, temperature=temperature,
                           greedy=temperature == 0.0)
    tokens, states = {}, {}
    for form in ("graph", "eager"):
        if form == "eager":
            monkeypatch.setattr(engine_module, "_BatchDecodeGraph", EagerBatchDecode)
        engine = InferenceEngine(model, cfg, decode_chunk=4, fuse=False)
        assert engine.eager_decode_reason is None
        out, seen = [], []
        for batch in (batches[0], batches[0], batches[1]):
            res = engine.generate(batch, gen,
                                  generator=torch.Generator(device="cuda").manual_seed(5))
            out.append(res.token_ids)
            seen.append(engine._decode_graph.state)
        tokens[form], states[form] = out, seen
        assert engine.decode_chunks == {"graph": 9, "eager": 0}
        assert [c["kind"] for c in engine.graph_captures] == ["decode", "decode"]
    first, again, other = states["graph"]
    assert first is again and other is not first
    assert all(len(row) == 11 for call in tokens["graph"] for row in call)
    assert tokens["graph"] == tokens["eager"]


def _drive(eng, runner, late, mode):
    """A runner's monolithic admission, then ``late`` staged next to it as
    ``mode`` ("mixed" or "block"), then rounds to the end, on this thread."""
    with torch.inference_mode():
        eng.submit(runner)
        eng._admit()
        eng._complete_round(eng._dispatch_round())  # a pure decode round
        eng.submit(late)
        eng._admit()
        assert eng._pending_mixed["mode"] == mode
        while eng._pending_mixed is not None or eng.live_host.any():
            eng._complete_round(eng._dispatch_round())


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_torch_mixed_graph_matches_eager(tiny_int4, monkeypatch, temperature):
    """A late request of about 600 tokens admitted by scan-sliced rounds
    next to a runner that ends during them (npt 16, kv_limit 512 then 1,024:
    two mixed graphs in one pool): both requests' tokens equal those of the
    same schedule with every round eager."""
    cfg, model, proc = tiny_int4

    def request(prompt, n):
        return Request(prompt, [np.sin(np.arange(40.0))],
                       SamplingParams(max_tokens=n, temperature=temperature))

    monkeypatch.setattr(scheduler, "MIXED_NPT", 16)
    tokens, stats = {}, {}
    for form in ("graph", "eager"):
        if form == "eager":
            monkeypatch.setattr(scheduler, "_DecodeStepGraph", EagerRounds)
            monkeypatch.setattr(scheduler, "_MixedStepGraph", EagerRounds)
        eng = ServeEngine(model, cfg, proc, max_batch_size=3, max_model_len=1024,
                          cache_dtype=torch.int8, decode_chunk=4, seed=3)
        eng.block_token_budget = 0
        runner = request("runner <ts><ts/> keeps decoding the series", 30)
        late = request("late " * 560 + "<ts><ts/> joins while it decodes", 10)
        _drive(eng, runner, late, "mixed")
        assert runner.error is None and late.error is None
        stats[form] = eng.stats()
        tokens[form] = (runner.output_tokens, late.output_tokens)
    assert stats["graph"]["graph_rounds"]["mixed"] >= 8
    keys = [c["key"] for c in stats["graph"]["graph_captures"] if c["kind"] == "mixed"]
    assert keys == [[1, 16, 512], [1, 16, 1024]]
    assert [len(t) for t in tokens["graph"]] == [30, 10]
    assert tokens["graph"] == tokens["eager"]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_torch_block_round_graph_matches_eager(tiny_int4, monkeypatch, temperature):
    """A late request admitted by a fused block round (``block_early_emit``
    off) next to a runner: the round's decode chunk replays the decode
    step's graph with the admitted row live, and both requests' tokens
    equal those of the same schedule with every round eager."""
    cfg, model, proc = tiny_int4

    def request(prompt, n):
        return Request(prompt, [np.sin(np.arange(40.0))],
                       SamplingParams(max_tokens=n, temperature=temperature))

    tokens, stats = {}, {}
    for form in ("graph", "eager"):
        if form == "eager":
            monkeypatch.setattr(scheduler, "_DecodeStepGraph", EagerRounds)
        eng = ServeEngine(model, cfg, proc, max_batch_size=2, max_model_len=256,
                          cache_dtype=torch.int8, decode_chunk=4, seed=3)
        runner = request("runner <ts><ts/> keeps decoding the series", 20)
        late = request("late <ts><ts/> joins while it decodes", 10)
        _drive(eng, runner, late, "block")
        assert runner.error is None and late.error is None
        assert eng.mixed_rounds_run == 1
        stats[form] = eng.stats()
        tokens[form] = (runner.output_tokens, late.output_tokens)
    assert stats["graph"]["graph_rounds"]["block"] == 1
    assert [c["kind"] for c in stats["graph"]["graph_captures"]] == ["decode"]
    assert [len(t) for t in tokens["graph"]] == [20, 10]
    assert tokens["graph"] == tokens["eager"]


@pytest.fixture
def tiny_g7():
    """G = 7: 7 query heads over 1 kv head, head_dim 128 (hidden 896)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tiny_config(vocab_size=512, hidden_size=896, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=7, num_key_value_heads=1,
                      head_dim=128, patch_size=4, max_sequence_length=64,
                      ts_token_start_index=500)
    model = init_quantized_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    return cfg, model, ChatTSProcessor(WordTokenizer(), cfg)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("mode", ["block", "mixed"])
def test_torch_bf16_serving_graphs_match_eager(tiny_g7, monkeypatch, mode, temperature):
    """The bf16 cache at G = 7: a runner, then a late request admitted next
    to it by a fused block round (its chunk replays the decode graph) or by
    scan-sliced rounds (npt 16: the mixed graphs, whose decode side reads the
    bf16 cache through B2 and whose prompt side copies its bf16 prefix); the
    tokens of both requests equal those of the same schedule with every
    round eager, and B2, never B4, served the decode steps."""
    cfg, model, proc = tiny_g7

    def request(prompt, n):
        return Request(prompt, [np.sin(np.arange(40.0))],
                       SamplingParams(max_tokens=n, temperature=temperature))

    monkeypatch.setattr(scheduler, "MIXED_NPT", 16)
    tokens, stats = {}, {}
    for form in ("graph", "eager"):
        if form == "eager":
            monkeypatch.setattr(scheduler, "_DecodeStepGraph", EagerRounds)
            monkeypatch.setattr(scheduler, "_MixedStepGraph", EagerRounds)
        eng = ServeEngine(model, cfg, proc, max_batch_size=3, max_model_len=1024,
                          cache_dtype=torch.bfloat16, decode_chunk=4, seed=3)
        if mode == "mixed":
            eng.block_token_budget = 0
        runner = request("runner <ts><ts/> keeps decoding the series", 30)
        late = request(("late " * 560 if mode == "mixed" else "late ")
                       + "<ts><ts/> joins while it decodes", 10)
        before = (rda.ragged_decode_attention.launches,
                  rda.ragged_decode_attention_int8.launches)
        _drive(eng, runner, late, mode)
        assert runner.error is None and late.error is None
        assert rda.ragged_decode_attention.launches > before[0]
        assert rda.ragged_decode_attention_int8.launches == before[1]
        stats[form] = eng.stats()
        tokens[form] = (runner.output_tokens, late.output_tokens)
    rounds = stats["graph"]["graph_rounds"]
    assert rounds["decode"] >= 1 and rounds.get(mode, 0) >= 1, rounds
    assert [len(t) for t in tokens["graph"]] == [30, 10]
    assert tokens["graph"] == tokens["eager"]
