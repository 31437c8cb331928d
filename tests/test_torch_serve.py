"""The port's continuous-batching engine and OpenAI-compatible server on a
tiny f32 ChatTS on the CPU.

Greedy tokens must match the JAX batch engine exactly (f32 weights, XLA
attention, per-step scatter decode), with the f32, the int8 and the bf16
cache, for the Qwen2 and the Qwen3 decoder; the int8 decode attention
differs from the JAX path's dequantize-first form only by f32 rounding.
Requests served together must get the tokens each gets alone, through the
monolithic, fused block and early-emit block admissions.  Every engine is
stopped on the way out, and every wait is bounded."""
import json
import queue
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu.core import config as jconfig
from chatts_tpu.models import chatts
from chatts_tpu.processor import processor as jprocessor
from chatts_tpu.runtime.engine import InferenceEngine as JaxEngine
from chatts_tpu.runtime.sampling import sample_per_slot as jax_sample_per_slot
from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.models.convert import from_jax_params
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.runtime.sampling import TOP_K_CAP, sample_per_slot
from chatts_tpu_torch.serve import scheduler
from chatts_tpu_torch.serve.scheduler import (
    Request,
    SamplingParams,
    ServeEngine,
    _WaitQueue,
)
from chatts_tpu_torch.serve.server import ChatTSServer
from tests.helpers import FakeTokenizer
from tests.test_torch_qwen import _randomize

GREEDY = dict(temperature=0.0)


TINY = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, patch_size=4,
            max_sequence_length=64, ts_token_start_index=240)


@pytest.fixture(scope="module")
def setup():
    """The port's config, processor and model; the JAX weights they hold."""
    cfg = tconfig.tiny_config(**TINY)
    params = chatts.init_params(jconfig.tiny_config(**TINY), jax.random.PRNGKey(0),
                                dtype=jnp.float32)
    proc = ChatTSProcessor(FakeTokenizer(vocab_limit=200), cfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg)
    return cfg, params, proc, model


def make_engine(setup, **kw):
    cfg, _, proc, model = setup
    kw.setdefault("device", "cpu")
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_model_len", 512)
    kw.setdefault("cache_dtype", torch.float32)
    kw.setdefault("decode_chunk", 4)
    return ServeEngine(model, cfg, proc, **kw)


def wait(reqs, timeout=60.0):
    deadline = time.time() + timeout
    while any(r.finished_s is None and r.error is None for r in reqs):
        assert time.time() < deadline, "requests did not finish"
        time.sleep(0.002)


def wait_first_token(req, timeout=60.0):
    deadline = time.time() + timeout
    while not req.output_tokens:
        assert req.error is None, req.error
        assert time.time() < deadline, "no first token"
        time.sleep(0.001)


PROMPTS = [
    ("check <ts><ts/> parity", [np.arange(12.0)]),
    ("and <ts><ts/> another longer prompt to read", [np.sin(np.arange(20.0)) * 3]),
]


CACHES = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def qwen3_setup():
    """The Qwen3 decoder (qk_norm, no attention bias) at the tiny config, its
    norm weights and biases drawn around 1 and 0 so that none is a no-op."""
    tiny = dict(TINY, qwen3=True)
    cfg = tconfig.tiny_config(**tiny)
    params = chatts.init_params(jconfig.tiny_config(**tiny), jax.random.PRNGKey(3),
                                dtype=jnp.float32)
    params = _randomize(jax.tree.map(np.asarray, params), np.random.default_rng(3))
    proc = ChatTSProcessor(FakeTokenizer(vocab_limit=200), cfg)
    model = from_jax_params(params, cfg)
    assert model.llm.layers[0].self_attn.q_norm is not None
    return cfg, params, proc, model


@pytest.mark.parametrize("cache", ["f32", "int8", "bf16", "qwen3-f32", "qwen3-int8",
                                   "qwen3-bf16"])
def test_torch_serve_greedy_matches_jax_engine(request, monkeypatch, cache):
    """Greedy tokens equal to the JAX batch engine's, f32 weights.  With the
    bf16 cache JAX's decode takes its Pallas bf16 kernel in interpret mode
    (``attn_impl="ragged"``): XLA:CPU's jitted dense decode refuses a bf16 x
    bf16 -> f32 dot.  Both engines round the same f32 K/V to bf16 and read
    it in f32, so the tokens must be equal here too."""
    qwen3 = cache.startswith("qwen3-")
    setup = request.getfixturevalue("qwen3_setup" if qwen3 else "setup")
    _, params, _, _ = setup
    jdtype, tdtype = CACHES[cache.removeprefix("qwen3-")]
    if jdtype == jnp.bfloat16:
        monkeypatch.setenv("CHATTS_RAGGED_INTERPRET", "1")
    jcfg = jconfig.tiny_config(**TINY, qwen3=qwen3)
    jproc = jprocessor.ChatTSProcessor(FakeTokenizer(vocab_limit=200), jcfg)
    jax_engine = JaxEngine(params, jcfg, cache_dtype=jdtype,
                           attn_impl="ragged" if jdtype == jnp.bfloat16 else "xla",
                           decode_recent_kv=False, decode_chunk=4)
    want = [jax_engine.generate(jproc([p], ts),
                                jconfig.GenerationConfig(max_new_tokens=7, greedy=True))
            .token_ids[0] for p, ts in PROMPTS]
    with make_engine(setup, cache_dtype=tdtype) as eng:
        reqs = [Request(p, ts, SamplingParams(max_tokens=7, **GREEDY)) for p, ts in PROMPTS]
        for r in reqs:
            eng.submit(r)
        wait(reqs)
    assert [r.output_tokens for r in reqs] == want
    assert all(r.finish_reason == "length" and r.prompt_tokens > 0 for r in reqs)
    assert eng.stats()["rounds_mono"] >= 1


RUNNER = ("runner <ts><ts/> keeps decoding", [np.arange(12.0)], 200)
WAVE = [(f"wave {i} <ts><ts/> joins", [np.arange(8.0) + i], 5 + i) for i in range(3)]


@pytest.fixture(scope="module")
def alone(setup):
    """Each request's tokens when it is served alone."""
    out = {}
    with make_engine(setup) as eng:
        for prompt, ts, n in [RUNNER] + WAVE:
            out[prompt] = eng.generate_sync(prompt, ts, SamplingParams(max_tokens=n, **GREEDY),
                                            timeout=60).output_tokens
    return out


def _req(spec):
    prompt, ts, n = spec
    return Request(prompt, ts, SamplingParams(max_tokens=n, **GREEDY))


@pytest.mark.parametrize("mode", ["mono", "block", "block_early_emit"])
def test_torch_serve_concurrent_requests_match_alone(setup, alone, mode):
    runner, wave = _req(RUNNER), [_req(w) for w in WAVE]
    with make_engine(setup, block_early_emit=mode == "block_early_emit") as eng:
        if mode == "mono":
            eng.waiting.requeue([runner] + wave)
            eng._wake.set()
        else:
            eng.submit(runner)
            wait_first_token(runner)
            # One requeue puts the whole wave in the queue at once.
            eng.waiting.requeue(wave)
            eng._wake.set()
        wait([runner] + wave)
        stats = eng.stats()
    for r in [runner] + wave:
        assert r.error is None, r.error
        assert r.output_tokens == alone[r.prompt], r.prompt
        assert r.finish_reason == "length"
    kinds = {"mono": "rounds_mono", "block": "rounds_block",
             "block_early_emit": "rounds_block_pre"}
    assert stats.get(kinds[mode], 0) >= 1, stats
    if mode == "mono":
        assert "rounds_block" not in stats and "rounds_block_pre" not in stats
    else:
        assert stats["rounds_mono"] == 1  # the runner alone


def test_torch_serve_early_emit_streams_first_token_alone(setup):
    with make_engine(setup, block_early_emit=True) as eng:
        runner = eng.submit(_req(RUNNER))
        wait_first_token(runner)
        late = eng.submit(_req(WAVE[0]))
        chunks = []
        while True:
            item = late.stream_queue.get(timeout=60)
            if item is None:
                break
            chunks.append(list(item))
        runner.cancel()
    assert len(chunks[0]) == 1
    assert sum(chunks, []) == late.output_tokens and len(late.output_tokens) == WAVE[0][2]


def test_torch_serve_eos_and_stop_tokens(setup):
    spec = ("stop <ts><ts/> now", [np.arange(8.0)])
    with make_engine(setup) as eng:
        probe = eng.generate_sync(*spec, SamplingParams(max_tokens=6, **GREEDY), timeout=60)
        stop = eng.generate_sync(*spec, SamplingParams(
            max_tokens=6, stop_token_ids=(probe.output_tokens[2],), **GREEDY), timeout=60)
    with make_engine(setup, eos_token_ids=(probe.output_tokens[1],)) as eng:
        eos = eng.generate_sync(*spec, SamplingParams(max_tokens=10, **GREEDY), timeout=60)
        first = eng.generate_sync(*spec, SamplingParams(
            max_tokens=10, stop_token_ids=(probe.output_tokens[0],), **GREEDY), timeout=60)
    cut = probe.output_tokens.index(probe.output_tokens[2])
    assert stop.output_tokens == probe.output_tokens[:cut] and stop.finish_reason == "stop"
    cut = probe.output_tokens.index(probe.output_tokens[1])
    assert eos.output_tokens == probe.output_tokens[:cut] and eos.finish_reason == "stop"
    assert first.output_tokens == [] and first.finish_reason == "stop"


def test_torch_serve_cancellation(setup):
    with make_engine(setup) as eng:
        req = eng.submit(Request("cancel me <ts><ts/>", [np.arange(8.0)],
                                 SamplingParams(max_tokens=400, **GREEDY)))
        wait_first_token(req)
        req.cancel()
        wait([req])
        queued = Request("never admitted", [], SamplingParams(max_tokens=4))
        queued.cancel()
        eng.submit(queued)
        wait([queued])
    assert req.finish_reason == "cancelled" and len(req.output_tokens) < 400
    assert queued.finish_reason == "cancelled" and queued.output_tokens == []
    assert eng.slots == [None] * 4 and not eng.live_host.any()


def test_torch_serve_rejects_over_long_alone(setup):
    with make_engine(setup, max_model_len=128) as eng:
        bad = Request("x " * 100 + "<ts><ts/>", [np.arange(8.0)], SamplingParams(max_tokens=200))
        good = Request("short <ts><ts/>", [np.arange(8.0)], SamplingParams(max_tokens=4, **GREEDY))
        eng.waiting.requeue([bad, good])
        eng._wake.set()
        wait([bad, good])
    assert bad.error is not None and "max_model_len" in bad.error
    assert good.error is None and len(good.output_tokens) == 4


def test_torch_serve_takes_the_formerly_refused_paths(setup, alone):
    """``prefill_chunk`` is accepted, and a live-slot admission that is not
    block-eligible takes the scan-sliced mixed path and finishes with the
    tokens the request gets alone; the live slot goes on undisturbed."""
    assert make_engine(setup, prefill_chunk=64).prefill_chunk == 64
    with make_engine(setup) as eng:
        runner = eng.submit(_req(RUNNER))
        wait_first_token(runner)
        eng.block_token_budget = 0
        late = eng.submit(_req(WAVE[0]))
        wait([late])
        eng.block_token_budget = 8192
        wait([runner])
        stats = eng.stats()
    assert late.error is None and late.output_tokens == alone[WAVE[0][0]]
    assert runner.error is None and runner.output_tokens == alone[RUNNER[0]]
    assert stats["rounds_mixed"] >= 1 and eng.mixed_rounds_run >= 1


def test_torch_serve_survives_a_bad_step(setup, monkeypatch):
    real = scheduler._decode_all_slots
    calls = []

    def fail_once(*args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return real(*args)

    monkeypatch.setattr(scheduler, "_decode_all_slots", fail_once)
    with make_engine(setup) as eng:
        first = eng.submit(_req(WAVE[0]))
        wait([first])
        second = eng.generate_sync(WAVE[1][0], WAVE[1][1],
                                   SamplingParams(max_tokens=WAVE[1][2], **GREEDY), timeout=60)
    assert first.error == "engine step failed: injected"
    assert len(second.output_tokens) == WAVE[1][2] and second.error is None


def test_torch_serve_warmup_runs_every_admission_form(setup):
    with make_engine(setup, max_model_len=256) as eng:
        eng.warmup(prefill_buckets=(64,), series_per_request=1, series_len=16)
        stats = eng.stats()
    assert stats["rounds_mono"] >= 4 and stats["rounds_block"] >= 1
    assert stats["rounds_decode"] >= 1
    assert stats["active_slots"] == 0 and stats["requests"] > 0


def test_torch_sample_per_slot_semantics():
    """Greedy rows take the argmax, sampled rows stay inside the top-K
    candidates, a tiny top_p collapses to the argmax; the greedy rule and
    the candidate mask match the JAX function."""
    rng = np.random.default_rng(0)
    v = 1000
    logits = rng.normal(0, 1, (4, v)).astype(np.float32)
    logits[2, 777] += 50.0
    temperature = np.asarray([0.0, 1.0, 0.8, 1.5], np.float32)
    top_p = np.asarray([1.0, 1.0, 0.01, 1.0], np.float32)
    argmax = logits.argmax(-1)
    topk_sets = [set(np.argsort(logits[i])[::-1][:TOP_K_CAP].tolist()) for i in range(4)]
    seen = set()
    gen = torch.Generator().manual_seed(0)
    for seed in range(5):
        got = sample_per_slot(torch.from_numpy(logits), gen, torch.from_numpy(temperature),
                              torch.from_numpy(top_p))
        want = np.asarray(jax_sample_per_slot(jnp.asarray(logits), jax.random.PRNGKey(seed),
                                              jnp.asarray(temperature), jnp.asarray(top_p)))
        assert got.dtype == torch.int32
        for toks in (got.numpy(), want):
            assert toks[0] == argmax[0] and toks[2] == 777
            for i in range(4):
                assert int(toks[i]) in topk_sets[i]
        seen.add(int(got[1]))
    assert len(seen) > 1  # temperature 1 over near-flat logits does sample


def test_torch_sample_per_slot_follows_the_distribution():
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.2, 1e-9]]).repeat(4000, 1))
    draws = sample_per_slot(logits, torch.Generator().manual_seed(1),
                            torch.ones(4000), torch.ones(4000))
    freq = torch.bincount(draws.long(), minlength=4).float() / len(draws)
    np.testing.assert_allclose(freq.numpy(), [0.5, 0.3, 0.2, 0.0], atol=0.03)
    # top_p 0.6 keeps the two tokens whose mass before them is below 0.6.
    draws = sample_per_slot(logits, torch.Generator().manual_seed(2),
                            torch.ones(4000), torch.full((4000,), 0.6))
    freq = torch.bincount(draws.long(), minlength=4).float() / len(draws)
    np.testing.assert_allclose(freq.numpy(), [0.625, 0.375, 0.0, 0.0], atol=0.03)


def test_torch_wait_queue_semantics():
    q = _WaitQueue()
    assert q.empty() and q.qsize() == 0
    a, b, c = object(), object(), object()
    q.put(a), q.put(b), q.put(c)
    assert q.qsize() == 3 and q.snapshot() == [a, b, c]
    assert q.get_nowait() is a
    q.remove([c])
    assert q.snapshot() == [b]
    q.requeue([a, c])  # requeue prepends, in order
    assert q.snapshot() == [a, c, b]
    q.remove([a, b, c])
    with pytest.raises(queue.Empty):
        q.get_nowait()


def _mk(prompt, series=(), max_tokens=4):
    return Request(prompt, [np.asarray(s) for s in series],
                   SamplingParams(max_tokens=max_tokens, **GREEDY))


@pytest.mark.parametrize("binning", [True, False], ids=["binning", "fifo"])
def test_torch_select_candidates_length_classes(setup, binning):
    eng = make_engine(setup, admission_binning=binning)  # loop not started
    long_text = " ".join(f"tok{i}" for i in range(300))  # class 512
    s1, l1, s2, l2 = _mk("short one"), _mk(long_text), _mk("short two"), _mk(long_text + " x")
    for r in (s1, l1, s2, l2):
        eng.submit(r)
    if binning:
        assert eng._select_candidates(4) == [s1, s2]  # the oldest's class, in order
        assert eng.waiting.snapshot() == [l1, l2]
        assert eng._select_candidates(1) == [l1]
        assert s1.token_class == 256 and l1.token_class == 512
    else:
        assert eng._select_candidates(3) == [s1, l1, s2]
    # A malformed oldest request admits alone; a cancelled one is dropped.
    eng.waiting.remove(eng.waiting.snapshot())
    bad, ok, gone = _mk("a hole <ts><ts/> but no series"), _mk("fine"), _mk("gone")
    gone.cancel()
    for r in (gone, bad, ok):
        eng.submit(r)
    if binning:
        assert eng._select_candidates(4) == [bad] and bad.token_class == -1
        assert eng._select_candidates(4) == [ok]
    else:
        assert eng._select_candidates(4) == [bad, ok]
    assert gone.finish_reason == "cancelled" and eng.waiting.empty()


def _post(port, path, body, timeout=60):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def test_torch_http_server_end_to_end(setup):
    eng = make_engine(setup)
    server = ChatTSServer(eng, FakeTokenizer(vocab_limit=200), host="127.0.0.1", port=0)
    server.start_background()
    try:
        assert server._httpd is not None
        port = server._httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/models", timeout=30) as r:
            assert json.loads(r.read())["data"][0]["id"] == "chatts"
        body = {"model": "chatts", "max_tokens": 5, "temperature": 0.0,
                "messages": [{"role": "user", "content": [
                    {"type": "text", "text": "analyze "},
                    {"type": "timeseries", "timeseries": list(np.sin(np.arange(8)))}]}]}
        data = json.loads(_post(port, "/v1/chat/completions", body))
        assert data["object"] == "chat.completion"
        assert data["choices"][0]["message"]["content"]
        assert data["choices"][0]["finish_reason"] == "length"
        assert data["usage"]["completion_tokens"] == 5
        events = _post(port, "/v1/chat/completions", dict(body, stream=True)).decode()
        chunks = [json.loads(line[6:]) for line in events.split("\n\n")
                  if line.startswith("data: {")]
        assert events.rstrip().endswith("data: [DONE]")
        # FakeTokenizer decodes each id as "tok<id>"; the deltas concatenate.
        text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
        assert text.replace("tok", " tok").split() == \
            data["choices"][0]["message"]["content"].split()
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"
        comp = json.loads(_post(port, "/v1/completions", {
            "prompt": "go <ts><ts/>", "timeseries": [[1.0, 2.0, 3.0, 4.0]],
            "max_tokens": 3, "temperature": 0.0}))
        assert comp["object"] == "text_completion" and comp["usage"]["completion_tokens"] == 3
        metrics = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                                    timeout=30).read())
        assert metrics["total_requests"] == 3 and metrics["rounds_mono"] >= 1
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/chat/completions", data=b"{oops",
                headers={"Content-Type": "application/json"}), timeout=30)
        assert err.value.code == 400
    finally:
        server.shutdown()
    assert eng._thread is None
