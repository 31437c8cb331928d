"""The scan-sliced mixed admission: the decoder's ``forward_mixed`` against
JAX ``qwen.forward_mixed``, and ``ServeEngine``'s mixed rounds against the
JAX batch engine and against the port's own block and monolithic
admissions, on a tiny f32 ChatTS on the CPU.

Tolerances: 1e-4 (rtol and atol) in f32 with the f32 cache, as
``test_torch_qwen.py``; with the int8 cache the codes written from f32
activations may round the other way at a .5 boundary (at most one step, in
few elements), and values read from them compare at ``DECODE_TOL`` 2e-3, as
``test_torch_int8_kv.py``; with the bf16 cache (f32 weights) the hidden
states compare at 1e-4 and the cache is equal but where a bf16 rounding
lands the other way (one ulp, in few elements).  Greedy tokens must be exact.  Every engine is
stopped on the way out, and every wait is bounded."""
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu.core import config as jconfig
from chatts_tpu.models import chatts
from chatts_tpu.models import qwen as jqwen
from chatts_tpu.processor import processor as jprocessor
from chatts_tpu.runtime.engine import InferenceEngine as JaxEngine
from chatts_tpu.serve.scheduler import ServeEngine as JaxServeEngine
from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.models.convert import from_jax_params, qwen_from_jax
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.serve import scheduler
from chatts_tpu_torch.serve.scheduler import Request, SamplingParams, ServeEngine
from tests.helpers import FakeTokenizer
from tests.test_torch_qwen import _randomize

TOL = 1e-4
DECODE_TOL = 2e-3
GREEDY = dict(temperature=0.0)


# ---------------------------------------------------------------------------
# forward_mixed against the JAX function
# ---------------------------------------------------------------------------

def _llm_config(m=tconfig, qwen3=False):
    return m.tiny_config(vocab_size=512, hidden_size=128, intermediate_size=256,
                         num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                         qwen3=qwen3).llm


def _random_caches(lcfg, b, cap, int8: bool, rng):
    """The same random layer caches as numpy arrays: a prefix some earlier
    rounds wrote."""
    kvh, d = lcfg.num_key_value_heads, lcfg.head_dim
    out = []
    for _ in range(lcfg.num_hidden_layers):
        if int8:
            out.append(tuple(rng.integers(-127, 128, (b, kvh, cap, d)).astype(np.int8)
                             for _ in range(2))
                       + tuple((rng.random((b, kvh, cap)) + 0.5).astype(np.float32) / 40
                               for _ in range(2)))
        else:
            out.append(tuple(rng.normal(0, 1, (b, kvh, cap, d)).astype(np.float32)
                             for _ in range(2)))
    return out


def _assert_bf16_close(got, want) -> None:
    """A bf16 cache written from f32 K/V that agree to f32 rounding: equal
    but where one lands on the other side of a bf16 half step (one ulp, in
    few elements)."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    assert (diff <= 2.0 ** -7 * np.abs(want)).all() and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("cache", ["f32", "int8", "bf16", "qwen3-f32", "qwen3-int8",
                                   "qwen3-bf16"])
def test_torch_forward_mixed_matches_jax(cache):
    """B 4 decode rows (row 2 inactive: it is the admission's slot), A 2
    admission rows of npt 8 (row 1 a pad), two steps at offsets 8 and 16
    with kv_limit 16 then 32: hidden states of the active decode rows and of
    every admission row, and every cache buffer, after each step.  The
    Qwen3 decoder's norm weights are drawn around 1, so that neither q_norm
    nor k_norm is a no-op."""
    qwen3 = cache.startswith("qwen3-")
    cache = cache.removeprefix("qwen3-")
    lcfg, jlcfg = _llm_config(qwen3=qwen3), _llm_config(jconfig, qwen3)
    params = jax.tree.map(np.asarray, jqwen.init_params(jlcfg, jax.random.PRNGKey(4),
                                                        dtype=jnp.float32))
    if qwen3:
        params = _randomize(params, np.random.default_rng(4))
    params = jax.tree.map(np.asarray, jqwen.fuse_projections(params))
    model = qwen_from_jax(params, lcfg)
    rng = np.random.default_rng(6)
    b, a, npt, cap = 4, 2, 8, 32
    int8, bf16 = cache == "int8", cache == "bf16"
    caches = _random_caches(lcfg, b, cap, int8, rng)
    jcaches = [tuple(jnp.asarray(x, jnp.bfloat16 if bf16 else x.dtype) for x in layer)
               for layer in caches]
    tcaches = [tuple(torch.from_numpy(x.copy()).to(torch.bfloat16 if bf16 else None)
                     for x in layer) for layer in caches]
    active = np.asarray([True, True, False, True])
    cur = np.asarray([5, 20, 7, 11], np.int32)
    adm_slots = np.asarray([2, 0], np.int32)
    adm_seq_lens = np.asarray([13, 0], np.int32)
    kv_pos = np.tile(np.arange(cap, dtype=np.int32)[None], (b, 1))
    # JAX routes inactive decode rows and pad admission rows out of bounds.
    write_rows = np.concatenate([np.where(active, np.arange(b), b + a + np.arange(b)),
                                 np.repeat(np.asarray([2, b + 1]), npt)]).astype(np.int32)
    keep = np.concatenate([np.flatnonzero(active), b + np.arange(a * npt)])
    tol = DECODE_TOL if int8 else TOL
    for off, kv_limit in ((8, 16), (16, 32)):
        embeds = rng.normal(0, 1, (1, b + a * npt, lcfg.hidden_size)).astype(np.float32)
        positions = np.concatenate([cur, np.tile(off + np.arange(npt), a)]).astype(
            np.int32)[None]
        lengths = np.where(active, cur + 1, 1).astype(np.int32)
        jh, jcaches = jqwen.forward_mixed(
            params, jlcfg, jnp.asarray(embeds), jnp.asarray(positions), b=b, a=a, npt=npt,
            write_rows=jnp.asarray(write_rows), adm_slots=jnp.asarray(adm_slots),
            adm_seq_lens=jnp.asarray(adm_seq_lens), kv_caches=jcaches,
            dec_kv_valid=jnp.asarray((kv_pos <= cur[:, None]) & active[:, None]),
            kv_positions=jnp.asarray(kv_pos), dec_kv_lengths=jnp.asarray(lengths),
            kv_limit=kv_limit, attn_impl="xla")
        th = model.forward_mixed(
            torch.from_numpy(embeds), torch.from_numpy(positions), b=b, a=a, npt=npt,
            kv_caches=tcaches, dec_rows=torch.from_numpy(np.flatnonzero(active)),
            dec_kv_lengths=torch.from_numpy(lengths), adm_slots=torch.from_numpy(adm_slots),
            n_real=1, adm_seq_lens=torch.from_numpy(adm_seq_lens), span_start=off,
            kv_limit=kv_limit)
        np.testing.assert_allclose(th.numpy()[0, keep], np.asarray(jh)[0, keep],
                                   rtol=tol, atol=tol)
        for tlayer, jlayer in zip(tcaches, jcaches):
            for got, want in zip(tlayer, jlayer):
                if bf16:
                    _assert_bf16_close(got, want)
                    continue
                got, want = got.numpy(), np.asarray(want)
                if int8 and got.dtype == np.int8:
                    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
                else:
                    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        cur = cur + active


# ---------------------------------------------------------------------------
# ServeEngine's mixed rounds
# ---------------------------------------------------------------------------

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


def _req(prompt, series, n):
    return Request(prompt, series, SamplingParams(max_tokens=n, **GREEDY))


def test_torch_scan_sliced_admission_matches_jax_engine(setup):
    """Block rounds off (``block_token_budget`` 0): a runner decodes while a
    late request is admitted by scan-sliced rounds; both get the JAX batch
    engine's greedy tokens."""
    _, params, _, _ = setup
    jcfg = jconfig.tiny_config(**TINY)
    jproc = jprocessor.ChatTSProcessor(FakeTokenizer(vocab_limit=200), jcfg)
    jax_engine = JaxEngine(params, jcfg, cache_dtype=jnp.float32, attn_impl="xla",
                           decode_recent_kv=False, decode_chunk=4)
    p1, t1 = "first long runner <ts><ts/> keeps decoding", [np.arange(12.0)]
    p2, t2 = "second arrives <ts><ts/> mid decode", [np.sin(np.arange(8.0))]

    def expected(prompt, ts, n):
        return jax_engine.generate(jproc([prompt], ts), jconfig.GenerationConfig(
            max_new_tokens=n, greedy=True)).token_ids[0]

    with make_engine(setup) as eng:
        eng.block_token_budget = 0
        r1 = eng.submit(_req(p1, t1, 30))
        wait_first_token(r1)
        r2 = eng.submit(_req(p2, t2, 6))
        wait([r1, r2])
        stats = eng.stats()
    assert r1.error is None and r2.error is None
    assert eng.mixed_rounds_run > 0 and stats["rounds_mixed"] >= 1
    assert "rounds_block" not in stats and "rounds_block_pre" not in stats
    assert r1.output_tokens == expected(p1, t1, 30)
    assert r2.output_tokens == expected(p2, t2, 6)


LONG = "analyze <ts><ts/> " + "tok " * 180
SHORT = "short <ts><ts/> prompt"


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_torch_chunked_admission_fragmented_slots_matches_monolithic(setup, cache):
    """Short requests hold slots while two long ones admit into the free
    ones: with ``prefill_chunk=64`` they take scan-sliced rounds, without it
    one block round; the long requests' tokens must be the same."""
    dtype = {"f32": torch.float32, "int8": torch.int8}[cache]

    def run(**kw):
        with make_engine(setup, cache_dtype=dtype, **kw) as eng:
            shorts = [eng.submit(_req(SHORT, [np.arange(8.0) * (i + 1)], 12))
                      for i in range(2)]
            deadline = time.time() + 60
            while not eng.live_host.any():
                assert time.time() < deadline
                time.sleep(0.002)
            longs = [_req(LONG, [np.arange(24.0) + i], 5) for i in range(2)]
            eng.waiting.requeue(longs)  # one wave
            eng._wake.set()
            wait(shorts + longs)
            stats = eng.stats()
        for r in shorts + longs:
            assert r.error is None, r.error
        return [r.output_tokens for r in longs], stats

    base, base_stats = run()
    got, stats = run(prefill_chunk=64)
    assert got == base and all(len(t) == 5 for t in got)
    assert stats["rounds_mixed"] >= 1 and "rounds_mixed" not in base_stats


def test_torch_decode_progresses_during_chunked_admission(setup):
    with make_engine(setup, prefill_chunk=32) as eng:
        short = eng.submit(_req("keep <ts><ts/> going", [np.arange(8.0)], 120))
        wait_first_token(short)
        n_before = len(short.output_tokens)
        long_req = eng.submit(_req("analyze <ts><ts/> " + "tok " * 200, [np.arange(24.0)], 4))
        deadline = time.time() + 60
        while long_req.first_token_s is None and long_req.error is None:
            assert time.time() < deadline
            time.sleep(0.002)
        n_during = len(short.output_tokens)
        wait([short, long_req])
        rounds = eng.round_snapshot()
    assert long_req.error is None and short.error is None
    assert n_during > n_before, "decode made no progress during the admission"
    assert len(long_req.output_tokens) == 4 and len(short.output_tokens) == 120
    mixed = [r for r in rounds if r["kind"] == "mixed"]
    assert len(mixed) >= 2 and any(r["emitted"] > 0 for r in mixed)


def test_torch_stop_during_chunked_admission_joins(setup):
    eng = make_engine(setup, prefill_chunk=32)
    eng.start()
    req = eng.submit(_req("analyze <ts><ts/> " + "tok " * 220, [np.arange(16.0)], 8))
    deadline = time.time() + 60
    while eng.mixed_rounds_run == 0:
        assert time.time() < deadline
        time.sleep(0.001)
    eng.stop()
    assert eng._thread is None
    assert req.error is None


@pytest.mark.parametrize("block_budget", [8192, 0], ids=["block", "scan-sliced"])
def test_torch_mixed_wave_rejects_over_long_alone(setup, block_budget):
    """A request over max_model_len in a wave admitted next to a live slot
    is rejected alone; the others in its wave are admitted and finish."""
    with make_engine(setup, max_model_len=128) as eng:
        eng.block_token_budget = block_budget
        runner = eng.submit(_req("runner <ts><ts/> decodes", [np.arange(12.0)], 40))
        wait_first_token(runner)
        good = _req("short one <ts><ts/>", [np.arange(8.0)], 4)
        bad = Request("x " * 100 + "<ts><ts/>", [np.arange(8.0)], SamplingParams(max_tokens=200))
        good2 = _req("short two <ts><ts/>", [np.sin(np.arange(8.0))], 4)
        eng.waiting.requeue([good, bad, good2])
        eng._wake.set()
        wait([runner, good, bad, good2])
        stats = eng.stats()
    assert bad.error is not None and "max_model_len" in bad.error
    for r in (runner, good, good2):
        assert r.error is None, r.error
    assert len(good.output_tokens) == 4 and len(good2.output_tokens) == 4
    kind = "rounds_block" if block_budget else "rounds_mixed"
    assert stats.get(kind, 0) >= 1, stats


def test_torch_mixed_plan_equals_jax(monkeypatch):
    """``_mixed_plan`` is the reference's, as a pure function of the
    admitted rows, the padded prompt length and the engine's sizes."""
    for max_batch_size in (4, 8, 24, 32):
        for decode_chunk in (4, 8, 32):
            for bucket in (4, 8):
                for mixed_npt in (16, 64):
                    monkeypatch.setattr(scheduler, "MIXED_NPT", mixed_npt)
                    eng = types.SimpleNamespace(
                        max_batch_size=max_batch_size, decode_chunk=decode_chunk,
                        mixed_npt=mixed_npt, _a_bucket=min(bucket, max_batch_size))
                    for n_reqs in range(1, eng._a_bucket + 1):
                        for t in (17, 128, 640, 2400, 3000, 6144):
                            assert (ServeEngine._mixed_plan(eng, n_reqs, t)
                                    == JaxServeEngine._mixed_plan(eng, n_reqs, t))


def test_torch_warmup_runs_a_mixed_round_under_small_cap(setup):
    """Warm-up's runner fits a small cap, and warm-up runs the mixed rounds
    next to it with the int8 cache: the block ones, as the reference's
    warm-up does (it counts them as mixed rounds), and no scan-sliced one."""
    with make_engine(setup, max_model_len=256, cache_dtype=torch.int8) as eng:
        eng.warmup(prefill_buckets=(64,), series_per_request=1, series_len=16)
        stats = eng.stats()
    assert eng.mixed_rounds_run > 0 and stats["rounds_block"] == eng.mixed_rounds_run
    assert "rounds_mixed" not in stats and eng.block_token_budget == 8192
    assert stats["active_slots"] == 0 and eng._pending_mixed is None
