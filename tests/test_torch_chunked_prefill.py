"""Chunked prefill: the decoder's ``kv_limit`` path and the batch engine's
``prefill_chunk``, held against the JAX package on the same weights.

- ``QwenModel.forward`` with a (B, T) ``write_pos`` and ``kv_limit`` against
  JAX ``qwen.forward``: hidden states and the written caches, chunk by chunk,
  with a chunk straddling a row's end; 1e-4 (rtol and atol) in f32 with the
  f32 cache, as ``test_torch_qwen.py``; with the int8 cache the codes must be
  equal but where an f32 rounding moves one across a step (at most one step,
  in few elements), the rest within ``DECODE_TOL`` 2e-3, as
  ``test_torch_int8_kv.py``.
- The port's chunked ``generate`` against JAX's chunked ``generate`` and
  against the monolithic one, greedy tokens exactly (f32); int8 chunked
  against int8 monolithic; a short prompt skips chunking.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu.core import config as jconfig
from chatts_tpu.models import chatts as jchatts
from chatts_tpu.models import qwen as jqwen
from chatts_tpu.processor import processor as jprocessor
from chatts_tpu.runtime import kv_cache as jkv
from chatts_tpu.runtime.engine import InferenceEngine as JaxEngine
from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.core.config import GenerationConfig
from chatts_tpu_torch.models.convert import qwen_from_jax
from chatts_tpu_torch.processor import processor as tprocessor
from chatts_tpu_torch.runtime import kv_cache as tkv
from chatts_tpu_torch.runtime.engine import InferenceEngine, default_cache_len
from tests.helpers import FakeTokenizer
from tests.test_torch_qwen import _randomize

TOL = 1e-4
DECODE_TOL = 2e-3


def _config(m=tconfig, qwen3=False):
    return m.tiny_config(vocab_size=512, hidden_size=128, intermediate_size=256,
                         num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                         patch_size=4, qwen3=qwen3)


def _assert_caches_close(tcaches, jcaches, int8: bool) -> None:
    for tlayer, jlayer in zip(tcaches, jcaches):
        for got, want in zip(tlayer, jlayer):
            got, want = got.numpy(), np.asarray(want)
            if got.dtype == np.int8:
                # One code step where an f32 rounding lands on the other side
                # of a half: few elements, never more than one step.
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            else:
                tol = DECODE_TOL if int8 else TOL
                np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("cache", ["f32", "int8", "qwen3-f32", "qwen3-int8"])
def test_torch_chunked_forward_matches_jax(cache):
    """Chunks of 8 over a 21-token block (two rows of 21 and 13 tokens, so
    the second chunk straddles row 1's end and the third row 0's), each
    written at absolute slots and attending the prefix [:kv_limit] of a
    32-slot cache (kv_limit 16, 16, 32): hidden states and every cache
    buffer after each chunk.  The Qwen3 decoder's norm weights are drawn
    around 1, so that neither q_norm nor k_norm is a no-op."""
    qwen3 = cache.startswith("qwen3-")
    cache = cache.removeprefix("qwen3-")
    cfg, jcfg = _config(qwen3=qwen3).llm, _config(jconfig, qwen3).llm
    params = jax.tree.map(np.asarray, jqwen.init_params(jcfg, jax.random.PRNGKey(3),
                                                        dtype=jnp.float32))
    if qwen3:
        params = _randomize(params, np.random.default_rng(3))
    model = qwen_from_jax(params, cfg)
    b, t, c, cap = 2, 21, 8, 32
    rng = np.random.default_rng(5)
    embeds = rng.normal(0, 1, (b, 24, cfg.hidden_size)).astype(np.float32)
    positions = np.tile(np.minimum(np.arange(24), t - 1).astype(np.int32)[None], (b, 1))
    seq_lens = np.asarray([t, 13], np.int32)
    kv_pos = np.tile(np.arange(cap, dtype=np.int32)[None], (b, 1))
    kv_valid = kv_pos < seq_lens[:, None]
    jdtype, tdtype = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[cache]
    jcaches = jkv.allocate(jcfg, b, cap, jdtype)
    tcaches = tkv.allocate(cfg, b, cap, tdtype)
    for o in range(0, 24, c):
        kv_limit = min(cap, -(-(o + c) // 16) * 16)
        chunk = np.s_[:, o:o + c]
        jh, jcaches = jqwen.forward(
            params, jcfg, jnp.asarray(embeds[chunk]), jnp.asarray(positions[chunk]),
            kv_caches=jcaches, write_pos=jnp.asarray(kv_pos[chunk]),
            kv_valid=jnp.asarray(kv_valid), kv_positions=jnp.asarray(kv_pos),
            kv_limit=kv_limit, attn_impl="xla")
        th, _ = model(
            torch.from_numpy(embeds[chunk]), torch.from_numpy(positions[chunk]),
            kv_caches=tcaches, write_pos=torch.from_numpy(kv_pos[chunk]),
            kv_valid=torch.from_numpy(kv_valid), kv_positions=torch.from_numpy(kv_pos),
            kv_limit=kv_limit)
        tol = DECODE_TOL if cache == "int8" else TOL
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=tol, atol=tol)
        _assert_caches_close(tcaches, jcaches, cache == "int8")


def test_torch_chunk_needs_its_masks():
    cfg = _config().llm
    params = jax.tree.map(np.asarray, jqwen.init_params(
        _config(jconfig).llm, jax.random.PRNGKey(0), dtype=jnp.float32))
    model = qwen_from_jax(params, cfg)
    x = torch.zeros((1, 4, cfg.hidden_size))
    pos = torch.arange(4, dtype=torch.int32)[None]
    caches = tkv.allocate(cfg, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="kv_valid and kv_positions"):
        model(x, pos, kv_caches=caches, write_pos=pos)
    with pytest.raises(ValueError, match="decode step of one token"):
        model(x, pos, kv_caches=caches, write_pos=pos, kv_lengths=torch.tensor([4]))


@pytest.fixture(scope="module")
def params():
    return jchatts.init_params(_config(jconfig), jax.random.PRNGKey(5), dtype=jnp.float32)


def _batch(m=tprocessor, cm=tconfig):
    """Two rows of very different lengths, so chunk boundaries straddle a
    row's end mid-chunk and padded tail chunks (as the JAX package's
    ``test_chunked_prefill_matches_monolithic``)."""
    long_text = " ".join(["point"] * 60)
    return m.ChatTSProcessor(FakeTokenizer(), _config(cm))(
        [f"analyze <ts><ts/> {long_text}", "short <ts><ts/> row"],
        [np.sin(np.arange(64.0)) * 4.0, np.arange(16.0)])


def _port(params, **kw):
    return InferenceEngine(jax.tree.map(np.asarray, params), _config(), device="cpu",
                           **kw)


GEN = dict(max_new_tokens=6, greedy=True)


def test_torch_chunked_generate_matches_jax(params):
    jax_batch, batch = _batch(jprocessor, jconfig), _batch()
    assert batch.input_ids.shape[1] > 32 and len(set(batch.seq_lens.tolist())) == 2
    jgen = jconfig.GenerationConfig(**GEN)
    mono = JaxEngine(params, _config(jconfig), cache_dtype=jnp.float32, attn_impl="xla",
                     decode_recent_kv=False).generate(jax_batch, jgen).token_ids
    for chunk in (16, 32):
        want = JaxEngine(params, _config(jconfig), cache_dtype=jnp.float32, attn_impl="xla",
                         decode_recent_kv=False, prefill_chunk=chunk).generate(
                             jax_batch, jgen).token_ids
        got = _port(params, cache_dtype=torch.float32, prefill_chunk=chunk).generate(
            batch, GenerationConfig(**GEN)).token_ids
        assert got == want == mono, chunk


def test_torch_chunked_generate_int8_matches_monolithic(params):
    batch, gen = _batch(), GenerationConfig(**GEN)
    mono = _port(params, cache_dtype=torch.int8).generate(batch, gen)
    chunked = _port(params, cache_dtype=torch.int8, prefill_chunk=16).generate(batch, gen)
    assert chunked.token_ids == mono.token_ids
    assert [len(t) for t in chunked.token_ids] == [6, 6]


def test_torch_short_prompt_skips_chunking(params, monkeypatch):
    eng = _port(params, cache_dtype=torch.float32, prefill_chunk=4096)
    monkeypatch.setattr(eng, "_chunked_prefill", None)  # would fail if called
    batch = tprocessor.ChatTSProcessor(FakeTokenizer(), _config())(
        ["tiny <ts><ts/>"], [np.arange(8.0)])
    r = eng.generate(batch, GenerationConfig(max_new_tokens=4, greedy=True))
    assert all(len(t) == 4 for t in r.token_ids)


class _Capacity(Exception):
    """Carries the cache length JAX's ``generate`` allocates."""


def _jax_cache_len(t: int, max_new_tokens: int, prefill_chunk) -> int:
    """The capacity JAX's ``generate`` passes to its (chunked or monolithic)
    prefill for a (1, t) batch, read where the prefill is called, before
    anything is traced."""
    def capture(*args, **kw):
        raise _Capacity(args[2])

    eng = types.SimpleNamespace(
        prefill_chunk=prefill_chunk, _chunked_prefill=capture, _prefill_jit=capture,
        params=None, cfg=None, cache_dtype=None, attn_impl=None,
        prefill_act_int8=False, mesh=None)
    zeros = np.zeros((1, t), np.int32)
    batch = types.SimpleNamespace(
        input_ids=zeros, positions=zeros, seq_lens=np.array([t], np.int32),
        ts_values=np.zeros((1, 1, 1), np.float32), ts_mask=np.zeros((1, 1, 1), np.float32),
        scatter_seq=zeros, scatter_tok=zeros)
    with pytest.raises(_Capacity) as got:
        JaxEngine.generate(eng, batch, jconfig.GenerationConfig(max_new_tokens=max_new_tokens))
    return got.value.args[0]


def test_torch_chunked_cache_len_rule_matches_jax():
    """The capacity of a chunked and of a monolithic ``generate`` equals the
    one JAX's ``generate`` allocates for the same prompt length, new tokens
    and chunk; a cache below the padded prompt is refused."""
    for chunk in (None, 16, 512, 1024, 2048):
        for t in (17, 400, 1280, 3000, 5000):
            for max_new in (1, 64, 300):
                assert (default_cache_len(t, max_new, chunk)
                        == _jax_cache_len(t, max_new, chunk)), (t, max_new, chunk)
    eng = _port(jchatts.init_params(_config(jconfig), jax.random.PRNGKey(0),
                                    dtype=jnp.float32), prefill_chunk=16)
    batch = _batch()
    t = batch.input_ids.shape[1]
    with pytest.raises(ValueError, match="positions this batch needs"):
        eng.generate(batch, GenerationConfig(max_new_tokens=2, greedy=True),
                     cache_len=-(-t // 16) * 16 - 1)
