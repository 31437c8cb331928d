"""The slice end to end: the port's ``InferenceEngine.generate`` against the
JAX engine on a tiny f32 ChatTS, plus sampling and the KV cache.

Greedy tokens must match exactly (f32 on both sides; the JAX engine runs its
per-step scatter decode, ``decode_recent_kv=False``, with XLA attention).
Sampled tokens cannot match the JAX engine, whose random bits differ, so
they are checked for determinism under a seed; top-k and top-p masks match
exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu.core import config as jconfig
from chatts_tpu.models import chatts as jchatts
from chatts_tpu.models import quantize as jquant
from chatts_tpu.processor import processor as jprocessor
from chatts_tpu.runtime import kv_cache as jkv
from chatts_tpu.runtime import sampling as jsampling
from chatts_tpu.runtime.engine import InferenceEngine as JaxEngine
from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.core.config import GenerationConfig
from chatts_tpu_torch.processor import processor as tprocessor
from chatts_tpu_torch.runtime import kv_cache as tkv
from chatts_tpu_torch.runtime import sampling as tsampling
from chatts_tpu_torch.runtime.engine import InferenceEngine, default_cache_len
from tests.helpers import FakeTokenizer


def _config(m=tconfig):
    """The tiny config from module ``m``: the port's, or the JAX package's
    for the JAX side.  Every projection of the fused model tiles for int4
    (multiples of 128)."""
    return m.tiny_config(vocab_size=512, hidden_size=128, intermediate_size=256,
                       num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                       patch_size=4)


def _params(int4, seed=0):
    cfg = _config(jconfig)
    params = jchatts.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    if int4:
        params = jquant.quantize_params(jchatts.maybe_fuse(params), bits=4)
        assert all("kernel_q4" in sub for layer in params["llm"]["layers"]
                   for group in (layer["self_attn"], layer["mlp"])
                   for sub in group.values() if isinstance(sub, dict))
    return params


def _batch(m=tprocessor, cm=tconfig):
    """The same prompts through the processor of ``m`` (with config module
    ``cm``)."""
    return m.ChatTSProcessor(FakeTokenizer(), _config(cm))(
        ["analyze <ts><ts/> please", "and <ts><ts/> this <ts><ts/> too long prompt"],
        [np.arange(16.0), np.sin(np.arange(32)) * 10, np.arange(8.0)])


def _port(params, **kw):
    return InferenceEngine(jax.tree.map(np.asarray, params), _config(), device="cpu",
                           cache_dtype=torch.float32, **kw)


def _engines(params, chunk=4):
    jax_engine = JaxEngine(params, _config(jconfig), cache_dtype=jnp.float32, attn_impl="xla",
                           decode_recent_kv=False, decode_chunk=chunk)
    return jax_engine, _port(params, decode_chunk=chunk)


def _generate_both(jax_engine, port, **gen):
    """Each engine's tokens for the same prompts and generation settings,
    each side built from its own package."""
    want = jax_engine.generate(_batch(jprocessor, jconfig), jconfig.GenerationConfig(**gen))
    return want, port.generate(_batch(), GenerationConfig(**gen))


@pytest.mark.parametrize("int4", [False, True], ids=["float", "int4"])
def test_torch_greedy_generate_matches_jax(int4):
    jax_engine, port = _engines(_params(int4))
    assert len(set(_batch().seq_lens.tolist())) == 2
    want, got = _generate_both(jax_engine, port, max_new_tokens=10, greedy=True)
    assert got.token_ids == want.token_ids
    assert all(len(t) == 10 for t in got.token_ids)
    assert got.prompt_lens == want.prompt_lens
    assert got.ttft_s > 0 and got.total_s >= got.ttft_s and got.total_new_tokens == 20


def test_torch_generate_stops_at_eos_like_jax():
    jax_engine, port = _engines(_params(int4=False, seed=3))
    free = port.generate(_batch(), GenerationConfig(max_new_tokens=8, greedy=True)).token_ids
    # Row 0's first token and row 1's fourth token become EOS: row 0 comes
    # out empty, row 1 stops before its fourth token.
    eos = (free[0][0], free[1][3])
    want, got = _generate_both(jax_engine, port, max_new_tokens=8, greedy=True,
                               eos_token_ids=eos)
    got = got.token_ids
    assert got == want.token_ids
    assert got[0] == []
    cut = next(i for i, tok in enumerate(free[1]) if tok in eos)
    assert got[1] == free[1][:cut]


def test_torch_sampled_generate_is_deterministic_under_a_seed():
    cfg = _config()
    port = _port(_params(int4=False, seed=4), decode_chunk=3)
    batch = _batch()
    gen = GenerationConfig(max_new_tokens=7, temperature=0.7, top_p=0.9, top_k=10)

    def run(seed):
        return port.generate(batch, gen, generator=torch.Generator().manual_seed(seed)).token_ids

    first = run(7)
    assert run(7) == first
    assert all(len(t) == 7 and all(0 <= tok < cfg.llm.vocab_size for tok in t) for t in first)
    assert any(run(seed) != first for seed in (8, 9, 10))


def test_torch_top_k_top_p_match_jax():
    logits = np.random.default_rng(0).normal(0, 2, (3, 97)).astype(np.float32)
    for k in (1, 5, 97):
        np.testing.assert_array_equal(
            tsampling.apply_top_k(torch.from_numpy(logits), k).numpy(),
            np.asarray(jsampling.apply_top_k(jnp.asarray(logits), k)))
    for p in (0.05, 0.5, 0.9, 1.0):
        np.testing.assert_array_equal(
            tsampling.apply_top_p(torch.from_numpy(logits), p).numpy(),
            np.asarray(jsampling.apply_top_p(jnp.asarray(logits), p)))
    greedy = tsampling.sample(torch.from_numpy(logits), torch.Generator(),
                              GenerationConfig(greedy=True))
    assert greedy.dtype == torch.int32
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


def test_torch_sample_follows_the_distribution():
    """Gumbel-max draws land on each token about as often as its probability."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.2, 1e-9]]).repeat(4000, 1))
    draws = tsampling.sample(logits, torch.Generator().manual_seed(0),
                             GenerationConfig(temperature=1.0))
    freq = torch.bincount(draws.long(), minlength=4).float() / len(draws)
    np.testing.assert_allclose(freq.numpy(), [0.5, 0.3, 0.2, 0.0], atol=0.03)


def test_torch_kv_cache_and_capacity_rule():
    lcfg = _config().llm
    caches = tkv.allocate(lcfg, 3, 256, torch.bfloat16)
    jlcfg = _config(jconfig).llm
    assert len(caches) == lcfg.num_hidden_layers
    assert caches[0][0].shape == (3, lcfg.num_key_value_heads, 256, lcfg.head_dim)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        assert tkv.cache_bytes(lcfg, 3, 256, dtype) == jkv.cache_bytes(jlcfg, 3, 256, jdtype)
    # int8 is the serving cache: per layer codes and scales.
    assert len(tkv.allocate(lcfg, 1, 256, torch.int8)[0]) == 4
    with pytest.raises(NotImplementedError):
        tkv.allocate(lcfg, 1, 256, torch.float16)
    # The JAX engine's rule: prompt + new tokens, rounded up to 256.
    assert default_cache_len(300, 64) == 512
    assert default_cache_len(192, 64) == 256
    assert default_cache_len(1280, 64) == 1536


def test_torch_generate_refuses_a_cache_too_small():
    port = _port(_params(int4=False))
    batch = _batch()
    gen = GenerationConfig(max_new_tokens=4, greedy=True)
    # Prefill writes the whole padded block; decode writes up to seq_len + 2.
    need = max(batch.input_ids.shape[1], int(batch.seq_lens.max()) + 3)
    with pytest.raises(ValueError, match="cache_len"):
        port.generate(batch, gen, cache_len=need - 1)
    assert all(len(t) == 4 for t in port.generate(batch, gen, cache_len=need).token_ids)
