"""The int8 KV cache: quantization, the plain version of the int8 decode
kernel (B4), and the decoder's int8 cache paths, against the JAX package on
the same numpy inputs.

Tolerances: quantization is exact (the same f32 arithmetic and
round-half-to-even on both sides).  Attention and the decoder compare in f32
at 1e-4 (rtol and atol): the port multiplies the scales into the scores and
probabilities where the JAX path dequantizes first, and sums run in another
order.  Cache codes written from f32 activations that differ in the last
bits may round the other way at a .5 boundary, so codes may differ by one
step, at no more than 0.1% of positions; such a flip moves a key or value by
one quantization step (1/127 of its row's largest value), so decode-step
outputs compare at 2e-3 (DECODE_TOL)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu.core import config as jconfig
from chatts_tpu.models import qwen as jqwen
from chatts_tpu.ops import ragged_decode_attention as jrda
from chatts_tpu.runtime.engine import InferenceEngine as JaxEngine
from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.models.convert import qwen_from_jax
from chatts_tpu_torch.models.qwen import quantize_kv
from chatts_tpu_torch.ops import ragged_decode_attention as trda
from chatts_tpu_torch.runtime import kv_cache as tkv
from chatts_tpu_torch.runtime.engine import InferenceEngine
from tests.test_torch_engine import _config as _engine_config
from tests.test_torch_engine import _generate_both, _params

TOL = 1e-4
DECODE_TOL = 2e-3


def test_torch_quantize_kv_matches_jax_exactly():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 3, 5, 16)).astype(np.float32)
    # Row [0, 0, 0] has amax 127, so its scale is exactly 1 and each value
    # sits on a .5 boundary: round half to even decides every code.
    x[0, 0, 0] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 3.5, -3.5, 4.5, 0, -126.5,
                  -127, 5.5, 6.5]
    x[1, 2, 4] = 0.0  # all-zero row: the scale floors at 1e-8
    want_q, want_s = jqwen._quantize_kv(jnp.asarray(x))
    got_q, got_s = quantize_kv(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q[0, 0, 0, 1:4].tolist() == [0, 2, 2]
    assert got_s[1, 2, 4] == np.float32(1e-8)


def _int8_inputs(lengths, s=512, seed=1):
    rng = np.random.default_rng(seed)
    b, kvh, g, d = len(lengths), 2, 2, 128
    q = rng.normal(0, 1, (b, kvh * g, d)).astype(np.float32)
    k = rng.integers(-127, 128, (b, kvh, s, d)).astype(np.int8)
    v = rng.integers(-127, 128, (b, kvh, s, d)).astype(np.int8)
    ks = (rng.random((b, kvh, s)) + 0.5).astype(np.float32) / 127
    vs = (rng.random((b, kvh, s)) + 0.5).astype(np.float32) / 127
    return q, k, v, ks, vs, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("lengths", [[1, 300], [0, 512]], ids=["1-300", "0-512"])
def test_torch_ragged_int8_reference_matches_pallas(lengths):
    args = _int8_inputs(lengths)
    want = np.asarray(jrda.ragged_decode_attention_int8(
        *(jnp.asarray(a) for a in args), interpret=True))
    got = trda.ragged_decode_attention_int8_reference(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # Against dequantize-then-attend, through the bf16 kernel's plain version.
    q, k, v, ks, vs, lens = (torch.from_numpy(a) for a in args)
    deq = trda.ragged_decode_attention_reference(
        q, k.float() * ks[..., None], v.float() * vs[..., None], lens)
    np.testing.assert_allclose(got.numpy(), deq.numpy(), rtol=TOL, atol=TOL)
    # The wrapper takes the plain version for CPU tensors.
    np.testing.assert_array_equal(
        trda.ragged_decode_attention_int8(q, k, v, ks, vs, lens).numpy(), got.numpy())
    for row, n in enumerate(lengths):
        if n == 0:
            assert (got[row] == 0).all()


def _config(m=tconfig):
    """The tiny config from module ``m``: the port's, or the JAX package's
    for the JAX side."""
    return m.tiny_config(vocab_size=512, hidden_size=128, intermediate_size=256,
                       num_attention_heads=4, num_key_value_heads=2, head_dim=64)


def test_torch_int8_cache_prefill_then_decode_matches_jax():
    """Prefill writes codes and scales but attends the unquantized block;
    three decode steps write at cur_len and attend the quantized cache."""
    lcfg, jlcfg = _config().llm, _config(jconfig).llm
    params = jax.tree.map(np.asarray, jqwen.fuse_projections(
        jqwen.init_params(jlcfg, jax.random.PRNGKey(2), dtype=jnp.float32)))
    rng = np.random.default_rng(3)
    b, t, cap = 2, 12, 32
    embeds = rng.normal(0, 1, (b, t, lcfg.hidden_size)).astype(np.float32)
    positions = np.tile(np.arange(t, dtype=np.int32)[None], (b, 1))
    seq_lens = np.asarray([t, t - 5])
    kv_pos = np.tile(np.arange(cap, dtype=np.int32)[None], (b, 1))
    kvh, d = lcfg.num_key_value_heads, lcfg.head_dim

    jcaches = [(jnp.zeros((b, kvh, cap, d), jnp.int8), jnp.zeros((b, kvh, cap, d), jnp.int8),
                jnp.ones((b, kvh, cap)), jnp.ones((b, kvh, cap)))
               for _ in range(lcfg.num_hidden_layers)]
    jh, jcaches = jqwen.forward(
        params, jlcfg, jnp.asarray(embeds), jnp.asarray(positions), kv_caches=jcaches,
        kv_valid=jnp.asarray(kv_pos < seq_lens[:, None]), kv_positions=jnp.asarray(kv_pos),
        attn_impl="xla")
    model = qwen_from_jax(params, lcfg)
    tcaches = tkv.allocate(lcfg, b, cap, torch.int8)
    th, tcaches = model(
        torch.from_numpy(embeds), torch.from_numpy(positions), kv_caches=tcaches,
        kv_valid=torch.from_numpy(kv_pos < seq_lens[:, None]),
        kv_positions=torch.from_numpy(kv_pos))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=TOL, atol=TOL)

    cur = seq_lens.astype(np.int32)
    for _ in range(3):
        step = rng.normal(0, 1, (b, 1, lcfg.hidden_size)).astype(np.float32)
        pos = cur[:, None]
        jh, jcaches = jqwen.forward(
            params, jlcfg, jnp.asarray(step), jnp.asarray(pos), kv_caches=jcaches,
            write_pos=jnp.asarray(pos), kv_valid=jnp.asarray(kv_pos <= cur[:, None]),
            kv_positions=jnp.asarray(kv_pos), kv_lengths=jnp.asarray(cur + 1),
            attn_impl="xla")
        th, tcaches = model(
            torch.from_numpy(step), torch.from_numpy(pos), kv_caches=tcaches,
            write_pos=torch.from_numpy(pos), kv_lengths=torch.from_numpy(cur + 1))
        logits = model.compute_logits(th)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=TOL, atol=DECODE_TOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(
            jqwen.compute_logits(params, jlcfg, jh)), rtol=TOL, atol=DECODE_TOL)
        cur = cur + 1
    for jl, tl in zip(jcaches, tcaches):
        assert len(tl) == 4
        for jbuf, tbuf in zip(jl[:2], tl[:2]):
            diff = np.abs(tbuf.numpy().astype(np.int32) - np.asarray(jbuf).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        for jbuf, tbuf in zip(jl[2:], tl[2:]):
            # Decode-step scales come from activations that agree to DECODE_TOL.
            np.testing.assert_allclose(tbuf.numpy(), np.asarray(jbuf), rtol=DECODE_TOL)


def test_torch_int8_batch_engine_greedy_matches_jax():
    params = _params(int4=False, seed=5)
    jax_engine = JaxEngine(params, _engine_config(jconfig), cache_dtype=jnp.int8,
                           attn_impl="xla", decode_recent_kv=False, decode_chunk=4)
    port = InferenceEngine(jax.tree.map(np.asarray, params), _engine_config(), device="cpu",
                           cache_dtype=torch.int8, decode_chunk=4)
    want, got = _generate_both(jax_engine, port, max_new_tokens=8, greedy=True)
    assert got.token_ids == want.token_ids


def test_torch_int8_cache_layout_and_bytes():
    lcfg = _config().llm
    caches = tkv.allocate(lcfg, 3, 64, torch.int8)
    k, v, ks, vs = caches[0]
    shape = (3, lcfg.num_key_value_heads, 64, lcfg.head_dim)
    assert k.shape == v.shape == shape and k.dtype == v.dtype == torch.int8
    assert ks.shape == vs.shape == shape[:3] and ks.dtype == torch.float32
    assert (ks == 1).all() and (vs == 1).all()
    assert tkv.cache_bytes(lcfg, 3, 64, torch.int8) == sum(
        buf.numel() * buf.element_size() for layer in caches for buf in layer)
