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
outputs compare at 2e-3 (DECODE_TOL).

In bf16 (weights and activations) every building block of the decoder gives
the JAX package's bits on the same inputs but one: ``jax.nn.silu`` in bf16,
which XLA expands into bf16 steps and which misses the correctly rounded
value in about 40% of elements by one bf16 ulp, where the port's is the
correctly rounded one (``test_torch_bf16_blocks_match_jax_but_for_silu``
pins both statements).  So a bf16 forward agrees only to a few bf16 ulps of
its largest value: hidden states and logits compare at 2**-6 of the largest
reference value (BF16_TOL_OF_MAX), layer 0's codes and scales are exact (its
inputs are equal), and a later layer's codes may differ by two steps at up
to 15% of positions, its scales by 2%."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu.core import config as jconfig
from chatts_tpu.models import qwen as jqwen
from chatts_tpu.ops import ragged_decode_attention as jrda
from chatts_tpu.processor import processor as jprocessor
from chatts_tpu.runtime.engine import InferenceEngine as JaxEngine
from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.models import qwen as tqwen
from chatts_tpu_torch.models.convert import from_jax_params, qwen_from_jax, to_tensor
from chatts_tpu_torch.models.qwen import quantize_kv
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.ops import ragged_decode_attention as trda
from chatts_tpu_torch.runtime import kv_cache as tkv
from chatts_tpu_torch.runtime.engine import InferenceEngine
from tests.test_torch_engine import _config as _engine_config
from chatts_tpu_torch.serve.scheduler import Request, SamplingParams, ServeEngine
from tests.helpers import FakeTokenizer
from tests.test_torch_engine import _generate_both, _params
from tests.test_torch_qwen import _randomize

TOL = 1e-4
DECODE_TOL = 2e-3
BF16_TOL_OF_MAX = 2.0 ** -6


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


def _split_inputs(g, chunk, s, seed=4):
    """Rows of length 0, 1, on and beside the boundaries of ``chunk`` and the
    whole capacity, ``g`` heads a kv head."""
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, 2 * chunk, s - 1, s]
    rng = np.random.default_rng(seed + g)
    b, kvh, d = len(lengths), 2, 128
    q = rng.normal(0, 1, (b, kvh * g, d)).astype(np.float32)
    k = rng.integers(-128, 128, (b, kvh, s, d)).astype(np.int8)
    v = rng.integers(-128, 128, (b, kvh, s, d)).astype(np.int8)
    ks = (rng.random((b, kvh, s)) + 0.5).astype(np.float32) / 127
    vs = (rng.random((b, kvh, s)) + 0.5).astype(np.float32) / 127
    return q, k, v, ks, vs, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("g", [5, 7])
@pytest.mark.parametrize("chunk", [128, 256, 640], ids=["128", "256", "one-split"])
def test_torch_ragged_int8_split_reference_matches_dense(g, chunk):
    """The split kernel's arithmetic (parts by chunk, merged by logsumexp)
    against the dense int8 plain version, in f32 at 1e-4: only the order of
    the sums and the place of the normalisation differ.  The cache past each
    length holds NaN scales, which no part may read."""
    s = 640
    args = [torch.from_numpy(a) for a in _split_inputs(g, chunk, s)]
    q, k, v, ks, vs, lens = args
    want = trda.ragged_decode_attention_int8_reference(*args)
    past = torch.arange(s)[None, None, :] >= lens[:, None, None]
    got = trda.ragged_decode_attention_int8_split_reference(
        q, k, v, torch.where(past, float("nan"), ks), torch.where(past, float("nan"), vs),
        lens, chunk=chunk)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    assert (got[0] == 0).all()  # a row of length 0 has no part and gives 0
    # Without scales it is the bf16 kernel's split arithmetic on the
    # dequantized cache.
    deq = trda.ragged_decode_attention_split_reference(
        q, k.float() * ks[..., None], v.float() * vs[..., None], lens, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), deq.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("lengths", [[1, 300], [0, 512], [128, 129]],
                         ids=["1-300", "0-512", "128-129"])
def test_torch_ragged_int8_split_reference_matches_pallas(lengths):
    """The split arithmetic at the plan's chunk (128 keys at this shape)
    against the JAX kernel in interpret mode, same numpy inputs, f32 at 1e-4
    (another order of the sums; JAX dequantizes nothing either)."""
    args = _int8_inputs(lengths)
    want = np.asarray(jrda.ragged_decode_attention_int8(
        *(jnp.asarray(a) for a in args), interpret=True))
    targs = [torch.from_numpy(a) for a in args]
    assert trda.split_plan(512, len(lengths), 2) == (4, 128)
    got = trda.ragged_decode_attention_int8_split_reference(*targs)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    got256 = trda.ragged_decode_attention_int8_split_reference(*targs, chunk=256)
    np.testing.assert_allclose(got256.numpy(), want, rtol=TOL, atol=TOL)


def test_torch_ragged_int8_on_plan_is_for_the_card():
    args = [torch.from_numpy(a) for a in _int8_inputs([3, 4])]
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        trda.ragged_decode_attention_int8_on_plan(*args, (4, 128))


def _config(m=tconfig, qwen3=False):
    """The tiny config from module ``m``: the port's, or the JAX package's
    for the JAX side."""
    return m.tiny_config(vocab_size=512, hidden_size=128, intermediate_size=256,
                       num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                       qwen3=qwen3)


@pytest.mark.parametrize("qwen3", [False, True], ids=["qwen2", "qwen3"])
def test_torch_int8_cache_prefill_then_decode_matches_jax(qwen3):
    """Prefill writes codes and scales but attends the unquantized block;
    three decode steps write at cur_len and attend the quantized cache.
    Qwen3's q_norm and k_norm weights are drawn around 1, so that neither
    is a no-op."""
    lcfg, jlcfg = _config(qwen3=qwen3).llm, _config(jconfig, qwen3).llm
    params = jax.tree.map(np.asarray, jqwen.init_params(jlcfg, jax.random.PRNGKey(2),
                                                        dtype=jnp.float32))
    if qwen3:
        params = _randomize(params, np.random.default_rng(2))
    params = jax.tree.map(np.asarray, jqwen.fuse_projections(params))
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


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.normal(0, scale, shape).astype(np.float32), jnp.bfloat16)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_torch_bf16_blocks_match_jax_but_for_silu():
    """bf16 weights and activations, block by block on the same inputs: the
    norm, the attention block, the residual add and the projections give the
    JAX package's bits; ``silu(gate) * up`` does not, because XLA's bf16
    ``silu`` misses the correctly rounded value where the port's does not.
    Given JAX's own activation product, the port's down projection gives
    JAX's MLP output to the bit."""
    import torch.nn.functional as F

    lcfg, jlcfg = _config().llm, _config(jconfig).llm
    params = jqwen.fuse_projections(
        jqwen.init_params(jlcfg, jax.random.PRNGKey(2), dtype=jnp.bfloat16))
    model = qwen_from_jax(jax.tree.map(np.asarray, params), lcfg)
    lp, tl = params["layers"][0], model.layers[0]
    rng = np.random.default_rng(6)
    b, t = 2, 12
    x = _bf16(rng, (b, t, lcfg.hidden_size))
    tx = to_tensor(np.asarray(x))
    np.testing.assert_array_equal(
        tqwen.rms_norm(tx, tl.input_layernorm, lcfg.rms_norm_eps).float().numpy(),
        _f32(jqwen.rms_norm(x, lp["input_layernorm"], jlcfg.rms_norm_eps)))
    positions = np.tile(np.arange(t, dtype=np.int32)[None], (b, 1))
    valid = positions < np.asarray([t, t - 5])[:, None]
    want, _ = jqwen.attention_block(lp["self_attn"], x, jnp.asarray(positions), jlcfg, None,
                                    None, jnp.asarray(valid), jnp.asarray(positions), "xla")
    rope = tqwen.rope_cos_sin(torch.from_numpy(positions), lcfg.head_dim, lcfg.rope_theta)
    got, _ = tl.self_attn(tx, torch.from_numpy(positions), rope, None, None,
                          torch.from_numpy(valid), torch.from_numpy(positions), None)
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))
    np.testing.assert_array_equal((tx + got).float().numpy(), _f32(x + want))

    gate_up = jqwen._dense(x, lp["mlp"]["gate_up_proj"])
    got_gate_up = tl.mlp.gate_up_proj(tx)
    # The same f32 products summed in another order, rounded to bf16 once.
    np.testing.assert_allclose(got_gate_up.float().numpy(), _f32(gate_up), rtol=2.0 ** -7,
                               atol=1e-6)
    gate, up = jnp.split(gate_up, 2, axis=-1)
    tgate, tup = to_tensor(np.asarray(gate)), to_tensor(np.asarray(up))
    exact = tgate.double() / (1 + torch.exp(-tgate.double()))
    assert torch.equal(F.silu(tgate), exact.to(torch.bfloat16))
    jax_silu = torch.from_numpy(_f32(jax.nn.silu(gate)))
    assert (jax_silu != exact.to(torch.bfloat16).float()).float().mean() > 0.1
    act = jax.nn.silu(gate) * up
    np.testing.assert_array_equal(
        tl.mlp.down_proj(to_tensor(np.asarray(act))).float().numpy(),
        _f32(jqwen.mlp_block(lp["mlp"], x)))


def test_torch_int8_cache_prefill_then_decode_matches_jax_bf16(monkeypatch):
    """The int8-cache prefill and three decode steps with bf16 weights and
    activations.  The JAX decode steps run the Pallas int8 kernel in
    interpret mode (capacity 256, its block), as on the TPU; its dense
    fallback would round the dequantized cache to bf16."""
    monkeypatch.setenv("CHATTS_RAGGED_INTERPRET", "1")
    lcfg, jlcfg = _config().llm, _config(jconfig).llm
    params = jqwen.fuse_projections(
        jqwen.init_params(jlcfg, jax.random.PRNGKey(2), dtype=jnp.bfloat16))
    rng = np.random.default_rng(3)
    b, t, cap = 2, 12, 256
    embeds = _bf16(rng, (b, t, lcfg.hidden_size))
    positions = np.tile(np.arange(t, dtype=np.int32)[None], (b, 1))
    seq_lens = np.asarray([t, t - 5])
    kv_pos = np.tile(np.arange(cap, dtype=np.int32)[None], (b, 1))
    kvh, d = lcfg.num_key_value_heads, lcfg.head_dim

    def close(got, want):
        want = _f32(want)
        assert got.dtype == (torch.bfloat16 if want.ndim == 3 and want.shape[-1]
                             == lcfg.hidden_size else torch.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=BF16_TOL_OF_MAX * np.abs(want).max())

    jcaches = [(jnp.zeros((b, kvh, cap, d), jnp.int8), jnp.zeros((b, kvh, cap, d), jnp.int8),
                jnp.ones((b, kvh, cap)), jnp.ones((b, kvh, cap)))
               for _ in range(lcfg.num_hidden_layers)]
    jh, jcaches = jqwen.forward(
        params, jlcfg, embeds, jnp.asarray(positions), kv_caches=jcaches,
        kv_valid=jnp.asarray(kv_pos < seq_lens[:, None]), kv_positions=jnp.asarray(kv_pos),
        attn_impl="xla")
    model = qwen_from_jax(jax.tree.map(np.asarray, params), lcfg)
    tcaches = tkv.allocate(lcfg, b, cap, torch.int8)
    th, tcaches = model(
        to_tensor(np.asarray(embeds)), torch.from_numpy(positions), kv_caches=tcaches,
        kv_valid=torch.from_numpy(kv_pos < seq_lens[:, None]),
        kv_positions=torch.from_numpy(kv_pos))
    close(th, jh)

    spy = []
    real = jrda.ragged_decode_attention_int8
    monkeypatch.setattr(jrda, "ragged_decode_attention_int8",
                        lambda *a, **kw: (spy.append(1), real(*a, **kw))[1])
    cur = seq_lens.astype(np.int32)
    for _ in range(3):
        step = _bf16(rng, (b, 1, lcfg.hidden_size))
        pos = cur[:, None]
        jh, jcaches = jqwen.forward(
            params, jlcfg, step, jnp.asarray(pos), kv_caches=jcaches,
            write_pos=jnp.asarray(pos), kv_valid=jnp.asarray(kv_pos <= cur[:, None]),
            kv_positions=jnp.asarray(kv_pos), kv_lengths=jnp.asarray(cur + 1),
            attn_impl="ragged")
        th, tcaches = model(
            to_tensor(np.asarray(step)), torch.from_numpy(pos), kv_caches=tcaches,
            write_pos=torch.from_numpy(pos), kv_lengths=torch.from_numpy(cur + 1))
        close(th, jh)
        close(model.compute_logits(th), jqwen.compute_logits(params, jlcfg, jh))
        cur = cur + 1
    # Every JAX decode step went through the Pallas kernel, once a layer.
    assert len(spy) == 3 * lcfg.num_hidden_layers
    for layer, (jl, tl) in enumerate(zip(jcaches, tcaches)):
        assert len(tl) == 4
        for jbuf, tbuf in zip(jl[:2], tl[:2]):
            diff = np.abs(tbuf.numpy().astype(np.int32) - np.asarray(jbuf).astype(np.int32))
            if layer == 0:
                assert diff.max() == 0
            else:
                assert diff.max() <= 2 and (diff > 0).mean() <= 0.15
        for jbuf, tbuf in zip(jl[2:], tl[2:]):
            if layer == 0:
                np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
            else:
                np.testing.assert_allclose(tbuf.numpy(), np.asarray(jbuf), rtol=2e-2)


SERVE_TINY = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, patch_size=4,
                  max_sequence_length=64, ts_token_start_index=240)
SERVE_PROMPTS = [
    ("check <ts><ts/> parity", [np.arange(12.0)]),
    ("and <ts><ts/> another longer prompt to read", [np.sin(np.arange(20.0)) * 3]),
]


def test_torch_serve_int8_kv_bf16_greedy_matches_jax_engine():
    """The serving engine with bf16 weights and activations and the int8
    cache against the JAX batch engine, the same numpy weights through
    ``from_jax_params``: greedy tokens equal.  In bf16 a greedy step whose
    top two logits lie within a few bf16 ulps could flip without any fault
    (the blocks differ by ``silu``'s rounding, see above); the weights' seed
    is one where no step of these prompts is that close, and the test holds
    the tokens exactly."""
    from chatts_tpu.models import chatts

    jcfg, cfg = jconfig.tiny_config(**SERVE_TINY), tconfig.tiny_config(**SERVE_TINY)
    params = chatts.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    jproc = jprocessor.ChatTSProcessor(FakeTokenizer(vocab_limit=200), jcfg)
    jax_engine = JaxEngine(params, jcfg, cache_dtype=jnp.int8, attn_impl="xla",
                           decode_recent_kv=False, decode_chunk=4)
    want = [jax_engine.generate(jproc([p], ts),
                                jconfig.GenerationConfig(max_new_tokens=7, greedy=True))
            .token_ids[0] for p, ts in SERVE_PROMPTS]
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg)
    assert model.llm.embed_tokens.dtype == torch.bfloat16
    proc = ChatTSProcessor(FakeTokenizer(vocab_limit=200), cfg)
    with ServeEngine(model, cfg, proc, device="cpu", max_batch_size=4, max_model_len=512,
                     cache_dtype=torch.int8, decode_chunk=4) as eng:
        reqs = [Request(p, ts, SamplingParams(max_tokens=7, temperature=0.0))
                for p, ts in SERVE_PROMPTS]
        for r in reqs:
            eng.submit(r)
        deadline = time.time() + 60
        while any(r.finished_s is None and r.error is None for r in reqs):
            assert time.time() < deadline, "requests did not finish"
            time.sleep(0.002)
    assert all(r.error is None for r in reqs)
    assert [r.output_tokens for r in reqs] == want


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
