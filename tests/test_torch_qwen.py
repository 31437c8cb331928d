"""Decoder and ChatTS model: the port against JAX ``qwen.forward`` /
``compute_logits`` and ``chatts.input_embeddings`` on the same weights.

Tolerance 1e-4 (rtol and atol) in f32: two layers of f32 matmuls, norms and
softmax whose sums run in a different order in the two frameworks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu.core import config as jconfig
from chatts_tpu.models import chatts as jchatts
from chatts_tpu.models import qwen as jqwen
from chatts_tpu.models import quantize as jquant
from chatts_tpu.processor import processor as jprocessor
from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.models import chatts as tchatts
from chatts_tpu_torch.models import quantize as tquant
from chatts_tpu_torch.models.convert import from_jax_params, qwen_from_jax, to_tensor
from chatts_tpu_torch.models.qwen import Dense, QwenModel
from chatts_tpu_torch.ops import fused_glue
from chatts_tpu_torch.ops.int4_matmul import int4_matmul
from chatts_tpu_torch.processor import processor as tprocessor
from chatts_tpu_torch.runtime import kv_cache as tkv
from tests.helpers import FakeTokenizer, random_series

TOL = 1e-4
_NORMS = ("input_layernorm", "post_attention_layernorm", "norm", "q_norm", "k_norm")


def _randomize(tree, rng):
    """Random biases and norm weights, so neither is a no-op."""
    if isinstance(tree, dict):
        return {k: (rng.normal(1.0 if k in _NORMS else 0.0, 0.1, np.shape(v)).astype(np.float32)
                    if k == "bias" or k in _NORMS else _randomize(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize(v, rng) for v in tree]
    return tree


def _config(qwen3, m=tconfig):
    """The tiny config from module ``m``: the port's, or the JAX package's
    for the JAX side.  head_dim 64 keeps every projection a multiple of 128
    wide, so int4 needs no int8 fallback even unfused."""
    return m.tiny_config(vocab_size=512, hidden_size=128, intermediate_size=256,
                       num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                       qwen3=qwen3)


def _llm_params(qwen3, fused, int4, seed=0):
    params = jqwen.init_params(_config(qwen3, jconfig).llm, jax.random.PRNGKey(seed), dtype=jnp.float32)
    params = _randomize(jax.tree.map(np.asarray, params), np.random.default_rng(seed))
    if fused:
        params = jqwen.fuse_projections(params)
    if int4:
        params = jquant.quantize_llm(params, bits=4)
        for layer in params["layers"]:
            for group in (layer["self_attn"], layer["mlp"]):
                for name, sub in group.items():
                    if isinstance(sub, dict):
                        assert "kernel_q4" in sub, name
    return jax.tree.map(np.asarray, params)


def _inputs(cfg, b=2, t=12, seed=1):
    rng = np.random.default_rng(seed)
    embeds = rng.normal(0, 1, (b, t, cfg.llm.hidden_size)).astype(np.float32)
    positions = np.tile(np.arange(t, dtype=np.int32)[None], (b, 1))
    seq_lens = np.asarray([t, t - 5][:b])
    return embeds, positions, seq_lens


@pytest.mark.parametrize("qwen3", [False, True], ids=["qwen2", "qwen3"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("int4", [False, True], ids=["float", "int4"])
def test_torch_qwen_forward_matches_jax(qwen3, fused, int4):
    cfg = _config(qwen3)
    params = _llm_params(qwen3, fused, int4)
    embeds, positions, seq_lens = _inputs(cfg)
    kv_valid = positions < seq_lens[:, None]

    jlcfg = _config(qwen3, jconfig).llm
    hidden, _ = jqwen.forward(params, jlcfg, jnp.asarray(embeds), jnp.asarray(positions),
                              kv_valid=jnp.asarray(kv_valid), attn_impl="xla")
    want_logits = np.asarray(jqwen.compute_logits(params, jlcfg, hidden))

    model = qwen_from_jax(params, cfg.llm)
    got_hidden, _ = model(torch.from_numpy(embeds), torch.from_numpy(positions),
                          kv_valid=torch.from_numpy(kv_valid))
    got_logits = model.compute_logits(got_hidden)
    np.testing.assert_allclose(got_hidden.numpy(), np.asarray(hidden), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("qwen3,int4", [(False, True), (True, False)],
                         ids=["qwen2-int4", "qwen3-float"])
def test_torch_qwen_prefill_then_decode_matches_jax(qwen3, int4):
    """Prefill writes the cache, then three single-token decode steps write
    at cur_len and attend the cache prefix; hidden states and the caches
    themselves match."""
    cfg = _config(qwen3)
    lcfg, jlcfg = cfg.llm, _config(qwen3, jconfig).llm
    params = _llm_params(qwen3, fused=True, int4=int4, seed=2)
    embeds, positions, seq_lens = _inputs(cfg, seed=3)
    b, t = positions.shape
    cap = 32
    kv_pos = np.tile(np.arange(cap, dtype=np.int32)[None], (b, 1))

    jcaches = [(jnp.zeros((b, lcfg.num_key_value_heads, cap, lcfg.head_dim)),) * 2
               for _ in range(lcfg.num_hidden_layers)]
    jh, jcaches = jqwen.forward(
        params, jlcfg, jnp.asarray(embeds), jnp.asarray(positions), kv_caches=jcaches,
        kv_valid=jnp.asarray(kv_pos < seq_lens[:, None]), kv_positions=jnp.asarray(kv_pos),
        attn_impl="xla")
    model = qwen_from_jax(params, lcfg)
    tcaches = tkv.allocate(lcfg, b, cap, torch.float32)
    th, tcaches = model(
        torch.from_numpy(embeds), torch.from_numpy(positions), kv_caches=tcaches,
        kv_valid=torch.from_numpy(kv_pos < seq_lens[:, None]),
        kv_positions=torch.from_numpy(kv_pos))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=TOL, atol=TOL)

    rng = np.random.default_rng(4)
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
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=TOL, atol=TOL)
        cur = cur + 1
    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


def test_torch_merge_embeddings_drops_out_of_bounds_rows():
    """Sentinel (seq = B, tok = T) and other out-of-bounds pairs are dropped,
    as JAX's mode="drop" drops them."""
    rng = np.random.default_rng(5)
    b, t, h = 2, 6, 4
    tokens = rng.normal(0, 1, (b, t, h)).astype(np.float32)
    patches = rng.normal(0, 1, (3, 2, h)).astype(np.float32)
    seq = np.asarray([[0, 0], [1, b], [b + 3, 1]], np.int32)
    tok = np.asarray([[1, 2], [0, t], [0, t + 7]], np.int32)
    want = jchatts.merge_embeddings(*(jnp.asarray(a) for a in (tokens, patches, seq, tok)))
    got = tchatts.merge_embeddings(*(torch.from_numpy(a) for a in (tokens, patches, seq, tok)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_torch_chatts_input_embeddings_match_jax():
    kw = dict(vocab_size=512, hidden_size=64, intermediate_size=128, patch_size=4)
    jcfg, cfg = jconfig.tiny_config(**kw), tconfig.tiny_config(**kw)
    params = jchatts.init_params(jcfg, jax.random.PRNGKey(6), dtype=jnp.float32)

    def batch_args(processor, c):
        rng = np.random.default_rng(7)
        batch = processor.ChatTSProcessor(FakeTokenizer(), c)(
            ["look <ts><ts/> here", "and <ts><ts/> then <ts><ts/>"],
            [random_series(rng, 10), random_series(rng, 17), random_series(rng, 6)])
        assert (batch.scatter_seq == len(batch.seq_lens)).any()  # padded patch slots
        return (batch.input_ids, batch.ts_values, batch.ts_mask, batch.scatter_seq,
                batch.scatter_tok)

    want = jchatts.input_embeddings(params, jcfg, *(jnp.asarray(a) for a in batch_args(
        jprocessor, jcfg)))
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg)
    got = model.input_embeddings(*(torch.from_numpy(np.asarray(a)) for a in batch_args(
        tprocessor, cfg)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_torch_maybe_fuse_keeps_logits():
    cfg = _config(qwen3=False)
    params = _llm_params(False, fused=False, int4=False, seed=8)
    tree = {"llm": params, "ts_encoder": jax.tree.map(
        np.asarray, jchatts.init_params(_config(False, jconfig),
                                        jax.random.PRNGKey(0))["ts_encoder"])}
    embeds, positions, _ = _inputs(cfg, seed=9)
    model = from_jax_params(tree, cfg)
    before, _ = model.llm(torch.from_numpy(embeds), torch.from_numpy(positions))
    fused = tchatts.maybe_fuse(model)
    assert fused.llm.layers[0].self_attn.qkv_proj is not None
    after, _ = fused.llm(torch.from_numpy(embeds), torch.from_numpy(positions))
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=TOL, atol=TOL)


def test_torch_quantize_llm_matches_jax_bytes():
    cfg = _config(qwen3=False)
    params = _llm_params(False, fused=False, int4=False, seed=10)
    want = jax.tree.map(np.asarray, jquant.quantize_llm(params, bits=4))
    got = tquant.quantize_llm(qwen_from_jax(params, cfg.llm), bits=4)
    for jl, tl in zip(want["layers"], got.layers):
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            dense = getattr(tl.self_attn, name)
            np.testing.assert_array_equal(dense.kernel_q4.numpy(),
                                          jl["self_attn"][name]["kernel_q4"])
            np.testing.assert_array_equal(dense.scales4.numpy(),
                                          jl["self_attn"][name]["scales4"])
    np.testing.assert_array_equal(got.lm_head_q.kernel_q4.numpy(),
                                  want["lm_head_q"]["kernel_q4"])
    assert got.lm_head is None


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_torch_init_quantized_params_builds_the_int4_layout(fused):
    cfg = _config(qwen3=True)
    model = tquant.init_quantized_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                         fused=fused)
    attn = model.llm.layers[0].self_attn
    assert (attn.qkv_proj is not None) == fused
    for dense in (attn.o_proj, model.llm.layers[0].mlp.down_proj, model.llm.lm_head_q):
        assert dense.kernel_q4.dtype == torch.int8 and dense.kernel is None
        np.testing.assert_allclose(dense.scales4.numpy(),
                                   1 / (7 * np.sqrt(dense.in_features)), rtol=1e-6)
    embeds, positions, _ = _inputs(cfg)
    hidden, _ = model.llm(torch.from_numpy(embeds).to(torch.bfloat16),
                          torch.from_numpy(positions))
    logits = model.compute_logits(hidden)
    assert logits.shape == (2, 12, cfg.llm.vocab_size) and torch.isfinite(logits).all()
    # bits=8 is the int8 tier (tests/test_torch_int8_weights.py); no other.
    with pytest.raises(ValueError, match="bits"):
        tquant.init_quantized_params(cfg, torch.Generator(), "cpu", bits=3)


@pytest.mark.parametrize("case", ["dense_bias", "lm_head", "tied"])
def test_torch_bf16_products_are_f32_like_jax(case):
    """bf16 weights and activations: a float projection adds its bias to the
    f32 product before the one rounding to bf16, and a float head returns the
    f32 product, as the reference's ``preferred_element_type=float32`` does.
    A product rounded to bf16 first is off by up to half a bf16 ulp of the
    output (about 0.1 at a projection's magnitude 16 to 32, 0.01 to 0.03 at a
    logit's 2 to 10).  Tolerance 1e-5 of the largest output: the same f32
    products, summed in another order."""
    rng = np.random.default_rng(11)
    hid, out = 128, 256
    x = jnp.asarray(rng.normal(0, 1, (3, 5, hid)).astype(np.float32), jnp.bfloat16)
    w = jnp.asarray(rng.normal(0, 2.0, (hid, out)).astype(np.float32), jnp.bfloat16)
    if case == "dense_bias":
        bias = jnp.asarray(rng.normal(0, 4.0, (out,)).astype(np.float32), jnp.bfloat16)
        want = jqwen._dense(x, {"kernel": w, "bias": bias})
        got = Dense(to_tensor(w), bias=to_tensor(bias))(to_tensor(x))
        assert got.dtype == torch.bfloat16
    else:
        lcfg, jlcfg = (dataclasses.replace(_config(False, m).llm, vocab_size=out,
                                           hidden_size=hid, tie_word_embeddings=case == "tied")
                       for m in (tconfig, jconfig))
        table = jnp.asarray(rng.normal(0, 0.5, (out, hid)).astype(np.float32), jnp.bfloat16)
        params = {"embed_tokens": table}
        if case == "lm_head":
            params["lm_head"] = w
        want = jqwen.compute_logits(params, jlcfg, x)
        model = QwenModel(lcfg, to_tensor(table), [], to_tensor(jnp.ones((hid,))),
                          lm_head=to_tensor(w) if case == "lm_head" else None)
        got = model.compute_logits(to_tensor(x))
        assert got.dtype == torch.float32
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_torch_whole_int4_dense_returns_the_kernel_output(bias):
    """A whole int4 projection (no zero-points, no mesh) with nothing to add
    returns ``int4_matmul``'s output bit for bit: the round trip through f32
    it used to make is exact.  With a bias: the f32 sum rounded once, and
    ``forward_unbiased`` hands the bias back unadded."""
    gen = torch.Generator().manual_seed(3)
    packed = torch.randint(-128, 128, (64, 256), generator=gen, dtype=torch.int8)
    scales = torch.rand((1, 256), generator=gen) / 50
    b = torch.randn((256,), generator=gen).to(torch.bfloat16) if bias else None
    x = torch.randn((3, 5, 128), generator=gen).to(torch.bfloat16)
    dense = Dense(kernel_q4=packed, scales4=scales, bias=b)
    y = int4_matmul(x.reshape(15, 128), packed, scales).reshape(3, 5, 256)
    want = y if b is None else (y.float() + b.float()).to(torch.bfloat16)
    got = dense(x)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    got_y, got_bias = dense.forward_unbiased(x)
    assert torch.equal(got_y, y) and got_bias is dense.bias


@pytest.mark.parametrize("case", ["cpu", "grad", "mesh"])
def test_torch_glue_gate_picks_eager(case):
    """The glue's kernels engage on CUDA bf16 tensors only, with autograd
    recording none of them and no tensor-parallel mesh; the eager functions
    run for CPU tensors, for inputs that need a gradient and under a mesh."""
    x = torch.ones((2, 128), dtype=torch.bfloat16)
    w = torch.ones((128,), dtype=torch.bfloat16)
    if case == "cpu":
        assert not fused_glue.engaged(None, x, w, None)
    elif case == "grad":
        x.requires_grad_(True)
        assert not fused_glue.engaged(None, x, w)
        with torch.no_grad():  # autograd off: the CPU still keeps it eager
            assert not fused_glue.engaged(None, x, w)
    else:
        assert not fused_glue.engaged(object(), x, w)
    before = fused_glue.counts()
    fused_glue.take("add_rms_norm", fused_glue.engaged(
        object() if case == "mesh" else None, x, w))
    assert fused_glue.counts() == {"fused": before["fused"], "eager": before["eager"] + 1}


@pytest.mark.parametrize("qwen3", [False, True], ids=["qwen2", "qwen3"])
def test_torch_glue_call_sites_stay_eager_on_the_cpu(qwen3):
    """Every forward passes the glue's call sites once each: per layer the
    two norms after their residual adds, the qkv epilogue and SiLU * up,
    then the final norm; on the CPU every one of them runs eagerly."""
    cfg = _config(qwen3)
    llm = tquant.init_quantized_params(cfg, torch.Generator().manual_seed(0), "cpu").llm
    sites = 4 * cfg.llm.num_hidden_layers + 1
    caches = tkv.allocate(cfg.llm, 2, 16, torch.int8)
    embeds = torch.randn((2, 4, cfg.llm.hidden_size)).to(torch.bfloat16)
    positions = torch.arange(4)[None].repeat(2, 1)
    before = fused_glue.counts()
    llm(embeds, positions, kv_caches=caches)
    assert fused_glue.counts() == {"fused": before["fused"], "eager": before["eager"] + sites}
    pos = torch.full((2, 1), 4, dtype=torch.int32)
    llm(embeds[:, :1], pos, kv_caches=caches, write_pos=pos,
        kv_lengths=torch.full((2,), 5, dtype=torch.int32))
    assert fused_glue.counts() == {"fused": before["fused"],
                                   "eager": before["eager"] + 2 * sites}
