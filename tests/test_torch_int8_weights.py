"""int8 weights (``kernel_q`` + per-column ``scales``): the port's quantize,
convert, ``Dense``, ``init_quantized_params`` and engine against the JAX
package on the same numpy inputs, weight-only and with int8 activations.

JAX computes the int8 x int8 -> int32 product with XLA on any backend, so
these comparisons need no interpret mode.  Quantized bytes and layouts match
exactly; f32 outputs differ only in summation order (1e-5 of the largest
output for one projection, 1e-4 for the decoder as in
``test_torch_qwen.py``); greedy tokens match exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu.core import config as jconfig
from chatts_tpu.models import chatts as jchatts
from chatts_tpu.models import quantize as jquant
from chatts_tpu.models import qwen as jqwen
from chatts_tpu.runtime.engine import InferenceEngine as JaxEngine
from chatts_tpu_torch.models import quantize as tquant
from chatts_tpu_torch.models.convert import dense_from_jax, qwen_from_jax, to_tensor
from chatts_tpu_torch.models.qwen import Dense
from chatts_tpu_torch.runtime.engine import InferenceEngine
from tests.test_torch_engine import _config as _engine_config
from tests.test_torch_engine import _generate_both
from tests.test_torch_qwen import _config, _inputs, _llm_params

DENSE_TOL = 1e-5
TOL = 1e-4
# The decoder with int8 activations: see FORWARD_TOL_OF_MAX in
# test_torch_act_int8.py (a code may move one step where the frameworks' f32
# activations straddle a rounding boundary).
FORWARD_TOL_OF_MAX = 1e-3
_PARTS = ("kernel", "kernel_q4", "scales4", "zeros4", "perm4", "kernel_q", "scales", "bias")


def _close_of_max(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _layout(dense: Dense):
    out = {}
    for name in _PARTS:
        t = getattr(dense, name)
        if t is not None:
            out[name] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    return out


def _jax_layout(layer):
    return {k: (tuple(np.shape(v)), str(np.asarray(v).dtype)) for k, v in layer.items()}


def _projections(llm_layer):
    """(name, port Dense) of one port decoder layer."""
    for group in (llm_layer.self_attn, llm_layer.mlp):
        for name in ("qkv_proj", "q_proj", "k_proj", "v_proj", "o_proj",
                     "gate_up_proj", "gate_proj", "up_proj", "down_proj"):
            dense = getattr(group, name, None)
            if dense is not None:
                yield name, dense


def _jax_group(layer, name):
    return layer["self_attn"] if name in layer["self_attn"] else layer["mlp"]


def test_torch_quantize_dense_matches_jax_bytes():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.05, (96, 40)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column gets scale 1
    bias = rng.normal(0, 0.1, (40,)).astype(np.float32)
    want = jquant.quantize_dense({"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)})
    got = tquant.quantize_dense(Dense(torch.from_numpy(w), bias=torch.from_numpy(bias)))
    assert got.kernel_q.dtype == torch.int8 and got.kernel is None
    np.testing.assert_array_equal(got.kernel_q.numpy(), np.asarray(want["kernel_q"]))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want["scales"]))
    assert float(got.scales[3]) == 1.0
    np.testing.assert_array_equal(got.bias.numpy(), bias)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        back = tquant.dequantize_dense(got, dtype)
        np.testing.assert_array_equal(
            back.kernel.float().numpy(),
            np.asarray(jquant.dequantize_dense(want, jdtype)["kernel"].astype(jnp.float32)))


@pytest.mark.parametrize("rows", [3, 40])
@pytest.mark.parametrize("mode", ["weight_only_f32", "weight_only_bf16", "act_int8"])
def test_torch_int8_dense_matches_jax(mode, rows):
    """rows 3 pads the int8 GEMM's operand to 17 rows; 40 does not."""
    rng = np.random.default_rng(rows)
    w = rng.normal(0, 0.05, (128, 96)).astype(np.float32)
    layer = jquant.quantize_dense({"kernel": jnp.asarray(w),
                                   "bias": jnp.asarray(rng.normal(0, 0.1, (96,)), jnp.float32)})
    dtype = jnp.bfloat16 if mode == "weight_only_bf16" else jnp.float32
    x = jnp.asarray(rng.normal(0, 1, (rows, 128)).astype(np.float32)).astype(dtype)
    act_int8 = mode == "act_int8"
    want = jqwen._dense(x[None], layer, act_int8=act_int8)[0]
    got = dense_from_jax(jax.tree.map(np.asarray, layer))(to_tensor(x)[None], act_int8)[0]
    assert got.dtype == (torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    _close_of_max(got.float().numpy(), want.astype(jnp.float32), DENSE_TOL)
    if act_int8:
        off = jqwen._dense(x[None], layer)[0]
        assert np.abs(np.asarray(want - off)).max() > 100 * DENSE_TOL * np.abs(want).max()


def test_torch_quantize_llm_bits8_matches_jax_bytes():
    cfg = _config(qwen3=False)
    params = _llm_params(False, fused=False, int4=False, seed=12)
    want = jax.tree.map(np.asarray, jquant.quantize_llm(params, bits=8))
    got = tquant.quantize_llm(qwen_from_jax(params, cfg.llm), bits=8)
    for jl, tl in zip(want["layers"], got.layers):
        for name, dense in _projections(tl):
            jd = _jax_group(jl, name)[name]
            assert _layout(dense) == _jax_layout(jd), name
            np.testing.assert_array_equal(dense.kernel_q.numpy(), jd["kernel_q"])
            np.testing.assert_array_equal(dense.scales.numpy(), jd["scales"])
    np.testing.assert_array_equal(got.lm_head_q.kernel_q.numpy(), want["lm_head_q"]["kernel_q"])
    assert got.lm_head is None


def test_torch_quantize_llm_int4_falls_back_to_int8_like_jax():
    """head_dim 32 with 2 KV heads makes k_proj and v_proj 64 wide, which
    the int4 kernels do not tile: both packages quantize them to int8."""
    cfg = _engine_config()
    params = jax.tree.map(np.asarray, jqwen.init_params(
        _engine_config(jconfig).llm, jax.random.PRNGKey(3), dtype=jnp.float32))
    want = jax.tree.map(np.asarray, jquant.quantize_llm(params, bits=4))
    got = tquant.quantize_llm(qwen_from_jax(params, cfg.llm), bits=4)
    kinds = set()
    for jl, tl in zip(want["layers"], got.layers):
        for name, dense in _projections(tl):
            jd = _jax_group(jl, name)[name]
            assert _layout(dense) == _jax_layout(jd), name
            for part in ("kernel_q", "scales", "kernel_q4", "scales4"):
                if part in jd:
                    np.testing.assert_array_equal(getattr(dense, part).numpy(), jd[part])
            kinds.add((name, "kernel_q" in jd))
    assert ("k_proj", True) in kinds and ("q_proj", False) in kinds


@pytest.mark.parametrize("bits,fused", [(8, True), (8, False), (4, False)])
def test_torch_init_quantized_params_layout_matches_jax(bits, fused):
    """The same layout, dtypes and scales as the JAX package; bits=4 at
    head_dim 32 falls back to int8 where a projection does not tile."""
    cfg = _engine_config()
    want = jquant.init_quantized_params(_engine_config(jconfig), jax.random.PRNGKey(0),
                                        fused=fused, bits=bits)
    got = tquant.init_quantized_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                       bits=bits, fused=fused)
    want = jax.tree.map(np.asarray, want["llm"])
    for jl, tl in zip(want["layers"], got.llm.layers):
        for name, dense in _projections(tl):
            jd = _jax_group(jl, name)[name]
            assert _layout(dense) == _jax_layout(jd), name
            for part in ("scales", "scales4"):
                if part in jd:
                    np.testing.assert_array_equal(getattr(dense, part).numpy(), jd[part])
            if dense.kernel_q is not None:
                assert int(dense.kernel_q.min()) >= -127
    assert _layout(got.llm.lm_head_q) == _jax_layout(want["lm_head_q"])
    embeds, positions, _ = _inputs(cfg)
    hidden, _ = got.llm(torch.from_numpy(embeds).to(torch.bfloat16),
                        torch.from_numpy(positions), act_int8=True)
    assert torch.isfinite(got.compute_logits(hidden)).all()


@pytest.mark.parametrize("act_int8", [False, True], ids=["weight_only", "act_int8"])
def test_torch_int8_forward_matches_jax(act_int8):
    cfg, jlcfg = _config(qwen3=True), _config(True, jconfig).llm
    params = jax.tree.map(np.asarray, jquant.quantize_llm(
        _llm_params(True, fused=True, int4=False, seed=13), bits=8))
    embeds, positions, seq_lens = _inputs(cfg, seed=14)
    kv_valid = positions < seq_lens[:, None]
    want, _ = jqwen.forward(params, jlcfg, jnp.asarray(embeds), jnp.asarray(positions),
                            kv_valid=jnp.asarray(kv_valid), attn_impl="xla", act_int8=act_int8)
    want_logits = np.asarray(jqwen.compute_logits(params, jlcfg, want))
    model = qwen_from_jax(params, cfg.llm)
    got, _ = model(torch.from_numpy(embeds), torch.from_numpy(positions),
                   kv_valid=torch.from_numpy(kv_valid), act_int8=act_int8)
    if act_int8:
        _close_of_max(got.numpy(), want, FORWARD_TOL_OF_MAX)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(model.compute_logits(got).numpy(), want_logits,
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("act_int8", [False, True], ids=["weight_only", "act_int8"])
def test_torch_int8_greedy_generate_matches_jax(act_int8):
    cfg = _engine_config()
    params = jquant.quantize_params(
        jchatts.maybe_fuse(jchatts.init_params(_engine_config(jconfig), jax.random.PRNGKey(4),
                                               dtype=jnp.float32)),
        bits=8)
    assert all("kernel_q" in sub for layer in params["llm"]["layers"]
               for group in (layer["self_attn"], layer["mlp"])
               for sub in group.values() if isinstance(sub, dict))
    jax_engine = JaxEngine(params, _engine_config(jconfig), cache_dtype=jnp.float32,
                           attn_impl="xla", decode_recent_kv=False, decode_chunk=4,
                           prefill_act_int8=act_int8)
    port = InferenceEngine(jax.tree.map(np.asarray, params), cfg, device="cpu",
                           cache_dtype=torch.float32, decode_chunk=4, prefill_act_int8=act_int8)
    want, got = _generate_both(jax_engine, port, max_new_tokens=10, greedy=True)
    got = got.token_ids
    assert got == want.token_ids
    assert all(len(t) == 10 for t in got)
