"""The port's checkpoint loader (``models/weights.py``) against the JAX
package's ``models/weights.py`` on the same directories.

Every directory is written by the JAX package's ``save_checkpoint`` (some
then rewritten: GPTQ-packed projections, other key spellings, broken
names), and loaded by both packages on the CPU. The JAX tree goes through
``models/convert.py::from_jax_params`` and every parameter and buffer of
the two models must be equal to the bit: float (f32 and bf16), int8, int4,
GPTQ symmetric, asymmetric and activation-order, Qwen3's q/k norms, the
f32 encoder. ``diagnose`` must give JAX's report, field for field and word
for word. On one tiny f32 checkpoint the logits agree within 1e-4 (the f32
tolerance of ``tests/test_torch_qwen.py``: sums in another order) and the
greedy tokens of the two engines are equal."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu.core import config as jconfig
from chatts_tpu.models import chatts as jchatts
from chatts_tpu.models import gptq as jgptq
from chatts_tpu.models import weights as jweights
from chatts_tpu.processor import processor as jprocessor
from chatts_tpu.runtime.engine import InferenceEngine as JaxEngine
from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.core.config import GenerationConfig
from chatts_tpu_torch.models import weights
from chatts_tpu_torch.models.convert import from_jax_params
from chatts_tpu_torch.models.qwen import Dense
from chatts_tpu_torch.models.quantize import quantize_dense_int4, quantize_llm
from chatts_tpu_torch.processor import processor as tprocessor
from chatts_tpu_torch.runtime.engine import InferenceEngine
from chatts_tpu_torch.utils import safetensors_io as io
from tests.helpers import FakeTokenizer

PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def _cfg(m=jconfig, qwen3=False, tie=False):
    """Tiny widths whose every projection tiles the int4 kernels."""
    cfg = m.tiny_config(vocab_size=512, hidden_size=256, intermediate_size=512,
                        num_attention_heads=4, num_key_value_heads=2, patch_size=4,
                        qwen3=qwen3)
    if tie:
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, tie_word_embeddings=True))
    return cfg


def _save_jax(path, seed=0, **kw):
    cfg = _cfg(**kw)
    params = jchatts.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    jweights.save_checkpoint(str(path), cfg, params)
    return cfg, params


def _rewrite(path, fn):
    """Rewrite the single-file checkpoint's tensors through ``fn(dict)``,
    with the port's writer."""
    fname = os.path.join(str(path), io.SINGLE_NAME)
    with io.SafetensorsFile(fname) as f:
        tensors = {k: f.get(k).numpy() for k in f.keys()}
    io.save_file(fn(tensors), fname)


def _to_gptq(path, style, group=128, seed=0):
    """Every decoder projection of the checkpoint as AutoGPTQ-v1 tensors:
    ``style`` sym (zeros 8), asym, or desc_act (a shuffled balanced g_idx)."""
    rng = np.random.default_rng(seed)

    def fn(tensors):
        for key in sorted(tensors):
            if not key.endswith(tuple(p + ".weight" for p in PROJ)):
                continue
            out_f, in_f = tensors.pop(key).shape
            name, groups = key[:-len(".weight")], in_f // group
            codes = rng.integers(0, 16, size=(in_f, out_f), dtype=np.int32)
            zeros = (rng.integers(1, 16, size=(groups, out_f), dtype=np.int32)
                     if style == "asym" else np.full((groups, out_f), 8, np.int32))
            g_idx = np.repeat(np.arange(groups), group).astype(np.int32)
            if style == "desc_act":
                rng.shuffle(g_idx)
            tensors[name + ".qweight"] = jgptq.pack_int4(codes, axis=0)
            tensors[name + ".qzeros"] = jgptq.pack_int4(zeros - 1, axis=1)
            tensors[name + ".scales"] = rng.uniform(0.002, 0.02, (groups, out_f)).astype(np.float16)
            tensors[name + ".g_idx"] = g_idx
        return tensors

    _rewrite(path, fn)


def _state(model):
    out = dict(model.named_parameters())
    out.update(dict(model.named_buffers()))
    return out


def _assert_same_model(got, want):
    a, b = _state(got), _state(want)
    assert set(a) == set(b), set(a) ^ set(b)
    for name in b:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


def _both(path, bits, dtype):
    """(port model, port cfg, the JAX load as a port model)."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _, jparams = jweights.load_checkpoint(str(path), dtype=jdtype, quantize_bits=bits)
    cfg, model = weights.load_checkpoint(str(path), dtype=dtype, device="cpu",
                                         quantize_bits=bits)
    want = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return model, cfg, want


CASES = {
    # name: (gptq style or None, quantize_bits, dtype, qwen3)
    "float_f32": (None, None, torch.float32, False),
    "float_bf16": (None, None, torch.bfloat16, False),
    "int8": (None, 8, torch.bfloat16, False),
    "int4": (None, 4, torch.bfloat16, False),
    "qwen3_int4": (None, 4, torch.bfloat16, True),
    "gptq_sym": ("sym", 4, torch.bfloat16, False),
    "gptq_asym": ("asym", 4, torch.bfloat16, False),
    "gptq_desc_act": ("desc_act", 4, torch.bfloat16, False),
    "gptq_asym_dequantized": ("asym", None, torch.bfloat16, False),
    "gptq_desc_act_int8": ("desc_act", 8, torch.bfloat16, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_torch_load_checkpoint_bit_equal_to_jax(tmp_path, case, monkeypatch):
    style, bits, dtype, qwen3 = CASES[case]
    # The head (vocab 512) is quantized in slices of 128 columns, as the
    # 14B head is in slices of HEAD_COLUMNS: the slices give JAX's codes.
    monkeypatch.setattr(weights, "HEAD_COLUMNS", 128)
    _save_jax(tmp_path, qwen3=qwen3)
    if style:
        _to_gptq(tmp_path, style)
    model, cfg, want = _both(tmp_path, bits, dtype)
    _assert_same_model(model, want)
    layer = model.llm.layers[0]
    q = layer.self_attn.q_proj
    assert q is not None and layer.self_attn.qkv_proj is None  # unfused, as JAX loads
    if bits == 4:
        assert q.kernel_q4 is not None and model.llm.lm_head_q.kernel_q4 is not None
        assert (q.zeros4 is not None) == (style == "asym")
        assert (q.perm4 is not None) == (style == "desc_act")
    assert cfg.llm.qk_norm == qwen3 and (layer.self_attn.q_norm is not None) == qwen3
    assert model.ts_encoder.kernels[0].dtype == torch.float32


def test_torch_gptq_group64_requantizes_at_group_128(tmp_path):
    """The chosen difference: JAX imports a group-64 export losslessly; the
    port dequantizes it and requantizes at group 128, exactly as
    ``quantize_dense_int4`` does for the dequantized kernel in the model's
    dtype."""
    _save_jax(tmp_path)
    _to_gptq(tmp_path, "asym", group=64)
    _, jparams = jweights.load_checkpoint(str(tmp_path), quantize_bits=4)
    jq = jparams["llm"]["layers"][0]["self_attn"]["q_proj"]
    assert np.asarray(jq["scales4"]).shape[0] == 256 // 64 and "zeros4" in jq
    _, model = weights.load_checkpoint(str(tmp_path), device="cpu", quantize_bits=4)
    q = model.llm.layers[0].self_attn.q_proj
    lazy = weights.LazyStateDict(str(tmp_path))
    kernel = jgptq.load_gptq_kernel(lazy, "model.layers.0.self_attn.q_proj")
    kernel = torch.from_numpy(kernel.astype(np.float32))
    lazy.close()
    want = quantize_dense_int4(Dense(kernel.to(torch.bfloat16)))
    assert q.scales4.shape[0] == 256 // 128 and q.zeros4 is None
    assert torch.equal(q.kernel_q4, want.kernel_q4) and torch.equal(q.scales4, want.scales4)


@pytest.mark.parametrize("bits", [None, 4])
def test_torch_tied_embeddings_detected(tmp_path, bits):
    _save_jax(tmp_path, tie=True)
    model, cfg, want = _both(tmp_path, bits, torch.bfloat16)
    assert cfg.llm.tie_word_embeddings
    assert model.llm.lm_head is None and model.llm.lm_head_q is None
    _assert_same_model(model, want)
    # A config that says untied is corrected by the checkpoint.
    untied = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, tie_word_embeddings=False))
    cfg2, _ = weights.load_checkpoint(str(tmp_path), untied, device="cpu")
    assert cfg2.llm.tie_word_embeddings


SCHEMES = {
    "model_ts": lambda k: ("model." + k) if k.startswith("ts_encoder.") else k,
    "language_model": lambda k: ("language_model." + k) if k.startswith(("model.", "lm_head.")) else k,
    "ts_dot": lambda k: ("ts." + k[len("ts_encoder."):]) if k.startswith("ts_encoder.") else k,
    "bare": lambda k: k[len("model."):] if k.startswith("model.") else k,
}


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_torch_name_variants_load_like_jax(tmp_path, scheme):
    _save_jax(tmp_path, seed=5)
    _, plain = weights.load_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    _rewrite(tmp_path, lambda t: {SCHEMES[scheme](k): v for k, v in t.items()})
    report = weights.diagnose(str(tmp_path))
    assert report.ok and report.unused == ()
    model, _, want = _both(tmp_path, None, torch.float32)
    _assert_same_model(model, want)
    _assert_same_model(model, plain)


def _break(kind):
    def fn(tensors):
        if kind == "misnamed":
            tensors["model.final_norm.weight"] = tensors.pop("model.norm.weight")
        elif kind == "missing_proj":
            del tensors["model.layers.1.self_attn.o_proj.weight"]
        elif kind == "shape":
            tensors["model.norm.weight"] = np.zeros(257, np.float32)
        elif kind == "extra":
            tensors["model.layers.0.mlp.extra.weight"] = np.zeros(3, np.float32)
        return tensors
    return fn


@pytest.mark.parametrize("kind", ["clean", "misnamed", "missing_proj", "shape", "extra", "gptq"])
def test_torch_diagnose_reports_like_jax(tmp_path, kind):
    _save_jax(tmp_path, seed=7)
    if kind == "gptq":
        _to_gptq(tmp_path, "desc_act")
    elif kind != "clean":
        _rewrite(tmp_path, _break(kind))
    got = weights.diagnose(str(tmp_path))
    want = jweights.diagnose(str(tmp_path))
    for field in dataclasses.fields(want):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert got.summary() == want.summary()
    assert got.ok == (kind in ("clean", "extra", "gptq"))
    if kind == "gptq":
        assert got.gptq_projections == 2 * len(PROJ)
    if not got.ok:
        with pytest.raises(ValueError, match="does not match the loader"):
            weights.load_checkpoint(str(tmp_path), device="cpu")
    assert weights.main([str(tmp_path)]) == (0 if got.ok else 1)


@pytest.mark.parametrize("qwen3", [False, True], ids=["qwen2", "qwen3"])
def test_torch_save_checkpoint_loads_in_jax(tmp_path, qwen3):
    """The port's save_checkpoint writes what the JAX package's writes: the
    same tensors (names, f32 values) and the same config.json."""
    cfg, jparams = _save_jax(tmp_path / "jax", seed=9, qwen3=qwen3)
    model = from_jax_params(jax.tree.map(np.asarray, jparams), _cfg(tconfig, qwen3=qwen3), "cpu")
    weights.save_checkpoint(str(tmp_path / "port"), _cfg(tconfig, qwen3=qwen3), model)
    with open(tmp_path / "jax" / "config.json") as a, open(tmp_path / "port" / "config.json") as b:
        assert json.load(a) == json.load(b)
    with io.SafetensorsFile(str(tmp_path / "jax" / io.SINGLE_NAME)) as a, \
            io.SafetensorsFile(str(tmp_path / "port" / io.SINGLE_NAME)) as b:
        assert set(a.keys()) == set(b.keys())
        for k in a.keys():
            assert torch.equal(a.get(k), b.get(k)), k
    _, loaded = jweights.load_checkpoint(str(tmp_path / "port"), dtype=jnp.float32)
    for x, y in zip(jax.tree.leaves(loaded), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    quantize_llm(model.llm, bits=8)
    with pytest.raises(ValueError, match="unfused float"):
        weights.save_checkpoint(str(tmp_path / "int8"), _cfg(tconfig), model)


@pytest.fixture
def f32_checkpoint(tmp_path):
    path = tmp_path
    _save_jax(path, seed=11)
    _, jparams = jweights.load_checkpoint(str(path), dtype=jnp.float32)
    cfg, model = weights.load_checkpoint(str(path), dtype=torch.float32, device="cpu")
    return jparams, cfg, model


def test_torch_loaded_logits_match_jax(f32_checkpoint):
    jparams, cfg, model = f32_checkpoint
    ids = np.random.default_rng(0).integers(0, 400, size=(2, 12))
    pos = np.tile(np.arange(12), (2, 1))
    jcfg = _cfg()
    hidden, _ = jchatts.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), attn_impl="xla")
    want = np.asarray(jchatts.compute_logits(jparams, jcfg, hidden))
    with torch.no_grad():
        h, _ = model(torch.from_numpy(ids), torch.from_numpy(pos))
        got = model.compute_logits(h).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_torch_loaded_greedy_tokens_match_jax_engine(f32_checkpoint):
    jparams, cfg, model = f32_checkpoint
    prompts = ["analyze <ts><ts/> please", "and <ts><ts/> this <ts><ts/> too long prompt"]
    series = [np.arange(16.0), np.sin(np.arange(32)) * 10, np.arange(8.0)]
    jax_engine = JaxEngine(jparams, _cfg(), cache_dtype=jnp.float32, attn_impl="xla",
                           decode_recent_kv=False, decode_chunk=4)
    want = jax_engine.generate(jprocessor.ChatTSProcessor(FakeTokenizer(), _cfg())(prompts, series),
                               jconfig.GenerationConfig(max_new_tokens=8, greedy=True))
    port = InferenceEngine(model, cfg, device="cpu", cache_dtype=torch.float32, decode_chunk=4)
    got = port.generate(tprocessor.ChatTSProcessor(FakeTokenizer(), cfg)(prompts, series),
                        GenerationConfig(max_new_tokens=8, greedy=True))
    assert got.token_ids == want.token_ids and all(len(t) == 8 for t in got.token_ids)
