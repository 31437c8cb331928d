"""int8-activation prefill with int4 weights: the port's ``quantize_acts``,
``int4_matmul_a8`` plain version, ``Dense(act_int8=True)``,
``QwenModel.forward(act_int8=True)`` and the engines with
``prefill_act_int8``, against the JAX package on the same numpy inputs.

The JAX package takes its a8 kernel off the TPU only in Pallas interpret
mode (``CHATTS_INT4_INTERPRET=1``); without it ``qwen._dense`` quietly runs
the bf16 dequant path and a comparison would be vacuous.  So every JAX a8
comparison here sets the variable, and shows that the a8 branch was taken:
its output differs from the act_int8=False output by more than the
tolerance, or a spy counts the a8 kernel's calls.  The variable is read when
JAX traces, so the engine tests clear JAX's caches around themselves."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatts_tpu.core import config as jconfig
from chatts_tpu.models import qwen as jqwen
from chatts_tpu.ops import int4_matmul as ji4
from chatts_tpu.processor import processor as jprocessor
from chatts_tpu.runtime.engine import InferenceEngine as JaxEngine
from chatts_tpu_torch.core.config import GenerationConfig
from chatts_tpu_torch.models import qwen as tqwen
from chatts_tpu_torch.models.convert import dense_from_jax, from_jax_params, qwen_from_jax
from chatts_tpu_torch.ops import int4_matmul as ti4
from chatts_tpu_torch.processor.processor import ChatTSProcessor
from chatts_tpu_torch.runtime.engine import InferenceEngine
from chatts_tpu_torch.serve.scheduler import Request, SamplingParams, ServeEngine
from tests.helpers import FakeTokenizer
from tests.test_torch_engine import _batch, _config as _engine_config, _params as _engine_params
from tests.test_torch_qwen import _config, _inputs, _llm_params
from tests.test_torch_serve import wait, wait_first_token

# The plain a8 matmul against the Pallas kernel, both f32: a group's integer
# sum is exact on both sides, so they differ only where XLA fuses the group
# scale's multiply into the add (one f32 rounding per group).
MATMUL_TOL = 1e-5
# Dense with act_int8 on identical inputs: identical codes, the same f32
# operations; only summation order differs.
DENSE_TOL = 1e-5
# Two decoder layers, as a share of the largest hidden value.  The
# frameworks' f32 activations differ in their last bits, and where one
# straddles a rounding boundary its int8 code moves by one step (1/127 of its
# row's largest value).  On these inputs no code moved and the port is within
# 2e-7; the a8 branch itself moves the hidden states by 1.3e-2 to 1.4e-2.
# 1e-3 leaves room for a few moved codes and none for a wrong branch.
FORWARD_TOL_OF_MAX = 1e-3


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CHATTS_INT4_INTERPRET", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _int4_values(rng, in_dim, out_dim):
    q = rng.integers(-8, 8, size=(in_dim, out_dim)).astype(np.int8)
    q[:3, :5] = -8  # GPTQ imports carry -8
    scales = rng.uniform(0.01, 0.2, size=(in_dim // 128, out_dim)).astype(np.float32)
    packed, _ = ji4.pack_from_int4_values(jnp.asarray(q), jnp.asarray(scales))
    return np.asarray(packed), scales


def _close_of_max(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_torch_quantize_acts_matches_jax_exactly():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (5, 7, 96)).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero row takes the 1e-8 floor scale, codes 0
    x[0, 0, :4] = [127.5, -127.5, 0.5, 2.5]  # halves round to even
    for dtype in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x).astype(dtype)
        want_q, want_s = jqwen._quantize_acts(xj)
        got_q, got_s = tqwen.quantize_acts(torch.from_numpy(np.asarray(xj.astype(jnp.float32)))
                                           .to(torch.bfloat16 if dtype == jnp.bfloat16
                                               else torch.float32))
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        assert (got_q[1, 2] == 0).all() and float(got_s[1, 2]) == np.float32(1e-8)


@pytest.mark.parametrize("r", [1, 17, 600])
@pytest.mark.parametrize("in_dim,out_dim", [(256, 256), (256, 512), (384, 256), (384, 512)])
def test_torch_int4_a8_plain_matches_pallas_interpret(r, in_dim, out_dim):
    """R = 600 crosses the Pallas kernel's 512-row block."""
    rng = np.random.default_rng(r + in_dim + out_dim)
    packed, scales = _int4_values(rng, in_dim, out_dim)
    xq = rng.integers(-127, 128, (r, in_dim)).astype(np.int8)
    xs = rng.uniform(1e-3, 0.1, (r,)).astype(np.float32)
    want = ji4.int4_matmul_a8(*(jnp.asarray(a) for a in (xq, xs, packed, scales)),
                              out_dtype=jnp.float32, interpret=True)
    args = [torch.from_numpy(np.array(a)) for a in (xq, xs, packed, scales)]
    got = ti4.int4_matmul_a8_reference(*args, out_dtype=torch.float32)
    assert got.shape == (r, out_dim) and got.dtype == torch.float32
    _close_of_max(got.numpy(), want, MATMUL_TOL)
    # On CPU tensors the wrapper is the plain version and launches nothing;
    # its default result type is the kernel's bf16.
    before = ti4.int4_matmul_a8.launches
    np.testing.assert_array_equal(ti4.int4_matmul_a8(*args, out_dtype=torch.float32).numpy(),
                                  got.numpy())
    assert ti4.int4_matmul_a8(*args).dtype == torch.bfloat16
    assert ti4.int4_matmul_a8.launches == before


def test_torch_int4_a8_wrapper_refuses_other_devices():
    xq = torch.empty((2, 256), device="meta", dtype=torch.int8)
    xs = torch.empty((2,), device="meta", dtype=torch.float32)
    packed = torch.empty((128, 256), device="meta", dtype=torch.int8)
    scales = torch.empty((2, 256), device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        ti4.int4_matmul_a8(xq, xs, packed, scales)


@pytest.mark.parametrize("r,want", [(1, 1), (37, 1), (64, 1), (65, 2), (129, 2), (4096, 2),
                                    (5120, 2)])
def test_torch_int4_a8_block_width_by_rows(r, want):
    """The a8 kernel's block width is chosen from R alone: one consumer
    warpgroup (128 output columns a block) while the rows fit one 64-row
    tile, two above."""
    assert ti4.a8_warpgroups(r) == want
    assert want in ti4.A8_WARPGROUPS
    assert ti4.a8_warpgroups(ti4.A8_NARROW_MAX_ROWS) == 1
    assert ti4.a8_warpgroups(ti4.A8_NARROW_MAX_ROWS + 1) == 2


def test_torch_int4_a8_on_width_is_for_the_card():
    rng = np.random.default_rng(2)
    packed, scales = (np.asarray(a) for a in _int4_values(rng, 256, 256))
    xq = torch.zeros((2, 256), dtype=torch.int8)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        ti4.int4_matmul_a8_on_width(xq, torch.ones(2), torch.from_numpy(packed),
                                    torch.from_numpy(scales), 1)


@pytest.mark.parametrize("extras", ["plain", "zeros4", "perm4", "zeros4+perm4"])
def test_torch_int4_dense_act_int8_matches_jax(interpret, extras):
    rng = np.random.default_rng(3)
    in_dim, out_dim = 384, 256
    packed, scales = _int4_values(rng, in_dim, out_dim)
    layer = {"kernel_q4": packed, "scales4": scales,
             "bias": rng.normal(0, 0.1, (out_dim,)).astype(np.float32)}
    if "zeros4" in extras:
        layer["zeros4"] = rng.normal(0, 0.02, (in_dim // 128, out_dim)).astype(np.float32)
    if "perm4" in extras:
        layer["perm4"] = rng.permutation(in_dim).astype(np.int32)
    x = rng.normal(0, 1, (2, 9, in_dim)).astype(np.float32)
    jlayer = {k: jnp.asarray(v) for k, v in layer.items()}
    want = np.asarray(jqwen._dense(jnp.asarray(x), jlayer, act_int8=True))
    off = np.asarray(jqwen._dense(jnp.asarray(x), jlayer))
    got = dense_from_jax(layer)(torch.from_numpy(x), act_int8=True)
    _close_of_max(got.numpy(), want, DENSE_TOL)
    # The JAX side took its a8 branch: it differs from act_int8=False by far
    # more than the tolerance.
    assert np.abs(want - off).max() > 100 * DENSE_TOL * np.abs(want).max()
    # The codes the port fed its kernel are the reference's.
    x2 = x.reshape(-1, in_dim)
    if "perm4" in layer:
        x2 = x2[:, layer["perm4"]]
    np.testing.assert_array_equal(tqwen.quantize_acts(torch.from_numpy(x2))[0].numpy(),
                                  np.asarray(jqwen._quantize_acts(jnp.asarray(x2))[0]))


@pytest.mark.parametrize("qwen3", [False, True], ids=["qwen2", "qwen3"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_torch_qwen_forward_act_int8_matches_jax(interpret, qwen3, fused):
    cfg = _config(qwen3)
    jlcfg = _config(qwen3, jconfig).llm
    params = _llm_params(qwen3, fused, int4=True, seed=5)
    embeds, positions, seq_lens = _inputs(cfg, seed=6)
    kv_valid = positions < seq_lens[:, None]
    args = (jnp.asarray(embeds), jnp.asarray(positions))
    want, _ = jqwen.forward(params, jlcfg, *args, kv_valid=jnp.asarray(kv_valid),
                            attn_impl="xla", act_int8=True)
    off, _ = jqwen.forward(params, jlcfg, *args, kv_valid=jnp.asarray(kv_valid),
                           attn_impl="xla")
    want, off = np.asarray(want), np.asarray(off)
    model = qwen_from_jax(params, cfg.llm)
    got, _ = model(torch.from_numpy(embeds), torch.from_numpy(positions),
                   kv_valid=torch.from_numpy(kv_valid), act_int8=True)
    _close_of_max(got.numpy(), want, FORWARD_TOL_OF_MAX)
    assert np.abs(want - off).max() > 5 * FORWARD_TOL_OF_MAX * np.abs(want).max()


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_torch_greedy_generate_act_int8_matches_jax(interpret, monkeypatch):
    cfg = _engine_config()
    params = _engine_params(int4=True, seed=1)
    jax_a8 = _count_calls(monkeypatch, ji4, "int4_matmul_a8")
    port_a8 = _count_calls(monkeypatch, tqwen, "int4_matmul_a8")
    jax_engine = JaxEngine(params, _engine_config(jconfig), cache_dtype=jnp.float32,
                           attn_impl="xla", decode_recent_kv=False, decode_chunk=4,
                           prefill_act_int8=True)
    port = InferenceEngine(jax.tree.map(np.asarray, params), cfg, device="cpu",
                           cache_dtype=torch.float32, decode_chunk=4, prefill_act_int8=True)
    want = jax_engine.generate(_batch(jprocessor, jconfig),
                               jconfig.GenerationConfig(max_new_tokens=10, greedy=True))
    assert jax_a8, "the JAX engine did not take its a8 kernel"
    n_before = len(port_a8)
    got = port.generate(_batch(), GenerationConfig(max_new_tokens=10, greedy=True))
    # Prefill only: one a8 matmul per int4 projection of each layer
    # (qkv, o, gate_up, down); decode and the head take none.
    assert len(port_a8) - n_before == 4 * cfg.llm.num_hidden_layers
    assert got.token_ids == want.token_ids
    assert all(len(t) == 10 for t in got.token_ids)


# Serving: the port's ServeEngine with prefill_act_int8 against the port's
# batch engine, each request alone.
RUNNER = ("runner <ts><ts/> keeps decoding", [np.arange(12.0)], 60)
WAVE = [(f"wave {i} <ts><ts/> joins", [np.arange(8.0) + i], 5 + i) for i in range(3)]


@pytest.fixture(scope="module")
def a8_serving():
    cfg = _engine_config()
    params = jax.tree.map(np.asarray, _engine_params(int4=True, seed=2))
    proc = ChatTSProcessor(FakeTokenizer(), cfg)
    engine = InferenceEngine(params, cfg, device="cpu", cache_dtype=torch.float32,
                             prefill_act_int8=True)
    alone = {}
    for prompt, ts, n in [RUNNER] + WAVE:
        gen = GenerationConfig(max_new_tokens=n, greedy=True)
        alone[prompt] = engine.generate(proc([prompt], ts), gen).token_ids[0]
    return cfg, from_jax_params(params, cfg), proc, alone


def _serve_engine(a8_serving, **kw):
    cfg, model, proc, _ = a8_serving
    kw = {"max_batch_size": 4, "max_model_len": 512, **kw}
    return ServeEngine(model, cfg, proc, device="cpu", cache_dtype=torch.float32,
                       decode_chunk=4, prefill_act_int8=True, **kw)


def _spec_req(spec):
    prompt, ts, n = spec
    return Request(prompt, ts, SamplingParams(max_tokens=n, temperature=0.0))


@pytest.mark.parametrize("mode", ["mono", "block", "block_early_emit"])
def test_torch_serve_act_int8_matches_batch_engine(a8_serving, monkeypatch, mode):
    alone = a8_serving[3]
    calls = _count_calls(monkeypatch, tqwen, "int4_matmul_a8")
    runner, wave = _spec_req(RUNNER), [_spec_req(w) for w in WAVE]
    with _serve_engine(a8_serving, block_early_emit=mode == "block_early_emit") as eng:
        if mode == "mono":
            eng.waiting.requeue([runner] + wave)
            eng._wake.set()
        else:
            eng.submit(runner)
            wait_first_token(runner)
            eng.waiting.requeue(wave)
            eng._wake.set()
        wait([runner] + wave)
        stats = eng.stats()
    for r in [runner] + wave:
        assert r.error is None, r.error
        assert r.output_tokens == alone[r.prompt], r.prompt
    kind = {"mono": "rounds_mono", "block": "rounds_block",
            "block_early_emit": "rounds_block_pre"}[mode]
    assert stats.get(kind, 0) >= 1, stats
    # Each admission's prompt block ran the four int4 projections of each
    # layer through the a8 matmul.
    admissions = stats.get("rounds_mono", 0) + stats.get(kind, 0) * (mode != "mono")
    assert len(calls) == 4 * a8_serving[0].llm.num_hidden_layers * admissions


def test_torch_serve_warmup_runs_act_int8(a8_serving, monkeypatch):
    calls = _count_calls(monkeypatch, tqwen, "int4_matmul_a8")
    with _serve_engine(a8_serving, max_batch_size=2, max_model_len=256) as eng:
        eng.warmup(prefill_buckets=(64,), series_per_request=1, series_len=16)
        stats = eng.stats()
    assert stats["rounds_mono"] >= 2 and stats["rounds_block"] >= 1
    assert len(calls) >= 4 * a8_serving[0].llm.num_hidden_layers * (stats["rounds_mono"] + 1)


def test_torch_act_int8_prefill_leaves_decode_alone(a8_serving, monkeypatch):
    """A decode step after an a8 prefill runs no a8 matmul, and the first
    token comes from the a8 prefill (it differs from the bf16-path prefill's
    hidden state)."""
    cfg, model, proc, _ = a8_serving
    calls = _count_calls(monkeypatch, tqwen, "int4_matmul_a8")
    batch = proc([RUNNER[0]], RUNNER[1])
    gen = GenerationConfig(max_new_tokens=3, greedy=True)
    InferenceEngine(model, cfg, device="cpu", cache_dtype=torch.float32).generate(batch, gen)
    assert calls == []
    InferenceEngine(model, cfg, device="cpu", cache_dtype=torch.float32,
                    prefill_act_int8=True).generate(batch, gen)
    assert len(calls) == 4 * cfg.llm.num_hidden_layers
