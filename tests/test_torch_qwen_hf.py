"""The port's decoder loaded from HF transformers' own tiny-random Qwen2 and
Qwen3 models (``models/qwen.py::load_torch_state_dict``), against
transformers' logits: within rtol = atol = 2e-4, the tolerance of the JAX
package's golden test (``tests/test_qwen_parity.py``, whose model constructors this
reuses), f32 on both sides. The state dict is taken both as torch tensors
and as numpy arrays. The TS encoder's loader is held to the JAX package's
to the bit. Skips without ``transformers``."""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from chatts_tpu.core.config import TSEncoderConfig as JaxTSConfig  # noqa: E402
from chatts_tpu.models import ts_encoder as jts  # noqa: E402
from chatts_tpu_torch.core.config import QwenConfig, TSEncoderConfig  # noqa: E402
from chatts_tpu_torch.models import qwen  # noqa: E402
from chatts_tpu_torch.models import ts_encoder  # noqa: E402
from tests.test_qwen_parity import build_hf_qwen2, build_hf_qwen3  # noqa: E402


@pytest.mark.parametrize("values", ["torch", "numpy"])
@pytest.mark.parametrize("family", ["qwen2", "qwen3"])
def test_torch_hf_logits_match_transformers(family, values):
    model, jcfg = build_hf_qwen2() if family == "qwen2" else build_hf_qwen3()
    cfg = QwenConfig(**dataclasses.asdict(jcfg))
    state = model.state_dict()
    if values == "numpy":
        state = {k: v.detach().numpy() for k, v in state.items()}
    llm = qwen.load_torch_state_dict(state, cfg, dtype=torch.float32)
    assert (llm.layers[0].self_attn.q_proj.bias is not None) == (family == "qwen2")
    assert (llm.layers[0].self_attn.q_norm is not None) == (family == "qwen3")

    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 12)))
    with torch.no_grad():
        want = model(ids).logits
        hidden, _ = llm(qwen.embed_tokens(llm.embed_tokens, ids),
                        torch.arange(12)[None].repeat(2, 1))
        got = llm.compute_logits(hidden)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("position", ["none", "embedding", "idx"])
def test_torch_ts_encoder_state_dict_equals_jax(position):
    kw = dict(patch_size=4, num_layers=3, hidden_size=32, max_sequence_length=64,
              use_position_embedding=position == "embedding",
              use_position_idx=position == "idx", embedding_dim=8)
    cfg = TSEncoderConfig(**kw)
    rng = np.random.default_rng(1)
    sizes = [cfg.mlp_input_size] + [cfg.hidden_size] * cfg.num_layers
    state = {}
    for i in range(cfg.num_layers):
        state[f"ts_encoder.mlp.{2 * i}.weight"] = rng.normal(size=(sizes[i + 1], sizes[i])).astype(np.float16)
        state[f"ts_encoder.mlp.{2 * i}.bias"] = rng.normal(size=(sizes[i + 1],)).astype(np.float32)
    if cfg.use_position_embedding:
        state["ts_encoder.position_embedding.weight"] = rng.normal(
            size=(cfg.max_sequence_length + 1, cfg.embedding_dim)).astype(np.float32)
    want = jts.load_torch_state_dict(state, JaxTSConfig(**kw))
    got = ts_encoder.load_torch_state_dict(state, cfg)
    for i, layer in enumerate(want["mlp"]):
        assert got.kernels[i].dtype == torch.float32
        np.testing.assert_array_equal(got.kernels[i].detach().numpy(), np.asarray(layer["kernel"]))
        np.testing.assert_array_equal(got.biases[i].detach().numpy(), np.asarray(layer["bias"]))
    if cfg.use_position_embedding:
        np.testing.assert_array_equal(got.position_embedding.detach().numpy(),
                                      np.asarray(want["position_embedding"]))
