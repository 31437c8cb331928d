"""TS encoder: the port against JAX ``ts_encoder.forward``, all three variants.

Tolerance: f32 on both sides (the JAX encoder pins HIGHEST precision); the
two frameworks sum the matmuls in different orders, so rtol 1e-5 with an
atol of 1e-5 for entries near zero."""
import jax
import numpy as np
import pytest
import torch

from chatts_tpu.core import config as jconfig
from chatts_tpu.models import ts_encoder as jts
from chatts_tpu_torch.core import config as tconfig
from chatts_tpu_torch.models import ts_encoder as tts
from chatts_tpu_torch.models.convert import ts_encoder_from_jax

RTOL = 1e-5
ATOL = 1e-5

VARIANTS = {
    "plain": {},
    "position_embedding": {"use_position_embedding": True},
    "position_idx": {"use_position_idx": True},
}


def _inputs(seed, n=5, lmax=32):
    rng = np.random.default_rng(seed)
    values = rng.normal(0, 3, (n, lmax)).astype(np.float32)
    # Ragged lengths, a full row and an empty (padded-slot) row.
    lengths = [lmax, 13, 1, 0, 20][:n]
    mask = (np.arange(lmax)[None] < np.asarray(lengths)[:, None]).astype(np.float32)
    return values, mask


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_torch_ts_encoder_matches_jax(variant):
    kw = dict(patch_size=4, num_layers=3, hidden_size=48, max_sequence_length=64,
              embedding_dim=8, **VARIANTS[variant])
    jcfg, cfg = jconfig.TSEncoderConfig(**kw), tconfig.TSEncoderConfig(**kw)
    params = jts.init_params(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    # Non-zero biases so the bias path is exercised.
    for layer in params["mlp"]:
        layer["bias"] = rng.normal(0, 0.1, layer["bias"].shape).astype(np.float32)
    values, mask = _inputs(5)

    want, want_cnt, want_mask = jts.forward(params, values, mask, jcfg)
    encoder = ts_encoder_from_jax(jax.tree.map(np.asarray, params), cfg)
    got, got_cnt, got_mask = encoder(torch.from_numpy(values), torch.from_numpy(mask))

    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


def test_torch_pad_with_last_value_matches_jax():
    values, mask = _inputs(6)
    lengths = mask.sum(1).astype(np.int32)
    want = jts.pad_with_last_value(values, lengths)
    got = tts.pad_with_last_value(torch.from_numpy(values), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_torch_ts_encoder_restores_tf32_flags():
    cfg = tconfig.TSEncoderConfig(patch_size=4, num_layers=2, hidden_size=16,
                                  max_sequence_length=16)
    encoder = tts.TSEncoder(cfg).reset_parameters(torch.Generator().manual_seed(0))
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    values, mask = _inputs(7, n=2, lmax=16)
    out, _, _ = encoder(torch.from_numpy(values), torch.from_numpy(mask))
    assert torch.isfinite(out).all()
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
