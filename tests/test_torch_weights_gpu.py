"""The checkpoint loader and the GPTQ import on the card, against the same
on the CPU. Marked ``gpu``; each test skips where there is no CUDA card.
This file imports no JAX, so on a machine without it run it without the
repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_weights_gpu.py

- ``to_native_int4`` converts on the card to the CPU's bytes (so to the JAX
  package's: ``tests/test_torch_gptq.py``).
- ``load_checkpoint(device="cuda")`` gives every tensor of the CPU's load to
  the bit, the head's int4 codes and scales among them (the quantizers
  divide by tensors, so the card rounds as the CPU does).
- The loaded projections of a symmetric, an asymmetric and an
  activation-order export run the card's int4 kernels, and ``perm4`` and
  ``zeros4`` around them, within |got - ref| <= 2e-2 + 2e-2 |ref| of the
  CPU's plain path in bf16, weight-only and with ``act_int8``: the outputs
  round to bf16 (one ulp apart at worst) and the plain int4 matmul rounds
  each dequantized weight to bf16 where the kernel keeps it exact.
"""
import numpy as np
import pytest
import torch

from chatts_tpu_torch.models import gptq, weights
from chatts_tpu_torch.ops import int4_matmul as i4
from chatts_tpu_torch.scripts import rehearse_real_checkpoint as rehearsal

pytestmark = pytest.mark.gpu

ATOL = 2e-2
RTOL = 2e-2
STYLES = {"sym": {}, "asym": {"asym": True}, "desc_act": {"desc_act": True}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(params=list(STYLES))
def ckpt(request, tmp_path):
    rehearsal.synthesize(str(tmp_path), shape="tiny", device="cpu", seed=4,
                         log=lambda _: None, **STYLES[request.param])
    return request.param, str(tmp_path)


def _state(model):
    out = dict(model.named_parameters())
    out.update(dict(model.named_buffers()))
    return out


def test_torch_to_native_int4_on_the_card(cuda, ckpt):
    style, path = ckpt
    with weights.LazyStateDict(path) as sd:
        for name in ("model.layers.0.self_attn.q_proj", "model.layers.1.mlp.down_proj"):
            cpu = gptq.to_native_int4(sd, name, "cpu")
            card = gptq.to_native_int4(sd, name, cuda)
            assert set(card) == set(cpu)
            assert ("zeros4" in card) == (style == "asym") and ("perm4" in card) == (style == "desc_act")
            for key, t in cpu.items():
                assert card[key].device.type == "cuda" and card[key].dtype == t.dtype
                assert torch.equal(card[key].cpu(), t), (name, key)


@pytest.mark.parametrize("bits", [4, 8])
def test_torch_load_checkpoint_on_the_card_equals_the_cpu(cuda, ckpt, bits):
    _, path = ckpt
    _, cpu = weights.load_checkpoint(path, device="cpu", quantize_bits=bits)
    _, card = weights.load_checkpoint(path, device=cuda, quantize_bits=bits)
    a, b = _state(card), _state(cpu)
    assert set(a) == set(b)
    for name, t in b.items():
        assert a[name].device.type == "cuda" and torch.equal(a[name].cpu(), t), name
    head = card.llm.lm_head_q
    assert (head.kernel_q4 if bits == 4 else head.kernel_q) is not None


@pytest.mark.parametrize("rows", [5, 70])
@pytest.mark.parametrize("act_int8", [False, True], ids=["bf16", "act_int8"])
def test_torch_loaded_projections_on_the_card(cuda, ckpt, rows, act_int8):
    style, path = ckpt
    _, cpu = weights.load_checkpoint(path, device="cpu", quantize_bits=4)
    _, card = weights.load_checkpoint(path, device=cuda, quantize_bits=4)
    gen = torch.Generator().manual_seed(rows)
    i4.int4_matmul.launches = i4.int4_matmul_a8.launches = 0
    for layer_cpu, layer_card in zip(cpu.llm.layers, card.llm.layers):
        for group in ("self_attn", "mlp"):
            for proj in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                         "down_proj"):
                d_cpu = getattr(getattr(layer_cpu, group), proj, None)
                if d_cpu is None:
                    continue
                d_card = getattr(getattr(layer_card, group), proj)
                assert (d_card.zeros4 is not None) == (style == "asym")
                assert (d_card.perm4 is not None) == (style == "desc_act")
                x = torch.randn((rows, d_cpu.in_features), generator=gen).to(torch.bfloat16)
                want = d_cpu(x, act_int8).float()
                got = d_card(x.to(cuda), act_int8).float().cpu()
                assert torch.isfinite(got).all()
                err = (got - want).abs()
                assert (err <= ATOL + RTOL * want.abs()).all(), (proj, float(err.max()))
    launched = i4.int4_matmul_a8.launches if act_int8 else i4.int4_matmul.launches
    assert launched == 7 * len(card.llm.layers)


def test_torch_rehearsal_on_the_card(cuda, tmp_path):
    """The tiny rehearsal end to end on the card: diagnose, load, greedy
    tokens twice."""
    rehearsal.synthesize(str(tmp_path), shape="tiny", device=cuda, log=lambda _: None)
    tokens = rehearsal.rehearse(str(tmp_path), device=cuda, log=lambda _: None)
    assert len(tokens[0]) == 4 and all(0 <= t < 1024 for t in tokens[0])
    assert np.isfinite(np.asarray(tokens)).all()
