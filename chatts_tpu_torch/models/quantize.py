"""Weight-only int8 and int4 quantization.

Counterpart of ``chatts_tpu/models/quantize.py``, with its two tiers:
- int8: ``kernel_q`` (in, out) int8 plus per-column ``scales`` (out,) f32,
  W = kernel_q * scales;
- int4: the packed (in/2, out) int8 nibbles plus (in/128, out) f32 group
  scales of ``ops/int4_matmul.py``.  A projection whose shape does not tile
  for the int4 kernel (IN or OUT not a multiple of 128) falls back to int8,
  as in the reference.
"""
from __future__ import annotations

import math

import torch

from chatts_tpu_torch.core.config import ChatTSConfig
from chatts_tpu_torch.models.chatts import ChatTSModel
from chatts_tpu_torch.models.qwen import MLP, Attention, DecoderLayer, Dense, QwenModel
from chatts_tpu_torch.models.ts_encoder import TSEncoder
from chatts_tpu_torch.ops.int4_matmul import DEFAULT_GROUP, pack_int4
from chatts_tpu_torch.parallel.mesh import max_tp

QUANT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "qkv_proj",
    "gate_proj", "up_proj", "down_proj", "gate_up_proj",
)


def _check_bits(bits: int) -> None:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")


def _int4_tiles(in_dim: int, out_dim: int) -> bool:
    """Whether the int4 kernels take a projection of this shape (the
    reference's ``int4_matmul.supported``)."""
    return in_dim % DEFAULT_GROUP == 0 and out_dim % 128 == 0


def quantize_dense(dense: Dense, mesh=None) -> Dense:
    """A float Dense -> an int8 Dense with the same bias: per-column scales
    max |W| / 127 (1 for an all-zero column), codes rounded half to even.
    With ``mesh`` the kernel is this rank's rows of a row-parallel layer and
    a column's maximum is taken over the whole column, so the codes and
    scales are the whole layer's."""
    kernel = dense.kernel.float()
    amax = max_tp(mesh, kernel.abs().amax(dim=0))
    scales = amax / torch.full_like(amax, 127.0)  # IEEE division on the card too
    scales = torch.where(scales == 0, 1.0, scales)
    q = torch.clamp(torch.round(kernel / scales), -127, 127).to(torch.int8)
    return Dense(kernel_q=q, scales=scales, bias=dense.bias)


def dequantize_dense(dense: Dense, dtype=torch.bfloat16) -> Dense:
    """An int8 Dense -> a float Dense holding kernel_q * scales in ``dtype``."""
    kernel = (dense.kernel_q.float() * dense.scales[None, :]).to(dtype)
    return Dense(kernel.contiguous(), bias=dense.bias)


def quantize_dense_int4(dense: Dense, group_size: int = DEFAULT_GROUP) -> Dense:
    """A float Dense -> an int4 Dense with the same bias, or an int8 one
    where the shape does not tile for the int4 kernels."""
    if not _int4_tiles(dense.in_features, dense.out_features):
        return quantize_dense(dense)
    packed, scales = pack_int4(dense.kernel, group_size)
    return Dense(kernel_q4=packed, scales4=scales, bias=dense.bias)


@torch.no_grad()
def quantize_llm(llm: QwenModel, quantize_lm_head: bool = True, bits: int = 4) -> QwenModel:
    """Quantize every decoder projection (norms and embeddings stay), and the
    separate lm_head into ``lm_head_q``, in place: bits=8 per-column int8,
    bits=4 group-128 int4."""
    _check_bits(bits)
    qfn = quantize_dense_int4 if bits == 4 else quantize_dense
    for layer in llm.layers:
        for group in (layer.self_attn, layer.mlp):
            for name in QUANT_TARGETS:
                sub = getattr(group, name, None)
                if isinstance(sub, Dense) and sub.kernel is not None:
                    setattr(group, name, qfn(sub))
    if quantize_lm_head and llm.lm_head is not None:
        llm.lm_head_q = qfn(Dense(llm.lm_head))
        llm.lm_head = None
    return llm


@torch.no_grad()
def init_quantized_params(cfg: ChatTSConfig, generator: torch.Generator, device,
                          bits: int = 4, fused: bool = True) -> ChatTSModel:
    """A random ChatTS model built directly in the quantized layout on
    ``device``, with no bf16 intermediate, as
    ``chatts_tpu.models.quantize.init_quantized_params`` builds it: int4
    projections are random packed bytes with scales 1 / (7 sqrt(in)); int8
    ones (bits=8, or a shape that does not tile for int4) random codes in
    [-127, 127] with scales 1 / (127 sqrt(in)).  For capacity and speed runs
    at real widths; ``generator`` lives on ``device``."""
    _check_bits(bits)
    lcfg = cfg.llm
    h, kvh, d, hid = (lcfg.num_attention_heads, lcfg.num_key_value_heads,
                      lcfg.head_dim, lcfg.hidden_size)
    bf16 = torch.bfloat16

    def rand_int8(shape) -> torch.Tensor:
        return torch.randint(-128, 128, shape, generator=generator, device=device,
                             dtype=torch.int8)

    def qdense(fan_in: int, fan_out: int, bias: bool) -> Dense:
        b = torch.zeros(fan_out, dtype=bf16, device=device) if bias else None
        if bits == 4 and _int4_tiles(fan_in, fan_out):
            return Dense(kernel_q4=rand_int8((fan_in // 2, fan_out)),
                         scales4=torch.full((fan_in // DEFAULT_GROUP, fan_out),
                                            1.0 / (7 * math.sqrt(fan_in)), device=device),
                         bias=b)
        return Dense(kernel_q=torch.clamp(rand_int8((fan_in, fan_out)), min=-127),
                     scales=torch.full((fan_out,), 1.0 / (127 * math.sqrt(fan_in)),
                                       device=device),
                     bias=b)

    def ones(n: int) -> torch.Tensor:
        return torch.ones(n, dtype=bf16, device=device)

    layers = []
    for _ in range(lcfg.num_hidden_layers):
        if fused:
            projs = {"qkv_proj": qdense(hid, (h + 2 * kvh) * d, lcfg.attention_bias)}
            mlps = {"gate_up_proj": qdense(hid, 2 * lcfg.intermediate_size, False)}
        else:
            projs = {"q_proj": qdense(hid, h * d, lcfg.attention_bias),
                     "k_proj": qdense(hid, kvh * d, lcfg.attention_bias),
                     "v_proj": qdense(hid, kvh * d, lcfg.attention_bias)}
            mlps = {"gate_proj": qdense(hid, lcfg.intermediate_size, False),
                    "up_proj": qdense(hid, lcfg.intermediate_size, False)}
        norms = {"q_norm": ones(d), "k_norm": ones(d)} if lcfg.qk_norm else {}
        layers.append(DecoderLayer(
            lcfg,
            Attention(lcfg, qdense(h * d, hid, False), **projs, **norms),
            MLP(qdense(lcfg.intermediate_size, hid, False), **mlps),
            ones(hid), ones(hid),
        ))
    embed = torch.randn((lcfg.vocab_size, hid), generator=generator, device=device,
                        dtype=bf16) * 0.02
    llm = QwenModel(lcfg, embed, layers, ones(hid),
                    lm_head_q=qdense(hid, lcfg.vocab_size, False))
    encoder = TSEncoder(cfg.ts, device=device).reset_parameters(generator)
    return ChatTSModel(cfg, encoder, llm)
