"""Build the port's model from the JAX package's parameters.

``from_jax_params`` takes a JAX ChatTS param tree as nested dicts and lists of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns a
``ChatTSModel`` holding the same values.  Every layout the JAX package
produces is accepted: unfused (``init_params``), fused (``maybe_fuse``), int4
and int8 (``quantize_params``, ``init_quantized_params``, both ``bits``),
Qwen2 qkv bias, Qwen3 ``q_norm``/``k_norm``, and a tied, separate or
quantized lm_head.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from chatts_tpu_torch.core.config import ChatTSConfig, QwenConfig, TSEncoderConfig
from chatts_tpu_torch.models.chatts import ChatTSModel
from chatts_tpu_torch.models.qwen import (
    MLP,
    Attention,
    DecoderLayer,
    Dense,
    QwenModel,
    to_tensor,
)
from chatts_tpu_torch.models.ts_encoder import TSEncoder


def _opt(tree: Mapping[str, Any], key: str, device) -> Optional[torch.Tensor]:
    return to_tensor(tree[key], device) if key in tree else None


def dense_from_jax(layer: Mapping[str, Any], device=None) -> Dense:
    bias = _opt(layer, "bias", device)
    if "kernel_q" in layer:
        return Dense(kernel_q=to_tensor(layer["kernel_q"], device),
                     scales=to_tensor(layer["scales"], device), bias=bias)
    if "kernel_q4" in layer:
        return Dense(
            kernel_q4=to_tensor(layer["kernel_q4"], device),
            scales4=to_tensor(layer["scales4"], device),
            zeros4=_opt(layer, "zeros4", device),
            perm4=_opt(layer, "perm4", device),
            bias=bias,
        )
    return Dense(to_tensor(layer["kernel"], device), bias=bias)


def _projections(group: Mapping[str, Any], names, device):
    return {name: dense_from_jax(group[name], device) for name in names if name in group}


def qwen_from_jax(llm: Mapping[str, Any], cfg: QwenConfig, device=None) -> QwenModel:
    """The decoder from the JAX package's ``params["llm"]`` tree."""
    layers = []
    for lp in llm["layers"]:
        attn = lp["self_attn"]
        mlp = lp["mlp"]
        layers.append(DecoderLayer(
            cfg,
            Attention(
                cfg, dense_from_jax(attn["o_proj"], device),
                **_projections(attn, ("qkv_proj", "q_proj", "k_proj", "v_proj"), device),
                q_norm=_opt(attn, "q_norm", device),
                k_norm=_opt(attn, "k_norm", device),
            ),
            MLP(dense_from_jax(mlp["down_proj"], device),
                **_projections(mlp, ("gate_up_proj", "gate_proj", "up_proj"), device)),
            to_tensor(lp["input_layernorm"], device),
            to_tensor(lp["post_attention_layernorm"], device),
        ))
    return QwenModel(
        cfg, to_tensor(llm["embed_tokens"], device), layers, to_tensor(llm["norm"], device),
        lm_head=_opt(llm, "lm_head", device),
        lm_head_q=dense_from_jax(llm["lm_head_q"], device) if "lm_head_q" in llm else None,
    )


def ts_encoder_from_jax(tree: Mapping[str, Any], cfg: TSEncoderConfig,
                        device=None) -> TSEncoder:
    """The encoder from the JAX package's ``params["ts_encoder"]`` tree."""
    encoder = TSEncoder(cfg, device=device)
    with torch.no_grad():
        for i, layer in enumerate(tree["mlp"]):
            encoder.kernels[i].copy_(to_tensor(layer["kernel"], device))
            encoder.biases[i].copy_(to_tensor(layer["bias"], device))
        if encoder.position_embedding is not None:
            encoder.position_embedding.copy_(to_tensor(tree["position_embedding"], device))
    return encoder


def from_jax_params(tree: Mapping[str, Any], cfg: ChatTSConfig, device=None) -> ChatTSModel:
    return ChatTSModel(
        cfg,
        ts_encoder_from_jax(tree["ts_encoder"], cfg.ts, device),
        qwen_from_jax(tree["llm"], cfg.llm, device),
    )
