"""Typed configuration objects of the port: the port's own copy of
``chatts_tpu/core/config.py``, field for field, so that the port loads
nothing of the JAX package.

The reference scatters configuration across an untyped ``config.ts`` dict read
from the HF checkpoint (reference: chatts/vllm/chatts_vllm.py:61-91), ad-hoc
YAML reads at import time, and ALL_CAPS constants.  Here everything is a frozen
dataclass loaded once: hashable and self-documenting.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping, Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class TSEncoderConfig:
    """Config of the time-series patch encoder.

    Field semantics mirror the checkpoint's ``config.ts`` dict
    (reference: chatts/vllm/chatts_vllm.py:64-79): ``patch_size`` points per
    patch, ``num_layers`` MLP layers, ``hidden_size`` = LLM hidden size,
    ``num_features`` = channels of the encoded array (2: value + valid flag),
    ``max_sequence_length`` caps series length, and the two position-encoding
    variants are mutually exclusive.
    """

    patch_size: int = 16
    num_layers: int = 5
    hidden_size: int = 3584
    num_features: int = 2
    max_sequence_length: int = 4096
    use_position_embedding: bool = False
    use_position_idx: bool = False
    embedding_dim: int = 16  # per-point position embedding dim

    @property
    def padding_idx(self) -> int:
        # Position-embedding vocab is [0, max_sequence_length) for real
        # positions plus one trailing padding slot
        # (reference: chatts/vllm/chatts_vllm.py:73-76).
        return self.max_sequence_length

    @property
    def mlp_input_size(self) -> int:
        if self.use_position_embedding:
            return self.patch_size + self.embedding_dim * self.patch_size
        if self.use_position_idx:
            return 2 * self.patch_size
        return self.patch_size

    @property
    def max_patches(self) -> int:
        return -(-self.max_sequence_length // self.patch_size)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TSEncoderConfig":
        # Older checkpoints name the length cap ``max_length``
        # (reference: chatts/vllm/chatts_vllm.py:245).
        max_len = d.get("max_sequence_length", d.get("max_length", 4096))
        return cls(
            patch_size=int(d["patch_size"]),
            num_layers=int(d["num_layers"]),
            hidden_size=int(d["hidden_size"]),
            num_features=int(d.get("num_features", 2)),
            max_sequence_length=int(max_len),
            use_position_embedding=bool(d.get("use_position_embedding", False)),
            use_position_idx=bool(d.get("use_position_idx", False)),
            embedding_dim=int(d.get("embedding_dim", 16)),
        )


@dataclasses.dataclass(frozen=True)
class QwenConfig:
    """Decoder config covering the Qwen2 and Qwen3 dense families.

    ``qk_norm`` (per-head RMSNorm on q/k) and bias-free attention projections
    distinguish Qwen3 from Qwen2 (which uses qkv biases and no qk-norm).
    """

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False
    attention_bias: bool = True  # Qwen2: qkv bias; Qwen3: False
    qk_norm: bool = False  # Qwen3: True
    dtype: str = "bfloat16"

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @classmethod
    def from_hf_dict(cls, d: Mapping[str, Any]) -> "QwenConfig":
        arch = (d.get("architectures") or [""])[0]
        is_qwen3 = "Qwen3" in arch or d.get("model_type", "") in (
            "qwen3",
            "qwen3_ts",
        )
        hidden = int(d["hidden_size"])
        heads = int(d["num_attention_heads"])
        return cls(
            vocab_size=int(d["vocab_size"]),
            hidden_size=hidden,
            intermediate_size=int(d["intermediate_size"]),
            num_hidden_layers=int(d["num_hidden_layers"]),
            num_attention_heads=heads,
            num_key_value_heads=int(d.get("num_key_value_heads", heads)),
            head_dim=int(d.get("head_dim", hidden // heads)),
            rms_norm_eps=float(d.get("rms_norm_eps", 1e-6)),
            rope_theta=float(d.get("rope_theta", 1e6)),
            max_position_embeddings=int(d.get("max_position_embeddings", 32768)),
            tie_word_embeddings=bool(d.get("tie_word_embeddings", False)),
            attention_bias=not is_qwen3,
            qk_norm=is_qwen3,
        )


@dataclasses.dataclass(frozen=True)
class MoonlightConfig:
    """Decoder config of the DeepSeek-V3 block (``model_type``
    ``deepseek_v3``) at Moonlight-16B-A3B's widths by default: multi-head
    latent attention (MLA) without a q LoRA, and sparse experts.

    - Attention: q is one ``hidden -> heads * (nope + rope)`` projection;
      ``kv_a`` maps ``hidden -> kv_lora_rank + rope``, a latent ``c_kv``
      (RMSNorm'd) and one rope key shared by the heads; ``kv_b`` maps the
      latent to each head's ``nope`` key and ``v_head_dim`` value.  The
      softmax scale is ``(nope + rope) ** -0.5`` (no rope scaling).
    - Feed-forward: the first ``first_k_dense_replace`` layers are a dense
      SiLU MLP of ``intermediate_size``; every later layer routes each token
      to ``num_experts_per_tok`` of ``n_routed_experts`` experts of
      ``moe_intermediate_size`` (sigmoid scores, top-k on score + bias,
      weights normalised and scaled by ``routed_scaling_factor``) and adds
      ``n_shared_experts`` shared experts, which act as one MLP of
      ``n_shared_experts * moe_intermediate_size``.
    """

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def head_dim(self) -> int:
        """The rope width, as ``transformers``' ``DeepseekV3Config.head_dim``:
        the width of the cos/sin tables."""
        return self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Width of a latent cache row: the normed ``c_kv`` and the roped key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @classmethod
    def from_hf_dict(cls, d: Mapping[str, Any]) -> "MoonlightConfig":
        if d.get("q_lora_rank") is not None:
            raise NotImplementedError("a q LoRA (q_lora_rank) is not ported")
        if int(d.get("n_group", 1)) != 1 or int(d.get("topk_group", 1)) != 1:
            raise NotImplementedError("group-limited routing (n_group > 1) is not ported")
        if d.get("rope_scaling"):
            raise NotImplementedError("rope scaling is not ported")
        if d.get("moe_layer_freq", 1) != 1:
            raise NotImplementedError("moe_layer_freq other than 1 is not ported")
        return cls(
            vocab_size=int(d["vocab_size"]),
            hidden_size=int(d["hidden_size"]),
            intermediate_size=int(d["intermediate_size"]),
            moe_intermediate_size=int(d["moe_intermediate_size"]),
            num_hidden_layers=int(d["num_hidden_layers"]),
            num_attention_heads=int(d["num_attention_heads"]),
            kv_lora_rank=int(d["kv_lora_rank"]),
            qk_nope_head_dim=int(d["qk_nope_head_dim"]),
            qk_rope_head_dim=int(d["qk_rope_head_dim"]),
            v_head_dim=int(d["v_head_dim"]),
            n_routed_experts=int(d["n_routed_experts"]),
            n_shared_experts=int(d.get("n_shared_experts") or 0),
            num_experts_per_tok=int(d["num_experts_per_tok"]),
            first_k_dense_replace=int(d.get("first_k_dense_replace", 0)),
            routed_scaling_factor=float(d.get("routed_scaling_factor", 1.0)),
            norm_topk_prob=bool(d.get("norm_topk_prob", True)),
            rms_norm_eps=float(d.get("rms_norm_eps", 1e-6)),
            rope_theta=float(d.get("rope_theta", 10000.0)),
            max_position_embeddings=int(d.get("max_position_embeddings", 4096)),
            tie_word_embeddings=bool(d.get("tie_word_embeddings", False)),
        )


DecoderConfig = Union[QwenConfig, MoonlightConfig]


def decoder_config_from_hf_dict(d: Mapping[str, Any]) -> DecoderConfig:
    """The decoder config a checkpoint's ``config.json`` describes:
    ``MoonlightConfig`` for ``model_type`` ``deepseek_v3``, else Qwen."""
    if d.get("model_type") == "deepseek_v3":
        return MoonlightConfig.from_hf_dict(d)
    return QwenConfig.from_hf_dict(d)


@dataclasses.dataclass(frozen=True)
class ChatTSConfig:
    """Full model config: decoder + TS encoder + multimodal token contract."""

    llm: DecoderConfig = dataclasses.field(default_factory=QwenConfig)
    ts: TSEncoderConfig = dataclasses.field(default_factory=TSEncoderConfig)
    # Token id of <ts>; <ts/> is ts_token_start_index + 1
    # (reference: chatts/vllm/chatts_vllm.py:376,441).
    ts_token_start_index: int = 151666
    max_timeseries_per_prompt: int = 50  # reference: chatts_vllm.py:220

    @property
    def ts_end_token_index(self) -> int:
        return self.ts_token_start_index + 1

    @classmethod
    def from_hf_dict(cls, d: Mapping[str, Any]) -> "ChatTSConfig":
        return cls(
            llm=decoder_config_from_hf_dict(d),
            ts=TSEncoderConfig.from_dict(d.get("ts", {})),
            ts_token_start_index=int(d.get("ts_token_start_index", 151666)),
        )

    @classmethod
    def from_pretrained(cls, path: str) -> "ChatTSConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_hf_dict(json.load(f))


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 512
    temperature: float = 0.2  # reference eval default: inference_tsmllm_vllm.py:43-46
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    greedy: bool = False
    eos_token_ids: Tuple[int, ...] = ()


def tiny_config(
    *,
    vocab_size: int = 512,
    hidden_size: int = 64,
    intermediate_size: int = 128,
    num_hidden_layers: int = 2,
    num_attention_heads: int = 4,
    num_key_value_heads: int = 2,
    head_dim: Optional[int] = None,
    patch_size: int = 4,
    ts_num_layers: int = 2,
    max_sequence_length: int = 64,
    ts_token_start_index: int = 500,
    qwen3: bool = False,
    use_position_embedding: bool = False,
    use_position_idx: bool = False,
) -> ChatTSConfig:
    """A tiny-random ChatTS config for tests and compile checks."""
    return ChatTSConfig(
        llm=QwenConfig(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=intermediate_size,
            num_hidden_layers=num_hidden_layers,
            num_attention_heads=num_attention_heads,
            num_key_value_heads=num_key_value_heads,
            head_dim=head_dim or hidden_size // num_attention_heads,
            rope_theta=1e4,
            attention_bias=not qwen3,
            qk_norm=qwen3,
        ),
        ts=TSEncoderConfig(
            patch_size=patch_size,
            num_layers=ts_num_layers,
            hidden_size=hidden_size,
            max_sequence_length=max_sequence_length,
            use_position_embedding=use_position_embedding,
            use_position_idx=use_position_idx,
            embedding_dim=8,
        ),
        ts_token_start_index=ts_token_start_index,
    )
