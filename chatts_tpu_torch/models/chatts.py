"""ChatTS = decoder + time-series patch encoder + embedding merge.  The
decoder is Qwen2/Qwen3 (``models/qwen.py``) or the DeepSeek-V3 block
(``models/moonlight.py``, a ``MoonlightConfig``), which share ``QwenModel``'s
methods.

Counterpart of ``chatts_tpu/models/chatts.py``.  The processor
(``chatts_tpu_torch/processor/processor.py``) computes on the host
where each (series, patch) embedding goes: ``scatter_seq``/``scatter_tok``,
with padded patch slots pointing out of bounds.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from chatts_tpu_torch.core.config import ChatTSConfig, MoonlightConfig
from chatts_tpu_torch.models import qwen
from chatts_tpu_torch.models.qwen import QwenModel, fuse_projections
from chatts_tpu_torch.models.ts_encoder import TSEncoder


def merge_embeddings(
    token_embeds: torch.Tensor,  # (B, T, H)
    patch_embeds: torch.Tensor,  # (N, Pmax, H)
    scatter_seq: torch.Tensor,  # (N, Pmax) int; out of bounds => dropped
    scatter_tok: torch.Tensor,  # (N, Pmax) int
) -> torch.Tensor:
    """Scatter patch embeddings into their placeholder token positions.

    The JAX reference drops out-of-bounds rows with ``mode="drop"``; an
    indexed write in PyTorch would raise on them instead, or on a CUDA tensor
    write out of bounds.  So every out-of-bounds (seq, tok) pair is routed to
    one scratch row past the end, which is cut off afterwards; the mask stays
    on the device, with no host sync."""
    b, t, h = token_embeds.shape
    seq = scatter_seq.reshape(-1).long()
    tok = scatter_tok.reshape(-1).long()
    # Negative indices count from the end, as in JAX indexing.
    seq = torch.where(seq < 0, seq + b, seq)
    tok = torch.where(tok < 0, tok + t, tok)
    keep = (seq >= 0) & (seq < b) & (tok >= 0) & (tok < t)
    rows = torch.where(keep, seq * t + tok, b * t)
    flat = torch.cat([token_embeds.reshape(b * t, h), token_embeds.new_zeros((1, h))])
    flat[rows] = patch_embeds.reshape(-1, h).to(token_embeds.dtype)
    return flat[: b * t].reshape(b, t, h)


class ChatTSModel(nn.Module):
    def __init__(self, cfg: ChatTSConfig, ts_encoder: TSEncoder, llm: QwenModel):
        super().__init__()
        self.cfg = cfg
        self.ts_encoder = ts_encoder
        self.llm = llm

    @property
    def mesh(self):
        """The mesh a tensor-parallel model is placed on, else None."""
        return self.llm.mesh

    def input_embeddings(
        self,
        input_ids: torch.Tensor,  # (B, T)
        ts_values: Optional[torch.Tensor] = None,  # (N, Lmax)
        ts_mask: Optional[torch.Tensor] = None,  # (N, Lmax)
        scatter_seq: Optional[torch.Tensor] = None,  # (N, Pmax)
        scatter_tok: Optional[torch.Tensor] = None,  # (N, Pmax)
    ) -> torch.Tensor:
        """Token embeddings with the TS patch embeddings merged in."""
        embeds = self.llm.embed(input_ids)
        if ts_values is not None and ts_values.shape[0] > 0:
            patch_embeds, _, _ = self.ts_encoder(ts_values, ts_mask)
            embeds = merge_embeddings(embeds, patch_embeds, scatter_seq, scatter_tok)
        return embeds

    def forward(
        self,
        input_ids: torch.Tensor,
        positions: torch.Tensor,
        *,
        ts_values=None,
        ts_mask=None,
        scatter_seq=None,
        scatter_tok=None,
        kv_caches: Optional[List[Tuple[torch.Tensor, ...]]] = None,
        write_pos=None,
        kv_valid=None,
        kv_positions=None,
        kv_lengths=None,
        act_int8: bool = False,
        attn_impl: str = "auto",
        remat: bool = False,
    ):
        """Merge-embed -> decoder.  Returns (hidden (B, T, H), caches).
        ``attn_impl`` and ``remat``: see ``QwenModel.forward``."""
        embeds = self.input_embeddings(input_ids, ts_values, ts_mask, scatter_seq, scatter_tok)
        return self.llm(
            embeds, positions, kv_caches=kv_caches, write_pos=write_pos,
            kv_valid=kv_valid, kv_positions=kv_positions, kv_lengths=kv_lengths,
            act_int8=act_int8, attn_impl=attn_impl, remat=remat,
        )

    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.llm.compute_logits(hidden)


def init_params(cfg: ChatTSConfig, generator: torch.Generator, device="cuda",
                dtype=None, *, mesh=None) -> ChatTSModel:
    """A random float ChatTS model, unfused: the port of
    ``chatts_tpu.models.chatts.init_params`` (the encoder in f32 from
    ``TSEncoder.reset_parameters``, then ``qwen.init_params``), drawn from
    ``generator`` on its own device and placed on ``device``.  With
    ``mesh``, this rank's shard (``qwen.init_params``), the encoder whole."""
    encoder = TSEncoder(cfg.ts, device=generator.device).reset_parameters(generator)
    if isinstance(cfg.llm, MoonlightConfig):
        if mesh is not None:
            raise NotImplementedError("a MoonlightConfig decoder on a mesh is not ported")
        from chatts_tpu_torch.models import moonlight

        llm = moonlight.init_params(cfg.llm, generator, device, dtype)
    else:
        llm = qwen.init_params(cfg.llm, generator, device, dtype, mesh=mesh)
    return ChatTSModel(cfg, encoder.to(device), llm)


def maybe_fuse(model: ChatTSModel) -> ChatTSModel:
    """Fuse qkv / gate_up projections of float weights, in place; a model
    already fused or quantized, or placed on a mesh (its projections are
    Megatron shards, as JAX keeps them unfused), is returned as it is.  A
    multi-head latent attention decoder fuses q with kv_a, and gate with up,
    float or int4 (``moonlight.fuse_projections``)."""
    attn = model.llm.layers[0].self_attn
    if hasattr(attn, "q_kv_a_proj"):
        from chatts_tpu_torch.models import moonlight

        moonlight.fuse_projections(model.llm)
        return model
    if model.mesh is not None or attn.qkv_proj is not None or attn.q_proj.kernel is None:
        return model
    fuse_projections(model.llm)
    return model
