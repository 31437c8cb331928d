"""Time-series patch encoder, f32.

Counterpart of ``chatts_tpu/models/ts_encoder.py``.  A batch of ragged series
is encoded in one masked pass with static shapes:

  (N, Lmax) values + (N, Lmax) valid mask
    -> pad-with-last-value
    -> (N, Pmax, patch_size) patches [+ position features]
    -> one MLP (exact GELU between layers) over all patches
    -> (N, Pmax, hidden) embeddings, (N,) patch counts, (N, Pmax) patch mask

The matmuls run in full f32: value-QA answers depend on the encoder's
precision, so TF32 is switched off around them (the reference pins
``Precision.HIGHEST``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from chatts_tpu_torch.core.config import TSEncoderConfig
from chatts_tpu_torch.models.qwen import state_tensor


@contextlib.contextmanager
def full_fp32_matmuls():
    """Turn TF32 off for matmuls and convolutions, restoring the flags after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def pad_with_last_value(values: torch.Tensor, valid_lengths: torch.Tensor) -> torch.Tensor:
    """Replace every position >= valid_length with the series' last valid value."""
    lmax = values.shape[1]
    idx = torch.arange(lmax, device=values.device)[None, :]
    last = torch.clamp(valid_lengths[:, None].long() - 1, min=0)
    return torch.gather(values, 1, torch.minimum(idx, last))


class TSEncoder(nn.Module):
    """The patch encoder.  Kernels are stored (in, out), as in the JAX package."""

    def __init__(self, cfg: TSEncoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        sizes = [cfg.mlp_input_size] + [cfg.hidden_size] * cfg.num_layers
        self.kernels = nn.ParameterList(
            nn.Parameter(torch.zeros(sizes[i], sizes[i + 1], device=device), requires_grad=False)
            for i in range(cfg.num_layers))
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(sizes[i + 1], device=device), requires_grad=False)
            for i in range(cfg.num_layers))
        self.position_embedding: Optional[nn.Parameter] = None
        if cfg.use_position_embedding:
            self.position_embedding = nn.Parameter(
                torch.zeros(cfg.max_sequence_length + 1, cfg.embedding_dim, device=device),
                requires_grad=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "TSEncoder":
        """Random init as ``chatts_tpu.models.ts_encoder.init_params``:
        normal / sqrt(fan_in) kernels, zero biases, normal * 0.02 positions."""
        for kernel, bias in zip(self.kernels, self.biases):
            kernel.copy_(torch.randn(kernel.shape, generator=generator, device=kernel.device)
                         / math.sqrt(kernel.shape[0]))
            bias.zero_()
        if self.position_embedding is not None:
            table = self.position_embedding
            table.copy_(torch.randn(table.shape, generator=generator, device=table.device) * 0.02)
        return self

    def forward(
        self, values: torch.Tensor, mask: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """values, mask (N, Lmax), Lmax a multiple of patch_size.

        Returns (embeddings (N, Pmax, hidden) f32 with junk rows where the
        patch is invalid, patch_cnt (N,) int32, patch_mask (N, Pmax) bool)."""
        cfg = self.cfg
        n, lmax = values.shape
        p = cfg.patch_size
        if lmax % p != 0:
            raise ValueError(f"Lmax={lmax} must be a multiple of patch_size={p}")
        pmax = lmax // p
        dev = values.device

        values = values.float()
        valid_lengths = mask.to(torch.int32).sum(dim=1)
        patch_cnt = (valid_lengths + p - 1) // p
        patch_mask = torch.arange(pmax, device=dev)[None, :] < patch_cnt[:, None]
        padded = pad_with_last_value(values, valid_lengths)
        patches = padded.reshape(n, pmax, p)
        real = torch.arange(lmax, device=dev)[None, :] < valid_lengths[:, None]

        if cfg.use_position_embedding:
            pos = torch.arange(lmax, device=dev)[None, :].expand(n, lmax)
            pos = torch.where(real, pos, cfg.padding_idx)
            pos_emb = self.position_embedding.float()[pos]  # (N, Lmax, emb)
            x = torch.cat([patches, pos_emb.reshape(n, pmax, p * cfg.embedding_dim)], dim=-1)
        elif cfg.use_position_idx:
            # Normalised by the batch-wide maximum valid length; padding is -1.
            pos = torch.arange(lmax, dtype=torch.float32, device=dev)[None, :]
            denom = torch.clamp(valid_lengths.max() - 1, min=1).float()
            pos = torch.where(real, pos / denom, -1.0)
            x = torch.stack([padded, pos], dim=-1).reshape(n, pmax, 2 * p)
        else:
            x = patches

        with full_fp32_matmuls():
            last = len(self.kernels) - 1
            for i, (kernel, bias) in enumerate(zip(self.kernels, self.biases)):
                x = torch.matmul(x, kernel.float()) + bias.float()
                if i < last:
                    x = F.gelu(x, approximate="none")
        return x, patch_cnt.to(torch.int32), patch_mask


@torch.no_grad()
def load_torch_state_dict(state_dict, cfg: TSEncoderConfig, prefix: str = "ts_encoder.",
                          device=None) -> TSEncoder:
    """The encoder from an HF state dict (torch or numpy values), in f32: the
    port of ``chatts_tpu.models.ts_encoder.load_torch_state_dict``.  torch
    Linear stores weight as (out, in), the encoder's kernels are (in, out);
    the Linear layers sit at the even slots of the reference's Sequential
    (GELU between)."""
    encoder = TSEncoder(cfg, device=device)
    for i in range(cfg.num_layers):
        slot = 2 * i
        encoder.kernels[i].copy_(
            state_tensor(state_dict, f"{prefix}mlp.{slot}.weight", device).float().t())
        encoder.biases[i].copy_(state_tensor(state_dict, f"{prefix}mlp.{slot}.bias", device))
    if cfg.use_position_embedding:
        encoder.position_embedding.copy_(
            state_tensor(state_dict, f"{prefix}position_embedding.weight", device))
    return encoder
