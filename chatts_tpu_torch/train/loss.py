"""Training losses: next-token cross-entropy with prompt masking.

The port of ``chatts_tpu/train/loss.py``: the loss masks prompt tokens and
padding, in the standard causal-LM shift arrangement.
"""
from __future__ import annotations

from typing import Tuple

import torch


def cross_entropy(
    logits: torch.Tensor,  # (B, T, V)
    targets: torch.Tensor,  # (B, T) int
    loss_mask: torch.Tensor,  # (B, T) float: 1 where the target counts
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean masked token cross-entropy in f32: logsumexp minus the target's
    logit, summed under the mask and divided by max(sum(mask), 1).
    Returns (loss, token_count)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - target_logit
    mask = loss_mask.float()
    count = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / count, count
