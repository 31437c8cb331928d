"""Training losses: next-token cross-entropy with prompt masking.

The port of ``chatts_tpu/train/loss.py``: the loss masks prompt tokens and
padding, in the standard causal-LM shift arrangement.

On a mesh whose head is vocab-parallel, ``vocab_parallel_nll`` takes each
rank's own columns of the logits (``QwenModel.compute_logits(gather=False)``)
instead of gathering (B, T, vocab) f32 logits: the maximum and the sum of
exponentials are reduced over tp, and the target's logit comes from the
rank that holds it.  Its backward is the softmax minus the one-hot, on the
rank's columns.  ``masked_mean`` divides by the masked-token count of the
whole batch, summed over dp, so that the loss is the single-device one.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from chatts_tpu_torch.parallel.mesh import all_reduce_dp, all_reduce_tp, max_tp


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(B, T) logsumexp minus the target's logit, in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    return logz - logits.gather(-1, targets.long()[..., None])[..., 0]


def cross_entropy(
    logits: torch.Tensor,  # (B, T, V)
    targets: torch.Tensor,  # (B, T) int
    loss_mask: torch.Tensor,  # (B, T) float: 1 where the target counts
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean masked token cross-entropy in f32: logsumexp minus the target's
    logit, summed under the mask and divided by max(sum(mask), 1).
    Returns (loss, token_count)."""
    return masked_mean(token_nll(logits, targets), loss_mask)


def masked_mean(nll: torch.Tensor, loss_mask: torch.Tensor,
                mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum(nll * mask) / max(count, 1), count), count the mask's sum; on a
    mesh with dp > 1, ``nll`` and the mask are this dp group's rows and
    count is the whole batch's (summed over dp), so that the dp groups'
    losses add up to the whole batch's."""
    mask = loss_mask.float()
    count = all_reduce_dp(mesh, mask.sum().detach().clone())
    count = torch.clamp(count, min=1.0)
    return (nll * mask).sum() / count, count


class _VocabParallelNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, targets, mesh, vocab_start):
        local = local.float()
        rows = local.shape[-1]
        peak = max_tp(mesh, local.amax(dim=-1))
        probs = torch.exp(local - peak[..., None])
        total = all_reduce_tp(mesh, probs.sum(dim=-1))
        index = targets.long() - vocab_start
        inside = (index >= 0) & (index < rows)
        index = torch.where(inside, index, 0)
        picked = local.gather(-1, index[..., None])[..., 0]
        target_logit = all_reduce_tp(mesh, torch.where(inside, picked, 0.0))
        probs /= total[..., None]
        ctx.save_for_backward(probs, index, inside)
        return torch.log(total) + peak - target_logit

    @staticmethod
    def backward(ctx, g):
        probs, index, inside = ctx.saved_tensors
        grad = probs * g[..., None]
        grad.scatter_add_(-1, index[..., None], torch.where(inside, -g, 0.0)[..., None])
        return grad, None, None, None


def vocab_parallel_nll(local_logits: torch.Tensor, targets: torch.Tensor, mesh,
                       vocab_start: int) -> torch.Tensor:
    """(B, T) ``token_nll`` of the whole vocabulary from this rank's columns
    [vocab_start, vocab_start + V_local) of the logits, reduced over the tp
    group; differentiable, its gradient on the rank's columns only."""
    if mesh is None or mesh.tp == 1 or not dist.is_initialized():
        return token_nll(local_logits, targets)
    return _VocabParallelNLL.apply(local_logits, targets, mesh, vocab_start)
