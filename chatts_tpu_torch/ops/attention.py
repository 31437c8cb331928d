"""Attention ops: the plain grouped-query attention and the prefill dispatch.

Counterpart of ``chatts_tpu/ops/attention.py``.  One mask covers every phase:

    attend(i, j)  <=>  kv_valid[j] and kv_positions[j] <= q_positions[i]

which is causal prefill, padded-batch prefill and decode against a cache.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = torch.finfo(torch.float32).min


def mha_reference(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, KVH, D)
    v: torch.Tensor,  # (B, S, KVH, D)
    *,
    q_positions: torch.Tensor,  # (B, T) int
    kv_positions: torch.Tensor,  # (B, S) int
    kv_valid: torch.Tensor,  # (B, S) bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention with the position mask, in plain PyTorch.

    Scores and softmax are f32 whatever the input type; the probabilities are
    rounded to v's type before the PV product, as in the JAX reference.  Rows
    with no valid key give 0.  Returns (B, T, H, D) in q's type."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, t, kvh, h // kvh, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    mask = kv_valid[:, None, :] & (kv_positions[:, None, :] <= q_positions[:, :, None])
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    any_valid = mask.any(dim=-1)[:, None, None, :, None]
    probs = torch.where(any_valid, probs, 0.0)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: torch.Tensor,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Prefill attention.  ``impl="auto"``: the flash kernel for CUDA
    tensors, the plain version for CPU tensors (see
    ``flash_attention.flash_attention``); ``impl="xla"``: ``mha_reference``
    on any device, the JAX package's name for its plain path.

    Unlike the JAX dispatch, "auto" has no length threshold: the v5e's
    crossover (T >= 512) does not carry over to the H100, so every CUDA call
    takes the kernel until the crossover is measured on the card.

    Training passes "xla": autograd differentiates the plain version, and
    the kernel has no backward (its wrapper refuses gradients).  JAX's
    "auto" takes its kernel only on a TPU, and JAX cannot differentiate it
    there either, so its training losses pass "xla" too."""
    kwargs = dict(q_positions=q_positions, kv_positions=kv_positions,
                  kv_valid=kv_valid, scale=scale)
    if impl == "xla":
        return mha_reference(q, k, v, **kwargs)
    if impl != "auto":
        raise ValueError(f"attention impl must be 'auto' or 'xla', got {impl!r}")
    from chatts_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, **kwargs)
