"""The SFT training step: the port of ``chatts_tpu/train/train_step.py``.

Full-parameter training: every float parameter of the model, the TS encoder
included, is trained.  The optimizer is optax's chain in PyTorch: a clip by
the global norm (``clip_by_global_norm_``, optax's formula), then
``torch.optim.AdamW`` with optax's ``adamw`` defaults (eps 1e-8, decoupled
weight decay).  The step mutates the parameters and the optimizer in place
where JAX returns new ones.

The forward runs with ``attn_impl="xla"`` (the plain attention) whatever
``remat`` is: the prefill kernel has no backward.  ``remat`` checkpoints
each decoder layer (``torch.utils.checkpoint``, non-reentrant), where JAX
wraps the whole forward in one ``jax.checkpoint``: in eager PyTorch a
checkpoint around the whole forward would keep nothing but recompute
everything at once in the backward, holding every layer's activations
again, so it saves no memory; per layer, the backward holds one layer's.
The loss and gradients are those of ``remat=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from chatts_tpu_torch.models.chatts import ChatTSModel
from chatts_tpu_torch.train.loss import cross_entropy


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    remat: bool = True


def make_optimizer(tc: TrainConfig, params: Sequence[torch.Tensor]) -> torch.optim.AdamW:
    """AdamW over ``params`` as optax's ``adamw(lr, b1, b2, weight_decay)``
    computes it; ``apply_update`` clips the gradients first."""
    return torch.optim.AdamW(params, lr=tc.learning_rate, betas=(tc.b1, tc.b2), eps=1e-8,
                             weight_decay=tc.weight_decay)


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: with g_norm the square root
    of the sum of every gradient's squares (taken in f32), each gradient
    stays as it is where g_norm < max_norm and becomes ``(g / g_norm) *
    max_norm`` otherwise.  (``torch.nn.utils.clip_grad_norm_`` multiplies by
    max_norm / (g_norm + 1e-6), a different number.)  Returns g_norm; reads
    nothing on the host."""
    g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(g_norm < max_norm, g, (g / g_norm.to(g.dtype)) * max_norm))
    return g_norm


def apply_update(optimizer: torch.optim.Optimizer, tc: TrainConfig) -> torch.Tensor:
    """Clip, then one AdamW step over the optimizer's parameters.  A
    parameter that got no gradient takes a zero one, as JAX's gradient of an
    unused leaf is zero.  Returns the global norm before the clip."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    g_norm = clip_by_global_norm_([p.grad for p in params], tc.grad_clip)
    optimizer.step()
    return g_norm


def loss_fn(model: ChatTSModel, batch: Dict[str, torch.Tensor],
            remat: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"loss", "tokens"}) of a batch from ``data.build_sft_batch``
    (as tensors on the model's device); autograd records it."""
    hidden, _ = model(
        batch["input_ids"], batch["positions"],
        ts_values=batch.get("ts_values"), ts_mask=batch.get("ts_mask"),
        scatter_seq=batch.get("scatter_seq"), scatter_tok=batch.get("scatter_tok"),
        kv_valid=batch["attention_mask"].bool(), kv_positions=batch["positions"],
        attn_impl="xla", remat=remat,
    )
    logits = model.compute_logits(hidden)
    loss, count = cross_entropy(logits, batch["targets"], batch["loss_mask"])
    return loss, {"loss": loss, "tokens": count}


def train_step(model: ChatTSModel, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], tc: TrainConfig) -> Dict[str, torch.Tensor]:
    """One full-parameter step: gradients of ``loss_fn``, the clip, AdamW.
    Returns the metrics (tensors on the device) and the global norm."""
    optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(model, batch, tc.remat)
    loss.backward()
    grad_norm = apply_update(optimizer, tc)
    return {"loss": loss.detach(), "tokens": metrics["tokens"], "grad_norm": grad_norm}


def make_train_step(model: ChatTSModel, tc: Optional[TrainConfig] = None):
    """(step, optimizer): every float parameter of ``model`` made trainable,
    AdamW over them, and ``step(batch) -> metrics`` running ``train_step``."""
    tc = tc or TrainConfig()
    params = [p for p in model.parameters() if p.is_floating_point()]
    for p in params:
        p.requires_grad_(True)
    optimizer = make_optimizer(tc, params)

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return train_step(model, optimizer, batch, tc)

    return step, optimizer


def build_training_batch(processed, targets, loss_mask) -> Dict[str, object]:
    """A train-step batch from a ``ProcessedBatch`` and its labels."""
    return {
        "input_ids": processed.input_ids,
        "positions": processed.positions,
        "attention_mask": processed.attention_mask,
        "ts_values": processed.ts_values,
        "ts_mask": processed.ts_mask,
        "scatter_seq": processed.scatter_seq,
        "scatter_tok": processed.scatter_tok,
        "targets": targets,
        "loss_mask": loss_mask,
    }
