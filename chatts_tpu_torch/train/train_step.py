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

On a (dp, tp) mesh (a model from ``parallel/sharding.py``) each rank does
what GSPMD does for JAX's step: every rank is given the whole batch and its
dp group takes its rows (``sharding.local_train_batch``); the loss divides
by the whole batch's masked-token count (``loss.masked_mean``) and, with a
vocab-parallel head, takes the rank's logit columns
(``loss.vocab_parallel_nll``); after the backward ``sync_gradients`` sums
the gradients over dp, and partial ones over tp too
(``sharding.grad_kinds``); the global norm sums the squares of sharded
gradients over tp and counts every other once, so it is optax's norm of
the whole model on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from chatts_tpu_torch.models.chatts import ChatTSModel
from chatts_tpu_torch.parallel import sharding
from chatts_tpu_torch.parallel.mesh import Mesh, all_reduce_dp, all_reduce_tp
from chatts_tpu_torch.train.loss import (
    cross_entropy,
    masked_mean,
    token_nll,
    vocab_parallel_nll,
)


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


def _sum_flat(tensors: List[torch.Tensor], group) -> None:
    """Sum each tensor over ``group`` in place, one collective a dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def sync_gradients(mesh: Optional[Mesh], grads: Sequence[torch.Tensor],
                   kinds: Sequence[str]) -> None:
    """Each rank's gradients made the step's, in place: "partial" ones
    (``sharding.grad_kinds``) summed over tp, then all of them over dp
    (each dp group's rows gave its share of the loss).  Nothing without a
    mesh."""
    if mesh is None:
        return
    partial = [g for g, kind in zip(grads, kinds) if kind == "partial"]
    if mesh.tp > 1 and partial:
        _sum_flat(partial, mesh.tp_group)
    if mesh.dp > 1:
        _sum_flat(list(grads), mesh.dp_group)


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         mesh: Optional[Mesh] = None,
                         kinds: Optional[Sequence[str]] = None) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: with g_norm the square root
    of the sum of every gradient's squares (taken in f32), each gradient
    stays as it is where g_norm < max_norm and becomes ``(g / g_norm) *
    max_norm`` otherwise.  (``torch.nn.utils.clip_grad_norm_`` multiplies by
    max_norm / (g_norm + 1e-6), a different number.)  On a mesh, ``kinds``
    marks the "sharded" gradients, whose squares are summed over tp: the
    norm is the whole model's.  Returns g_norm; reads nothing on the host."""
    kinds = kinds or ["whole"] * len(grads)
    own = [g for g, kind in zip(grads, kinds) if kind != "sharded"]
    cut = [g for g, kind in zip(grads, kinds) if kind == "sharded"]
    square = sum(g.float().square().sum() for g in own)
    if cut:
        square = square + all_reduce_tp(mesh, sum(g.float().square().sum() for g in cut))
    g_norm = torch.sqrt(square)
    for g in grads:
        g.copy_(torch.where(g_norm < max_norm, g, (g / g_norm.to(g.dtype)) * max_norm))
    return g_norm


def gradients(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each parameter's ``.grad``; one that got none takes a zero one, as
    JAX's gradient of an unused leaf is zero."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def apply_update(optimizer: torch.optim.Optimizer, tc: TrainConfig,
                 mesh: Optional[Mesh] = None,
                 kinds: Optional[Sequence[str]] = None) -> torch.Tensor:
    """Clip, then one AdamW step over the optimizer's parameters.  On a mesh
    the gradients must already be the step's (``sync_gradients``, called
    where they are computed: nothing sums them here), and ``kinds`` makes
    the norm the whole model's.  Returns the global norm before the clip."""
    grads = gradients([p for group in optimizer.param_groups for p in group["params"]])
    g_norm = clip_by_global_norm_(grads, tc.grad_clip, mesh, kinds)
    optimizer.step()
    return g_norm


def loss_fn(model: ChatTSModel, batch: Dict[str, torch.Tensor],
            remat: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"loss", "tokens"}) of a batch from ``data.build_sft_batch``
    (as tensors on the model's device); autograd records it.  On a mesh
    with dp > 1 the first is this dp group's share (its rows' masked sum
    over the whole batch's count), whose gradients ``sync_gradients`` sums,
    and the metrics are the whole batch's."""
    mesh = model.mesh
    batch = sharding.local_train_batch(batch, mesh)
    hidden, _ = model(
        batch["input_ids"], batch["positions"],
        ts_values=batch.get("ts_values"), ts_mask=batch.get("ts_mask"),
        scatter_seq=batch.get("scatter_seq"), scatter_tok=batch.get("scatter_tok"),
        kv_valid=batch["attention_mask"].bool(), kv_positions=batch["positions"],
        attn_impl="xla", remat=remat,
    )
    llm = model.llm
    if mesh is None:
        loss, count = cross_entropy(model.compute_logits(hidden), batch["targets"],
                                    batch["loss_mask"])
        return loss, {"loss": loss, "tokens": count}
    if llm.vocab_start is not None:
        nll = vocab_parallel_nll(llm.compute_logits(hidden, gather=False), batch["targets"],
                                 mesh, llm.vocab_start)
    else:
        nll = token_nll(model.compute_logits(hidden), batch["targets"])
    loss, count = masked_mean(nll, batch["loss_mask"], mesh)
    return loss, {"loss": all_reduce_dp(mesh, loss.detach().clone()), "tokens": count}


def train_step(model: ChatTSModel, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], tc: TrainConfig,
               kinds: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """One full-parameter step: gradients of ``loss_fn``, the clip, AdamW.
    ``kinds``: each optimizer parameter's ``sharding.grad_kinds`` on a
    mesh.  Returns the metrics (tensors on the device) and the global norm."""
    optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(model, batch, tc.remat)
    loss.backward()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    sync_gradients(model.mesh, gradients(params), kinds or ["whole"] * len(params))
    grad_norm = apply_update(optimizer, tc, model.mesh, kinds)
    return {"loss": metrics["loss"].detach(), "tokens": metrics["tokens"],
            "grad_norm": grad_norm}


def make_train_step(model: ChatTSModel, tc: Optional[TrainConfig] = None):
    """(step, optimizer): every float parameter of ``model`` made trainable,
    AdamW over them, and ``step(batch) -> metrics`` running ``train_step``;
    on a mesh, with each parameter's gradient summed as it lies there."""
    tc = tc or TrainConfig()
    params = [p for p in model.parameters() if p.is_floating_point()]
    for p in params:
        p.requires_grad_(True)
    optimizer = make_optimizer(tc, params)
    layout = sharding.grad_kinds(model)
    kinds = [layout.get(id(p), "whole") for p in params]

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return train_step(model, optimizer, batch, tc, kinds)

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
