"""LoRA SFT training driver: the port of ``chatts_tpu/train/sft_driver.py``.

jsonl datasets -> loss-masked batches (``train/data.py``) -> LoRA steps on
one card (adapters and AdamW in f32, the base frozen) -> checkpointed train
state for resume -> merged-weight export through ``models/weights.py``.

Checkpoints are ``torch.save`` files of ``{"lora", "opt", "step"}`` in
``checkpoint_dir/<step>/state.pt``, the newest two kept, where the JAX
package writes orbax directories with ``max_to_keep=2``: a chosen
difference of format, so the two packages do not resume each other's runs
(``lora_from_jax`` and ``peft_io`` carry adapters across).

On a model placed on a (dp, tp) mesh every rank runs the driver on the same
rows: the adapters and the optimizer are whole and alike on every rank
(``lora.py``), each step's adapter gradients are summed over the mesh
(``lora_loss_fn``), world rank 0 alone writes the checkpoints and the
export, in the files a single device writes, and every rank resumes from
them.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Dict, List, Optional

import torch

from chatts_tpu_torch.core.config import ChatTSConfig
from chatts_tpu_torch.models.chatts import ChatTSModel
from chatts_tpu_torch.parallel import distributed, sharding
from chatts_tpu_torch.train import data as data_lib
from chatts_tpu_torch.train.lora import (
    Lora,
    LoRAConfig,
    applied_lora,
    init_lora,
    lora_kinds,
    lora_parameters,
    merge_lora,
)
from chatts_tpu_torch.train.train_step import (
    TrainConfig,
    apply_update,
    gradients,
    loss_fn,
    make_optimizer,
    sync_gradients,
)

CHECKPOINT_FILE = "state.pt"
MAX_TO_KEEP = 2


def lora_loss_fn(lora: Lora, model: ChatTSModel, lora_cfg: LoRAConfig,
                 batch: Dict[str, torch.Tensor], remat: bool):
    """(loss, metrics) of ``model`` with ``lora`` folded in, and, where
    autograd records the call, the loss's gradient accumulated into each
    adapter's ``.grad``: the port of ``jax.value_and_grad(lora_loss_fn,
    has_aux=True)`` as one call.  The backward runs here, while the adapters
    are attached, since ``remat`` recomputes each layer in it.  On a mesh
    the gradients are then summed over it (``sync_gradients``), so that
    every rank holds the whole model's."""
    params = lora_parameters(lora)
    with applied_lora(model, lora, lora_cfg):
        loss, metrics = loss_fn(model, batch, remat)
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            loss.backward()
    if model.mesh is not None and loss.grad_fn is not None:
        sync_gradients(model.mesh, gradients(params), lora_kinds(model, lora))
    return metrics["loss"].detach(), {"loss": metrics["loss"].detach(),
                                      "tokens": metrics["tokens"]}


def make_lora_train_step(model: ChatTSModel, lora: Lora, lora_cfg: LoRAConfig,
                         tc: Optional[TrainConfig] = None):
    """(step, optimizer): the base frozen, AdamW over the adapter tensors,
    and ``step(batch) -> metrics`` taking one clipped AdamW step on them.
    ``lora_loss_fn`` has made the gradients whole on every rank, so the
    update needs no mesh."""
    tc = tc or TrainConfig(learning_rate=1e-4)
    for p in model.parameters():
        p.requires_grad_(False)
    optimizer = make_optimizer(tc, lora_parameters(lora))

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        _, metrics = lora_loss_fn(lora, model, lora_cfg, batch, tc.remat)
        metrics["grad_norm"] = apply_update(optimizer, tc)
        return metrics

    return step, optimizer


@dataclasses.dataclass
class SFTResult:
    losses: List[float]
    steps: int
    lora_params: Lora


def _steps_saved(checkpoint_dir: str) -> List[int]:
    if not os.path.isdir(checkpoint_dir):
        return []
    return sorted(int(name) for name in os.listdir(checkpoint_dir)
                  if name.isdigit() and os.path.isfile(
                      os.path.join(checkpoint_dir, name, CHECKPOINT_FILE)))


def save_train_state(checkpoint_dir: str, step: int, lora: Lora,
                     optimizer: torch.optim.Optimizer) -> None:
    """``{"lora", "opt", "step"}`` to ``checkpoint_dir/<step>/state.pt``
    (written whole, then renamed), keeping the newest ``MAX_TO_KEEP``; in a
    world, by rank 0 alone, which every rank then waits for."""
    if not distributed.is_writer():
        distributed.barrier()
        return
    out = os.path.join(checkpoint_dir, str(step))
    os.makedirs(out, exist_ok=True)
    state = {"lora": {"layers": [{m: {k: t.detach().cpu() for k, t in ab.items()}
                                  for m, ab in layer.items()} for layer in lora["layers"]]},
             "opt": optimizer.state_dict(), "step": step}
    tmp = os.path.join(out, CHECKPOINT_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(out, CHECKPOINT_FILE))
    for old in _steps_saved(checkpoint_dir)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(checkpoint_dir, str(old)))
    distributed.barrier()


def restore_train_state(checkpoint_dir: str, lora: Lora,
                        optimizer: torch.optim.Optimizer) -> Optional[int]:
    """Load the newest saved state into ``lora`` and ``optimizer`` in place;
    returns its step, or None where nothing was saved."""
    steps = _steps_saved(checkpoint_dir)
    if not steps:
        return None
    path = os.path.join(checkpoint_dir, str(steps[-1]), CHECKPOINT_FILE)
    state = torch.load(path, map_location="cpu")
    with torch.no_grad():
        for layer, saved in zip(lora["layers"], state["lora"]["layers"]):
            for module, ab in layer.items():
                for k, t in ab.items():
                    t.copy_(saved[module][k])
    optimizer.load_state_dict(state["opt"])
    return int(state["step"])


def train_lora_sft(
    model: ChatTSModel,
    cfg: ChatTSConfig,
    processor,
    dataset_rows: List[dict],
    *,
    lora_cfg: Optional[LoRAConfig] = None,
    train_cfg: Optional[TrainConfig] = None,
    batch_size: int = 4,
    num_epochs: int = 1,
    max_steps: Optional[int] = None,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    log_every: int = 10,
    device="cuda",
) -> SFTResult:
    """Run LoRA SFT on ``model`` (on ``device``, the card unless the caller
    asks for the CPU); with ``checkpoint_dir``, save the adapters and the
    optimizer every ``checkpoint_every`` steps and resume from the newest.
    The adapters start from ``torch.Generator().manual_seed(seed)`` on the
    CPU, so a seed gives the same start on every device; epoch e shuffles
    with seed + e, as the JAX package's ``train_lora_sft`` does.  On a mesh
    every rank calls it with the same arguments (module docstring)."""
    device = torch.device(device)
    lora_cfg = lora_cfg or LoRAConfig()
    train_cfg = train_cfg or TrainConfig(learning_rate=1e-4)
    where = model.llm.embed_tokens.device
    if where.type != device.type:
        raise ValueError(f"the model is on {where}, the batches go to {device}")
    lora = init_lora(model, lora_cfg, torch.Generator().manual_seed(seed))
    step_fn, optimizer = make_lora_train_step(model, lora, lora_cfg, train_cfg)
    verbose = distributed.is_writer()
    start_step = 0
    if checkpoint_dir:
        latest = restore_train_state(checkpoint_dir, lora, optimizer)
        if latest is not None:
            start_step = latest
            if verbose:
                print(f"[sft] resumed from step {latest}")

    losses: List[float] = []
    step_idx = start_step
    t0 = time.perf_counter()
    done = False
    for epoch in range(num_epochs):
        if done:
            break
        for batch_np in data_lib.batch_iterator(processor, dataset_rows, batch_size,
                                                seed=seed + epoch):
            metrics = step_fn(data_lib.to_device(batch_np, device))
            loss = float(metrics["loss"])
            losses.append(loss)
            step_idx += 1
            if verbose and step_idx % log_every == 0:
                rate = (step_idx - start_step) / (time.perf_counter() - t0)
                print(f"[sft] step {step_idx} loss {loss:.4f} ({rate:.2f} it/s)")
            if checkpoint_dir and step_idx % checkpoint_every == 0:
                save_train_state(checkpoint_dir, step_idx, lora, optimizer)
            if max_steps is not None and step_idx - start_step >= max_steps:
                done = True
                break
    return SFTResult(losses=losses, steps=step_idx, lora_params=lora)


def export_merged(model: ChatTSModel, lora: Lora, cfg: ChatTSConfig, lora_cfg: LoRAConfig,
                  output_dir: str) -> None:
    """Merge the adapters (``merge_lora``, the base left unchanged) and
    write an HF-layout checkpoint (the demo_lora load + merge + save flow).
    On a mesh every rank calls it: the merged shards are gathered into the
    whole model (``sharding.gather_model``, on the CPU) and world rank 0
    writes it."""
    from chatts_tpu_torch.models import weights

    merged = sharding.gather_model(merge_lora(model, lora, lora_cfg))
    if distributed.is_writer():
        weights.save_checkpoint(output_dir, cfg, merged)
    distributed.barrier()
