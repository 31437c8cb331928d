"""LoRA adapters for ChatTS fine-tuning: the port of ``chatts_tpu/train/lora.py``.

An adapter set mirrors the JAX package's pytree: ``{"layers": [{module:
{"a": (in, r), "b": (r, out)}}]}``, one entry a decoder layer, f32 leaf
tensors that need gradients, a normal * 0.02 and b zero.  Inside
``applied_lora`` they are attached to the target projections
(``Dense.lora``): each call then folds its adapter into the kernel,
``(W.float() + (a.float() @ b.float()) * scale).to(W.dtype)``, exactly as
JAX's ``apply_lora`` does, and the base stays frozen (its parameters need
no gradient).  Autograd reads the adapters
again in the backward (``remat`` recomputes each layer there), so the
backward runs before the adapters are detached.

A fused ``qkv_proj`` / ``gate_up_proj`` or a quantized projection takes no
adapter (``ValueError``): JAX's ``apply_lora`` reads
``layer[group][module]["kernel"]`` and has no answer for either.

On a model placed on a mesh the adapters are whole and replicated, as
JAX's are under GSPMD: ``init_lora`` draws the whole shapes, (in, r) and
(r, out) of the whole layer, from the same generator as on one device; a
shard folds in its part (``Dense.shard_adapter``), and each rank's
gradient of an adapter on a shard is a part, summed over tp
(``lora_kinds``, ``sft_driver.lora_loss_fn``).  ``merge_lora`` merges
each shard's part into the shard.

``merge_lora`` gives a model with the adapters merged into plain float
kernels, a new model sharing every other tensor with the base, which it
leaves unchanged, or, with ``in_place=True``, the base itself.
``lora_from_jax`` and ``lora_to_numpy`` carry an adapter set across from and
back to the JAX package's pytree of arrays.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Dict, Iterator, List, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from chatts_tpu_torch.models.chatts import ChatTSModel
from chatts_tpu_torch.models.qwen import Dense, DecoderLayer, lora_kernel

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")

Lora = Dict[str, List[Dict[str, Dict[str, torch.Tensor]]]]


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    target_modules: Sequence[str] = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def module_group(module: str) -> str:
    return "self_attn" if module.endswith(("q_proj", "k_proj", "v_proj", "o_proj")) else "mlp"


def _target_dense(layer: DecoderLayer, module: str) -> Dense:
    """The float projection ``module`` of a decoder layer; raises
    ``ValueError`` where the layer has it fused or quantized."""
    dense = getattr(getattr(layer, module_group(module)), module, None)
    if dense is None:
        raise ValueError(f"LoRA: the layer has no unfused {module} (a fused qkv_proj or "
                         "gate_up_proj takes no adapter)")
    if dense.kernel is None:
        raise ValueError(f"LoRA: {module} is quantized; an adapter folds into a float kernel")
    return dense


def init_lora(model: ChatTSModel, cfg: LoRAConfig, generator: torch.Generator,
              dtype=torch.float32) -> Lora:
    """Adapters for every decoder layer and target module, on the kernels'
    device: a (in, r) normal * 0.02 drawn from ``generator`` on its own
    device, b (r, out) zeros, of the whole layer's (in, out) also on a
    shard.  Every tensor needs gradients."""
    layers = []
    for layer in model.llm.layers:
        entry = {}
        for module in cfg.target_modules:
            dense = _target_dense(layer, module)
            kernel = dense.kernel
            fan_in, fan_out = dense.whole_shape
            a = torch.randn((fan_in, cfg.rank), generator=generator, device=generator.device) * 0.02
            entry[module] = {
                "a": a.to(device=kernel.device, dtype=dtype).requires_grad_(),
                "b": torch.zeros((cfg.rank, fan_out), dtype=dtype, device=kernel.device,
                                 requires_grad=True),
            }
        layers.append(entry)
    return {"layers": layers}


def lora_kinds(model: ChatTSModel, lora: Lora) -> List[str]:
    """``sharding.grad_kinds`` of ``lora_parameters(lora)``: "partial" for
    an adapter on a shard (each rank's gradient is a part, summed over tp),
    "whole" for one on a whole layer."""
    return [("partial" if dense.tp_kind else "whole")
            for dense, _ in _targets(model, lora) for _ in ("a", "b")]


def _targets(model: ChatTSModel, lora: Lora) -> Iterator:
    """(Dense, adapter) for every adapter of ``lora``, layer by layer."""
    if len(lora["layers"]) != len(model.llm.layers):
        raise ValueError(f"{len(lora['layers'])} adapter layers for "
                         f"{len(model.llm.layers)} decoder layers")
    for layer, adapters in zip(model.llm.layers, lora["layers"]):
        for module, ab in adapters.items():
            yield _target_dense(layer, module), ab


@contextlib.contextmanager
def applied_lora(model: ChatTSModel, lora: Lora, cfg: LoRAConfig):
    """The counterpart of JAX's ``apply_lora(train=True)``: inside, every
    target projection folds its adapter in; run the backward inside too."""
    for dense, ab in _targets(model, lora):
        dense.lora = (ab["a"], ab["b"], cfg.scale)
    try:
        yield model
    finally:
        for module in model.modules():
            if isinstance(module, Dense):
                module.lora = None


def _shallow_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` and of every submodule, sharing their tensors:
    replacing a submodule of the copy leaves the original as it was."""
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._modules = {name: None if child is None else _shallow_copy(child)
                    for name, child in module._modules.items()}
    return new


@torch.no_grad()
def merge_lora(model: ChatTSModel, lora: Lora, cfg: LoRAConfig, *,
               in_place: bool = False) -> ChatTSModel:
    """Merge the adapters into plain float kernels (the PEFT merge analog):
    each target becomes a ``Dense`` of ``lora_kernel``'s kernel with the old
    bias (on a shard, the shard's part merged into the shard).  By default
    the result is a new model that shares every other tensor with ``model``
    and leaves ``model`` unchanged; with ``in_place=True`` the projections
    of ``model`` itself are replaced."""
    merged = model if in_place else _shallow_copy(model)
    for layer, adapters in zip(merged.llm.layers, lora["layers"]):
        for module, ab in adapters.items():
            dense = _target_dense(layer, module)
            kernel = lora_kernel(dense.kernel, *dense.shard_adapter(ab["a"], ab["b"]),
                                 cfg.scale)
            setattr(getattr(layer, module_group(module)), module,
                    Dense(kernel, bias=dense.bias, mesh=dense.mesh, tp_kind=dense.tp_kind))
    return merged


def lora_parameters(lora: Lora) -> List[torch.Tensor]:
    """The adapter tensors in a fixed order: layer, module, a then b."""
    return [ab[k] for layer in lora["layers"] for ab in layer.values() for k in ("a", "b")]


def lora_param_count(lora: Lora) -> int:
    return sum(t.numel() for t in lora_parameters(lora))


def lora_from_jax(tree: Mapping[str, Any], device="cuda") -> Lora:
    """The JAX package's adapter pytree (numpy or JAX arrays) as f32 tensors
    on ``device`` that need gradients."""
    return {"layers": [
        {module: {k: torch.tensor(np.asarray(ab[k], np.float32), device=device,
                                  requires_grad=True) for k in ("a", "b")}
         for module, ab in layer.items()}
        for layer in tree["layers"]]}


def lora_to_numpy(lora: Lora) -> Dict[str, Any]:
    """The adapter set as the JAX package's pytree of f32 numpy arrays."""
    return {"layers": [
        {module: {k: ab[k].detach().float().cpu().numpy() for k in ("a", "b")}
         for module, ab in layer.items()}
        for layer in lora["layers"]]}
