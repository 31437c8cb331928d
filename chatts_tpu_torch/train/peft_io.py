"""PEFT LoRA adapter interop: the port of ``chatts_tpu/train/peft_io.py`` on
the port's own safetensors reader and writer (``utils/safetensors_io.py``).

The same tensor names, prefixes, transposes and ``adapter_config.json`` as
the JAX package's, so an adapter written by either package loads in the
other (and in PEFT):

  base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight  (r, in)
  base_model.model.model.layers.{i}.mlp.gate_proj.lora_B.weight     (out, r)

The port's layout per layer and module is {"a": (in, r), "b": (r, out)},
f32, with scale = lora_alpha / r.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import torch

from chatts_tpu_torch.parallel import distributed
from chatts_tpu_torch.train.lora import Lora, LoRAConfig, module_group
from chatts_tpu_torch.utils import safetensors_io

_PEFT_PREFIXES = (
    "base_model.model.model.layers.",
    "base_model.model.layers.",
    "model.layers.",
)
TENSOR_FILE = "adapter_model.safetensors"
CONFIG_FILE = "adapter_config.json"


def load_peft_adapter(path: str, device="cuda") -> Tuple[LoRAConfig, Lora]:
    """(LoRAConfig, adapters on ``device``, needing gradients) from a PEFT
    adapter directory."""
    with open(os.path.join(path, CONFIG_FILE)) as f:
        acfg = json.load(f)
    rank = int(acfg.get("r", 8))
    alpha = float(acfg.get("lora_alpha", rank * 2))
    targets = tuple(acfg.get("target_modules", []))

    # Group by (layer index, module).
    by_layer: Dict[int, Dict[str, Dict[str, torch.Tensor]]] = {}
    with safetensors_io.SafetensorsFile(os.path.join(path, TENSOR_FILE)) as f:
        for name in f.keys():
            stripped = next((name[len(p):] for p in _PEFT_PREFIXES if name.startswith(p)), None)
            if stripped is None:
                continue
            parts = stripped.split(".")  # {i}.self_attn.q_proj.lora_A.weight
            ab = "a" if "lora_A" in name else "b"
            by_layer.setdefault(int(parts[0]), {}).setdefault(parts[2], {})[ab] = f.get(name)

    num_layers = max(by_layer) + 1 if by_layer else 0
    modules = sorted({m for layer in by_layer.values() for m in layer})
    layers = []
    for i in range(num_layers):
        entry = {}
        for module in modules:
            ab = by_layer.get(i, {}).get(module)
            if ab is None or "a" not in ab or "b" not in ab:
                continue
            # PEFT lora_A (r, in) -> a (in, r); lora_B (out, r) -> b (r, out).
            entry[module] = {k: ab[k].t().to(device=device, dtype=torch.float32)
                             .contiguous().requires_grad_() for k in ("a", "b")}
        layers.append(entry)

    cfg = LoRAConfig(rank=rank, alpha=alpha, target_modules=targets or tuple(modules))
    return cfg, {"layers": layers}


def save_peft_adapter(path: str, lora_cfg: LoRAConfig, lora: Lora) -> None:
    """Write the adapters in PEFT layout, f32.  In a world, every rank calls
    it (the adapters are whole and alike on a mesh), world rank 0 writes
    and every rank waits for the files."""
    if not distributed.is_writer():
        distributed.barrier()
        return
    os.makedirs(path, exist_ok=True)
    tensors: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(lora["layers"]):
        for module, ab in layer.items():
            base = f"base_model.model.model.layers.{i}.{module_group(module)}.{module}"
            tensors[f"{base}.lora_A.weight"] = ab["a"].detach().float().t().contiguous()
            tensors[f"{base}.lora_B.weight"] = ab["b"].detach().float().t().contiguous()
    safetensors_io.save_file(tensors, os.path.join(path, TENSOR_FILE))
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump({
            "peft_type": "LORA",
            "r": lora_cfg.rank,
            "lora_alpha": lora_cfg.alpha,
            "target_modules": list(lora_cfg.target_modules),
            "task_type": "CAUSAL_LM",
        }, f, indent=2)
    distributed.barrier()
