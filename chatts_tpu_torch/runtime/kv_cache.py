"""KV cache allocation for the batch and serving engines.

Counterpart of ``chatts_tpu/runtime/kv_cache.py``.  Caches are head-major
**(B, KVH, S, D)**, so the decode kernels read one contiguous (S, D) slab per
(row, kv head).

- bf16 and f32: per layer a (k, v) pair.
- int8 (``dtype=torch.int8``): per layer the 4-tuple (k_q, v_q, k_scale,
  v_scale): int8 codes (B, KVH, S, D) and f32 scales (B, KVH, S), one per
  (row, head, position).  The scales start at ones, as in the JAX package.
- latent (a ``MoonlightConfig``, multi-head latent attention): per layer the
  1-tuple (latent,) of one (B, 1, S, kv_lora_rank + qk_rope_head_dim) buffer,
  bf16 or f32: a token's normed ``c_kv`` and its roped key, shared by every
  head.  The latent is laid out as one kv head of that width, so the
  serving engine copies and indexes it as it does a head-major buffer.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from chatts_tpu_torch.core.config import DecoderConfig, MoonlightConfig

LayerCache = Tuple[torch.Tensor, ...]

_DTYPES = (torch.bfloat16, torch.float32, torch.int8)


def _check(dtype, cfg: DecoderConfig) -> None:
    if dtype not in _DTYPES:
        raise NotImplementedError(f"cache dtype {dtype} is not ported; use one of {_DTYPES}")
    if isinstance(cfg, MoonlightConfig) and dtype == torch.int8:
        raise NotImplementedError("an int8 latent cache is not ported; use bfloat16 or float32")


def allocate(cfg: DecoderConfig, batch_size: int, max_seq_len: int,
             dtype=torch.bfloat16, device=None, kv_heads: Optional[int] = None
             ) -> List[LayerCache]:
    """Zeroed caches of ``kv_heads`` heads a layer (the config's by default;
    a tensor-parallel rank holds its share, ``QwenModel.kv_heads``); for a
    ``MoonlightConfig`` the latent cache, one buffer a layer."""
    _check(dtype, cfg)
    if isinstance(cfg, MoonlightConfig):
        shape = (batch_size, 1, max_seq_len, cfg.latent_dim)
        return [(torch.zeros(shape, dtype=dtype, device=device),)
                for _ in range(cfg.num_hidden_layers)]
    kvh = cfg.num_key_value_heads if kv_heads is None else kv_heads
    shape = (batch_size, kvh, max_seq_len, cfg.head_dim)
    if dtype == torch.int8:
        sshape = shape[:3]
        return [
            (torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device),
             torch.ones(sshape, dtype=torch.float32, device=device),
             torch.ones(sshape, dtype=torch.float32, device=device))
            for _ in range(cfg.num_hidden_layers)
        ]
    return [
        (torch.zeros(shape, dtype=dtype, device=device),
         torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(cfg.num_hidden_layers)
    ]


def reset(caches: List[LayerCache]) -> None:
    """Set caches to what ``allocate`` makes, in place: codes and values 0,
    scales 1."""
    for layer in caches:
        for i, buf in enumerate(layer):
            buf.fill_(1.0 if i >= 2 else 0)


def cache_bytes(cfg: DecoderConfig, batch_size: int, max_seq_len: int,
                dtype=torch.bfloat16) -> int:
    """Device bytes of ``allocate``'s result, the int8 mode's scales included
    (the JAX package's ``cache_bytes`` counts the codes only), the latent
    layout's one buffer a layer for a ``MoonlightConfig``."""
    _check(dtype, cfg)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if isinstance(cfg, MoonlightConfig):
        return cfg.num_hidden_layers * batch_size * max_seq_len * cfg.latent_dim * itemsize
    positions = cfg.num_hidden_layers * batch_size * max_seq_len * cfg.num_key_value_heads
    total = 2 * positions * cfg.head_dim * itemsize
    if dtype == torch.int8:
        total += 2 * positions * 4
    return total
