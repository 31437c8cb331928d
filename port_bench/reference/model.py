"""The pieces of ChatTS's forward pass that every family's reference shares,
in plain PyTorch, float32, TF32 off (``full_f32``): the patch encoder, an MLP
with exact GELU between its layers over patches of ``patch_size`` values (a
series padded to whole patches with its last value), whose embeddings
replace those of the placeholder tokens; RMSNorm; rotate-half RoPE (inverse
frequencies theta ** (-2i / head_dim)) at positions 0 .. T - 1; causal
grouped-query attention; the unpacking of the benchmark's int4 bytes and
group scales to float32; and the float8 e4m3 rounding of the control, each
row scaled by its largest magnitude over 448.

A family's reference (``families/<family>.py``, ``logits``) builds its
decoder from these and computes the whole of every ``Sequence_``: no cache.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def full_f32():
    """Float32 matmuls with TF32 off, the flags restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def unpack_int4(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(IN/2, OUT) bytes and (IN/G, OUT) scales -> W (IN, OUT) float32."""
    u = packed.to(torch.int32) & 0xFF
    lo, hi = u & 0xF, u >> 4
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    half, out = packed.shape
    q = torch.stack([lo, hi], dim=1).reshape(2 * half, out).float()
    groups = scales.shape[0]
    return (q.reshape(groups, -1, out) * scales[:, None, :].float()).reshape(2 * half, out)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a row (its largest |x| / 448)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, D) rotated at positions 0 .. T - 1."""
    t, _, d = x.shape
    half = d // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1).float()[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1).float()[:, None, :]
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def causal_attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """q (T, H, D), k and v (T, KVH, D) -> (T, H * D), queries in blocks."""
    t, h, d = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)  # (H, T, D)
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = []
    for s in range(0, t, block):
        qb = q[s:s + block].transpose(0, 1)  # (H, b, D)
        scores = qb @ k.transpose(1, 2) * d ** -0.5  # (H, b, T)
        rows = torch.arange(s, s + qb.shape[1], device=q.device)[:, None]
        scores = scores.masked_fill(torch.arange(t, device=q.device)[None, :] > rows,
                                    float("-inf"))
        out.append((scores.softmax(dim=-1) @ v).transpose(0, 1).reshape(qb.shape[1], h * d))
    return torch.cat(out)


def patch_embeddings(cfg: dict, w: Dict[str, torch.Tensor], values: np.ndarray,
                     device) -> torch.Tensor:
    """One series' patch embeddings (ceil(L / patch), hidden)."""
    p = cfg["ts"]["patch_size"]
    x = torch.as_tensor(values, dtype=torch.float32, device=device)
    n = -(-x.shape[0] // p)
    x = torch.cat([x, x[-1:].expand(n * p - x.shape[0])]).reshape(n, p)
    layers = cfg["ts"]["num_layers"]
    for i in range(layers):
        x = x @ w[f"ts.{i}.kernel"].float() + w[f"ts.{i}.bias"].float()
        if i < layers - 1:
            x = F.gelu(x)
    return x


class Sequence_:
    """One sequence to run: its ids, its series and where their patches go,
    and the positions whose logits are wanted."""

    def __init__(self, ids: List[int], values: List[np.ndarray], starts: List[int],
                 wanted: Sequence[int]):
        self.ids, self.values, self.starts, self.wanted = ids, values, starts, list(wanted)
