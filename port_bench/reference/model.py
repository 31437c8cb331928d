"""ChatTS's forward pass in plain PyTorch, float32, TF32 off.

Qwen2 (qkv bias) or Qwen3 (per-head RMSNorm on q and k, no bias) decoder
layers: x + attn(rmsnorm(x)), then x + mlp(rmsnorm(x)); attention is causal
grouped-query attention with rotate-half RoPE (inverse frequencies
theta ** (-2i / head_dim)) at positions 0 .. T - 1; the MLP is
down(silu(gate(x)) * up(x)); a final RMSNorm and the head give the logits.
The series go through the patch encoder, an MLP with exact GELU between its
layers over patches of ``patch_size`` values (a series padded to whole
patches with its last value), and each patch's embedding replaces the
embedding of its placeholder token.

Every int4 projection is unpacked from the benchmark's bytes here and
multiplied by its group scales in float32, one layer at a time, and the whole
of every sequence is computed: no cache.  ``lowered=True`` is the control,
the reference computed a precision below the bfloat16 the configurations
state: every tensor the program holds in bfloat16 (the merged embeddings,
the residual stream after each add, each norm's output, q, k and v, the
attention output, each projection's output, the MLP's activation) is
rounded to float8 e4m3, each row scaled by its largest magnitude over 448.
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


@torch.no_grad()
def logits(cfg: dict, w: Dict[str, torch.Tensor], seqs: List[Sequence_],
           lowered: bool = False) -> List[torch.Tensor]:
    """The logits (len(wanted), vocab) float32 of every sequence, computed
    layer by layer over all of them (one layer's weights unpacked at a
    time)."""
    dev = w["embed"].device
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h, kvh, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    inter = cfg["intermediate_size"]

    def lo(x):
        return to_fp8(x) if lowered else x

    with full_f32():
        xs = []
        for s in seqs:
            x = w["embed"][torch.as_tensor(s.ids, device=dev)].float()
            for values, start in zip(s.values, s.starts):
                e = patch_embeddings(cfg, w, values, dev)
                x[start:start + e.shape[0]] = e
            xs.append(lo(x))
        for i in range(cfg["num_hidden_layers"]):
            wq = {n: unpack_int4(w[f"{n}.q4"][i], w[f"{n}.s4"][i])
                  for n in ("qkv", "o", "gate_up", "down")}
            for j, x in enumerate(xs):
                t = x.shape[0]
                qkv = lo(rms_norm(x, w["ln1"][i], eps)) @ wq["qkv"]
                if cfg["attention_bias"]:
                    qkv = qkv + w["qkv.bias"][i].float()
                q, k, v = lo(qkv).split([h * d, kvh * d, kvh * d], dim=-1)
                q, k, v = q.reshape(t, h, d), k.reshape(t, kvh, d), v.reshape(t, kvh, d)
                if cfg["qk_norm"]:
                    q = lo(rms_norm(q, w["q_norm"][i], eps))
                    k = lo(rms_norm(k, w["k_norm"][i], eps))
                q, k = lo(rope(q, theta)), lo(rope(k, theta))
                att = lo(causal_attention(q, k, v))
                x = lo(x + lo(att @ wq["o"]))
                gate, up = lo(lo(rms_norm(x, w["ln2"][i], eps)) @ wq["gate_up"]).split(
                    [inter, inter], dim=-1)
                xs[j] = lo(x + lo(lo(F.silu(gate) * up) @ wq["down"]))
            del wq
        head = unpack_int4(w["head.q4"], w["head.s4"])
        out = []
        for s, x in zip(seqs, xs):
            hidden = lo(rms_norm(x[torch.as_tensor(s.wanted, device=dev)], w["norm"], eps))
            out.append(hidden @ head)
        return out
