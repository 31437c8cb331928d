"""A plain float32 reference of the DeepSeek-V3 decoder block at any width
(Moonlight-16B-A3B's by default): the full forward pass of one sequence, no
cache, no kernels, no batching, in plain ``torch``.  It imports nothing of
the JAX package or of the port, so tests can hold both to it.

The equations are the published ones (``transformers``'
``DeepseekV3ForCausalLM``, and DeepSeek-V2's paper for MLA), un-absorbed:

- x = embed(ids); each layer: x += attn(rmsnorm(x)); x += ff(rmsnorm(x));
  logits = rmsnorm(x) @ head.
- attn: q = x @ Wq split per head into q_nope and q_pe; [c, k_pe] = x @ Wkv_a;
  c = rmsnorm(c); [k_nope, v] = c @ Wkv_b per head; q_pe and k_pe (one, shared
  by the heads) de-interleaved (even elements, then odd) and rotated
  rotate-half with inverse frequencies theta ** (-2i / rope) at positions
  0 .. T - 1; causal softmax of (q_nope . k_nope + q_pe . k_pe) / sqrt(nope +
  rope); the heads' outputs concatenated through Wo.
- ff: dense SiLU MLP down(silu(x @ gate) * (x @ up)) in the first
  ``first_k_dense_replace`` layers; after them the routed experts: scores =
  sigmoid(x @ router), the top k of scores + bias, weights = the chosen
  scores normalised to sum 1 (plus 1e-20) times the scaling factor, out =
  sum over the chosen of weight * expert(x), plus the shared experts' MLP.

Departures from the published code: none in the arithmetic.  Each token's
experts are computed for that token alone (the published code gathers an
expert's tokens first; the sums are the same), everything is float32
(the published model runs in bf16 with an f32 router and softmax), and the
choice of the top k takes ``torch.topk``'s sorted order (the published one
takes ``sorted=False``; only the order of the k terms of the sum differs).

Weights are a dict of float tensors, (in, out) orientation:
``embed`` (V, H), ``norm`` (H,), ``head`` (H, V), and ``layers``, one dict a
layer: ``ln1``, ``ln2`` (H,); ``q`` (H, heads*(nope+rope)); ``kv_a``
(H, latent+rope); ``kv_a_norm`` (latent,); ``kv_b`` (latent,
heads*(nope+v)); ``o`` (heads*v, H); a dense layer ``gate``, ``up`` (H, I),
``down`` (I, H); an expert layer ``router`` (H, E), ``bias`` (E,),
``experts_gate``, ``experts_up`` (E, H, Ie), ``experts_down`` (E, Ie, H),
``shared_gate``, ``shared_up`` (H, Is), ``shared_down`` (Is, H).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    return x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, D) de-interleaved, then rotated at positions 0 .. T - 1."""
    x = deinterleave(x)
    t, _, d = x.shape
    half = d // 2
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    ang = torch.arange(t, dtype=torch.float32)[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1)[:, None, :]
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def mlp(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor):
    return (F.silu(x @ gate) * (x @ up)) @ down


def attention(cfg: dict, lw: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    t = x.shape[0]
    h, nope, rp, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                       cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    latent = cfg["kv_lora_rank"]
    q = (x @ lw["q"]).reshape(t, h, nope + rp)
    q_nope, q_pe = q.split([nope, rp], dim=-1)
    c, k_pe = (x @ lw["kv_a"]).split([latent, rp], dim=-1)
    c = rms_norm(c, lw["kv_a_norm"], cfg["rms_norm_eps"])
    k_nope, v = (c @ lw["kv_b"]).reshape(t, h, nope + vd).split([nope, vd], dim=-1)
    q_pe = rope(q_pe, cfg["rope_theta"])
    k_pe = rope(k_pe[:, None, :], cfg["rope_theta"])  # (T, 1, rope)
    scores = (torch.einsum("qhd,khd->hqk", q_nope, k_nope)
              + torch.einsum("qhd,kd->hqk", q_pe, k_pe[:, 0])) * (nope + rp) ** -0.5
    causal = torch.ones((t, t), dtype=torch.bool).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", scores.softmax(dim=-1), v)
    return out.reshape(t, h * vd) @ lw["o"]


def experts(cfg: dict, lw: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    scores = torch.sigmoid(x @ lw["router"])
    idx = torch.topk(scores + lw["bias"], cfg["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(1, idx)
    if cfg.get("norm_topk_prob", True):
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for i in range(x.shape[0]):
        for j in range(idx.shape[1]):
            e = int(idx[i, j])
            out[i] += w[i, j] * mlp(x[i], lw["experts_gate"][e], lw["experts_up"][e],
                                    lw["experts_down"][e])
    return out + mlp(x, lw["shared_gate"], lw["shared_up"], lw["shared_down"])


@torch.no_grad()
def forward(cfg: dict, w: dict, ids: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The logits (T, V) of one sequence, from its token ids (T,) or its
    input embeddings (T, H)."""
    x = (w["embed"][ids] if embeds is None else embeds).float()
    eps = cfg["rms_norm_eps"]
    for i, lw in enumerate(w["layers"]):
        x = x + attention(cfg, lw, rms_norm(x, lw["ln1"], eps))
        normed = rms_norm(x, lw["ln2"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + mlp(normed, lw["gate"], lw["up"], lw["down"])
        else:
            x = x + experts(cfg, lw, normed)
    return rms_norm(x, w["norm"], eps) @ w["head"]
