"""Token sampling: greedy / temperature / top-k / top-p, and per-slot sampling
for the serving engine.

Counterpart of ``chatts_tpu/runtime/sampling.py``.  Randomness comes from an
explicit ``torch.Generator`` on the logits' device; a categorical draw is the
Gumbel-max trick, as ``jax.random.categorical`` does it.  The two frameworks
draw different bits, so sampled tokens match the JAX package in distribution,
not token for token; the top-k and top-p masks are deterministic and match
exactly.
"""
from __future__ import annotations

import torch

from chatts_tpu_torch.core.config import GenerationConfig

NEG_INF = torch.finfo(torch.float32).min


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit.  logits: (..., V)."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of sorted probabilities with
    cumulative mass >= p (the top token is always kept)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p  # mass before position i is < p
    threshold = torch.where(keep_sorted, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, NEG_INF, logits)


def sample(logits: torch.Tensor, generator: torch.Generator,
           gen_cfg: GenerationConfig) -> torch.Tensor:
    """Next token ids (B,) int32 from logits (B, V) f32."""
    if gen_cfg.greedy or gen_cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / gen_cfg.temperature
    if gen_cfg.top_k > 0:
        logits = apply_top_k(logits, gen_cfg.top_k)
    if gen_cfg.top_p < 1.0:
        logits = apply_top_p(logits, gen_cfg.top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


# Candidate cap for per-slot sampling, as in the JAX package: nucleus
# filtering runs inside the top-64 candidates instead of over a sorted
# vocabulary.  Probability mass beyond the top 64 tokens is negligible at
# serving temperatures.
TOP_K_CAP = 64


def sample_per_slot(
    logits: torch.Tensor,  # (B, V) f32
    generator: torch.Generator,
    temperature: torch.Tensor,  # (B,) f32; <= 0 means greedy
    top_p: torch.Tensor,  # (B,) f32; >= 1 disables the filter
) -> torch.Tensor:
    """Next token ids (B,) int32, each row with its own request's temperature
    and top_p: the port of ``sampling.sample_per_slot``.  The Gumbel noise
    for the candidates is drawn on every call, greedy rows included, so the
    generator advances the same way whatever the rows' settings."""
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    safe_temp = torch.where(temperature > 0, temperature, 1.0)
    scaled = logits / safe_temp[:, None]

    k = min(TOP_K_CAP, scaled.shape[-1])
    vals, idx = torch.topk(scaled, k, dim=-1)  # (B, K) descending
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < torch.clamp(top_p, 0.0, 1.0)[:, None]
    filtered = torch.where(keep, vals, NEG_INF)
    filtered = torch.where(top_p[:, None] >= 1.0, vals, filtered)

    u = torch.rand(filtered.shape, generator=generator, device=logits.device)
    choice = torch.argmax(filtered - torch.log(-torch.log(u)), dim=-1)
    sampled = idx.gather(1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy_tok)
