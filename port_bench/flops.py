"""Peaks, bounds and model FLOPs: the arithmetic behind every roofline and
utilization the benchmark reports.

The peaks are NVIDIA's data sheet figures for one H100 SXM at its full power
limit of 700 W (dense, no sparsity).  A launch's bound is the larger of its
bytes over the memory rate and its operations over the bf16 tensor rate,
each input byte read once and each output byte written once (the arithmetic
of ``chip_smoke.py``'s ``bound`` and ``int4_bound``, copied).
"""
from __future__ import annotations

from typing import Iterable, Tuple

PEAK_BYTES_S = 3.35e12
PEAK_BF16_S = 989e12
GROUP = 128


def bound_s(nbytes: float, ops: float, peak: float = PEAK_BF16_S) -> float:
    """The least time a launch could take: bytes at the memory rate or
    operations at ``peak``, the larger."""
    return max(nbytes / PEAK_BYTES_S, ops / peak)


def int4_bound_s(r: int, in_dim: int, out_dim: int) -> float:
    """``int4_matmul``: packed weights, scales, x and y once each (bf16 x and
    y); 2 R IN OUT operations."""
    nbytes = in_dim * out_dim // 2 + in_dim // GROUP * out_dim * 4 + 2 * r * (in_dim + out_dim)
    return bound_s(nbytes, 2.0 * r * in_dim * out_dim)


def flash_bound_s(heads: int, kv_heads: int, head_dim: int, queries: int, keys: int,
                  pairs: int) -> float:
    """``flash_attention`` over ``queries`` query rows (each of ``heads``
    heads), ``keys`` key rows (of ``kv_heads`` heads) and ``pairs`` causal
    (query, key) pairs of a head: q, k, v and the output once each in bf16;
    4 head_dim operations a pair and head (QK and PV)."""
    nbytes = 2 * head_dim * (2 * queries * heads + 2 * keys * kv_heads)
    return bound_s(nbytes, 4.0 * head_dim * heads * pairs)


def prefix_pairs(lengths: Iterable[int]) -> int:
    """Causal pairs of whole prompts: L (L + 1) / 2 each."""
    return sum(n * (n + 1) // 2 for n in lengths)


def span_pairs(start: int, stop: int) -> int:
    """Causal pairs of the queries at positions [start, stop) of one prompt,
    each attending every position up to its own: sum of (q + 1)."""
    return (stop * (stop + 1) - start * (start + 1)) // 2 if stop > start else 0


def layer_matmul_params(cfg: dict) -> int:
    """The projection weights of one decoder layer."""
    hid, inter = cfg["hidden_size"], cfg["intermediate_size"]
    h, kvh, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    return hid * (h + 2 * kvh) * d + h * d * hid + hid * 2 * inter + inter * hid


def token_flops(cfg: dict, context: int) -> float:
    """Forward FLOPs of one token that attends ``context`` keys, without the
    head: 2 per projection weight, 4 head_dim a key and head."""
    n, h, d = cfg["num_hidden_layers"], cfg["num_attention_heads"], cfg["head_dim"]
    return n * (2.0 * layer_matmul_params(cfg) + 4.0 * h * d * context)


def head_flops(cfg: dict) -> float:
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def prefill_flops(cfg: dict, prompt: int) -> float:
    """A whole prompt's prefill: every token, attending its causal prefix,
    and the head once (the first token's logits)."""
    n, h, d = cfg["num_hidden_layers"], cfg["num_attention_heads"], cfg["head_dim"]
    return (prompt * n * 2.0 * layer_matmul_params(cfg)
            + n * 4.0 * h * d * prefix_pairs([prompt]) + head_flops(cfg))


def decode_flops(cfg: dict, prompt: int, first: int, count: int) -> float:
    """Output tokens ``first`` .. ``first + count - 1`` (0 is the prefill's):
    token j runs output j - 1 at position prompt + j - 1, attending
    prompt + j keys, and the head."""
    n, h, d = cfg["num_hidden_layers"], cfg["num_attention_heads"], cfg["head_dim"]
    keys = span_pairs(prompt + first - 1, prompt + first - 1 + count)
    return count * (n * 2.0 * layer_matmul_params(cfg) + head_flops(cfg)) + n * 4.0 * h * d * keys


def request_flops(cfg: dict, prompt: int, puts: Iterable[Tuple[float, int]]):
    """(time, FLOPs) of each delivery of one request's tokens: the first
    carries the prefill, the rest the decode steps that made them."""
    out, done = [], 0
    for t, n in puts:
        f = 0.0
        if done == 0:
            f += prefill_flops(cfg, prompt)
            if n > 1:
                f += decode_flops(cfg, prompt, 1, n - 1)
        else:
            f += decode_flops(cfg, prompt, done, n)
        out.append((t, f))
        done += n
    return out
