"""Peaks and kernel bounds: the arithmetic behind every roofline and
utilization the benchmark reports, shared by every family.  A family gives
its own model FLOPs (``request_flops``) and the bound of each of its
launches, from these.

The peaks are NVIDIA's data sheet figures for one H100 SXM at its full power
limit of 700 W (dense, no sparsity).  A launch's bound is the larger of its
bytes over the memory rate and its operations over the bf16 tensor rate,
each input byte read once and each output byte written once (the arithmetic
of ``chip_smoke.py``'s ``bound`` and ``int4_bound``, copied).
"""
from __future__ import annotations

from typing import Iterable

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
