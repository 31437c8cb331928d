"""Multi-segment trend machinery: keypoints, PCHIP curves, English narration.

The port's copy of ``chatts_tpu/datagen/trends.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference trend utilities
(reference: chatts/ts_generator/trend_utils.py:21-249) with an explicit
``numpy.random.Generator`` instead of global random state.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
from scipy.interpolate import PchipInterpolator

Point = Tuple[int, float]


def generate_random_points(
    rng: np.random.Generator, seq_len: int
) -> Tuple[List[Point], str]:
    """0-3 turning points with min gap ceil(seq_len/8), extra distance
    distributed uniformly over gaps (reference: trend_utils.py:21-72)."""
    min_distance = math.ceil(seq_len / 8)
    num_turning = int(rng.integers(0, 4))
    total_points = 2 + num_turning
    total_distance = seq_len - 1
    extra = total_distance - (total_points - 1) * min_distance
    while extra < 0 and num_turning > 0:
        num_turning -= 1
        total_points = 2 + num_turning
        extra = total_distance - (total_points - 1) * min_distance
    if extra < 0:
        raise ValueError("seq_len is too small")

    gaps = [min_distance] * (total_points - 1)
    for _ in range(extra):
        gaps[int(rng.integers(0, total_points - 1))] += 1
    key_x = [0]
    for g in gaps:
        key_x.append(key_x[-1] + g)
    key_y = rng.uniform(-1, 1, total_points)
    curve_type = "Bezier" if rng.random() < 0.99 else "Straight Line"
    return list(zip(key_x, key_y)), curve_type


def generate_trend_curve(
    rng: np.random.Generator, seq_len: int, points: List[Point]
) -> Tuple[np.ndarray, np.ndarray, str]:
    """PCHIP interpolation through keypoints (1% straight-line variant)
    (reference: trend_utils.py:74-101)."""
    key_x = [p[0] for p in points]
    key_y = [p[1] for p in points]
    x = np.arange(seq_len)
    if rng.random() < 0.99:
        y = PchipInterpolator(key_x, key_y)(x)
        return x, y, "Bezier"
    return x, np.interp(x, key_x, key_y), "Straight Line"


def _segment_trends(points: List[Point], labels: Tuple[str, str, str]) -> List[Tuple[str, int, int]]:
    """Classify each keypoint gap as up/down/flat against 10% of the y-range,
    merging consecutive equal labels.  Returns (label, start_idx, end_idx)
    where indices are positions in ``points``."""
    up, down, flat = labels
    ys = [y for _, y in points]
    y_range = max(ys) - min(ys) or 1.0
    raw = []
    for i in range(len(points) - 1):
        dy = points[i + 1][1] - points[i][1]
        if dy > 0.1 * y_range:
            raw.append(up)
        elif dy < -0.1 * y_range:
            raw.append(down)
        else:
            raw.append(flat)
    merged = []
    cur, start = raw[0], 0
    for i in range(1, len(raw)):
        if raw[i] != cur:
            merged.append((cur, start, i))
            cur, start = raw[i], i
    merged.append((cur, start, len(raw)))
    return merged


def generate_trend_prompt(points: List[Point]) -> str:
    """English narration of merged trend segments
    (reference: trend_utils.py:103-193)."""
    if not points or len(points) < 2:
        return "Insufficient points to determine trends."
    merged = _segment_trends(points, ("increasing", "decreasing", "stable"))
    sentences = []
    for trend, start, end in merged:
        article = {
            "increasing": "an increasing trend",
            "decreasing": "a decreasing trend",
            "stable": "a stable trend",
        }[trend]
        variation = " with some variation in slope" if end - start > 1 else ""
        sentences.append(
            f"From point {points[start][0]} to point {points[end][0]}, "
            f"there is {article}{variation}."
        )
    return " ".join(sentences)


def generate_trend_list(
    points: List[Point], seq_len: int
) -> List[Tuple[str, int, int]]:
    """[(increase/decrease/steady, start_point, end_point)] with the final
    segment extended to seq_len - 1 (reference: trend_utils.py:195-249)."""
    if not points or len(points) < 2:
        return []
    merged = _segment_trends(points, ("increase", "decrease", "steady"))
    out = []
    for i, (trend, start, end) in enumerate(merged):
        end_x = seq_len - 1 if i == len(merged) - 1 else points[end][0]
        out.append((trend, points[start][0], end_x))
    return out
