"""Multivariate trend-correlation alignment QA.

The port's copy of ``chatts_tpu/datagen/align/mts_shape_template_qa.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference pipeline
(reference: chatts/align/mts_shape_template_qa.py:36-252): a positive group
shares jittered PCHIP trend keypoints; negatives get fresh keypoints or a
one-point perturbation; QAs cover per-series trend narration and pairwise
trend correlation with difference localization.
"""
from __future__ import annotations

import copy
import json
from typing import Iterator, List, Optional, Tuple

import numpy as np

from chatts_tpu_torch.core.encoding import timeseries_encoding, timeseries_to_list
from chatts_tpu_torch.datagen import trends as trends_lib
from chatts_tpu_torch.datagen.generator import TimeSeriesGenerator

# Shape-task attribute pools (reference: mts_shape_template_qa.py:37-64).
SHAPE_CONFIG = {
    "overall_attribute": {
        "seasonal": {"no periodic fluctuation": 0.9, "periodic fluctuation": 0.1},
        "trend": {"keep steady": 0.6},
        "frequency": {"high frequency": 0.5, "low frequency": 0.5},
        "noise": {"noisy": 0.1, "almost no noise": 0.9},
    },
    "change": {
        "shake": 2,
        "upward spike": 10,
        "downward spike": 6,
        "continuous upward spike": 4,
        "continuous downward spike": 2,
        "wide upward spike": 3,
        "wide downward spike": 3,
    },
}


def _base_series(gen: TimeSeriesGenerator, seq_len: int):
    rng = gen.rng
    changes = [(None, None)] if rng.random() > 0.8 else []
    pool = gen.generate_random_attributes(
        SHAPE_CONFIG["overall_attribute"], SHAPE_CONFIG["change"],
        changes, seq_len,
    )
    return gen.generate(pool, seq_len)


def _add_trend(gen, ts, pool, points, seq_len):
    _, curve_y, _ = trends_lib.generate_trend_curve(gen.rng, seq_len, points)
    if curve_y.max() - curve_y.min() > 1e-3:
        ts = ts + (
            curve_y
            / (curve_y.max() - curve_y.min())
            * pool["overall_amplitude"]
            * gen.rng.uniform(3.0, 15.0)
        )
    return ts


def generate_positive(gen: TimeSeriesGenerator, cnt: int, seq_len: int):
    """Positives share jittered keypoints (reference:
    mts_shape_template_qa.py:67-95)."""
    rng = gen.rng
    points, _ = trends_lib.generate_random_points(rng, seq_len)
    timeseries, attributes = [], []
    for _ in range(cnt):
        ts, pool = _base_series(gen, seq_len)
        y_range = max(p[1] for p in points) - min(p[1] for p in points)
        points = [
            (
                min(max(0, x + int(rng.integers(-5, 6))), seq_len - 1),
                y + rng.uniform(-0.05, 0.05) * y_range,
            )
            for x, y in points
        ]
        ts = _add_trend(gen, ts, pool, points, seq_len)
        timeseries.append(ts)
        attributes.append(pool)
    return timeseries, attributes, points


def generate_negative(gen: TimeSeriesGenerator, cnt: int, positive_points, seq_len: int):
    """Negatives: fresh keypoints or a one-point perturbation (reference:
    mts_shape_template_qa.py:98-137)."""
    rng = gen.rng
    timeseries, attributes, different_type, result_points = [], [], [], []
    for _ in range(cnt):
        ts, pool = _base_series(gen, seq_len)
        if rng.random() > 0.7 or len(positive_points) <= 3:
            points, _ = trends_lib.generate_random_points(rng, seq_len)
            different_type.append(None)
        else:
            points = copy.deepcopy(positive_points)
            i = int(rng.integers(0, len(points)))
            y_range = max(p[1] for p in points) - min(p[1] for p in points)
            diff = float(rng.choice([-1, 1])) * rng.uniform(0.5, 1.0) * y_range
            points[i] = (
                min(max(0, points[i][0] + int(rng.integers(-5, 6))), seq_len - 1),
                points[i][1] + diff,
            )
            different_type.append((i, diff))
        ts = _add_trend(gen, ts, pool, points, seq_len)
        result_points.append(points)
        timeseries.append(ts)
        attributes.append(pool)
    return timeseries, attributes, different_type, result_points


def generate_one_mts(
    gen: TimeSeriesGenerator,
    seq_len: Optional[int] = None,
    encoding_method: str = "no",
):
    rng = gen.rng
    if seq_len is None:
        cur_len = 256 if rng.random() > 0.4 else int(rng.integers(64, 1025))
    else:
        cur_len = seq_len

    n_pos = int(rng.integers(2, 5))
    n_neg = int(rng.integers(0, 6))
    pos_ts, pos_attr, pos_points = generate_positive(gen, n_pos, cur_len)
    neg_ts, neg_attr, neg_diff, neg_points = generate_negative(
        gen, n_neg, pos_points, cur_len
    )

    order = rng.permutation(n_pos + n_neg)
    all_ts = pos_ts + neg_ts
    all_attr = pos_attr + neg_attr
    all_diff = [None] * n_pos + neg_diff
    all_points = [pos_points] * n_pos + neg_points
    all_ts = [all_ts[i] for i in order]
    all_attr = [all_attr[i] for i in order]
    all_diff = [all_diff[i] for i in order]
    all_points = [all_points[i] for i in order]
    argsort = np.argsort(order)
    positive_idx = set(int(i) for i in argsort[:n_pos])

    prompt = f"There are {len(order)} time series:"
    questions, answers = [], []
    encoded = []
    for i in range(len(order)):
        scaled, frag, _ = timeseries_encoding(all_ts[i], encoding_method)
        encoded.append(scaled)
        prompt += f" Time series {i + 1} is of length {cur_len}: {frag};"

        questions.append(f"Analyze the trend of time series {i + 1} in detail.")
        answers.append(trends_lib.generate_trend_prompt(all_points[i]))

        for j in range(len(order)):
            if rng.random() > 0.6:
                continue
            if i not in positive_idx and j not in positive_idx:
                continue
            if i == j:
                continue
            questions.append(
                f"Based on the **trend** characteristics analyze whether there "
                f"may be a correlation of trend between time series {i + 1} "
                f"and time series {j + 1}."
            )
            if i in positive_idx and j in positive_idx:
                ans = (
                    " Both time series are showing similar trends, indicating "
                    "a possible correlation in terms of trend: "
                    + trends_lib.generate_trend_prompt(all_points[i])
                )
            else:
                # Exactly one of i, j is negative.
                neg, pos = (j, i) if i in positive_idx else (i, j)
                diff = all_diff[neg]
                if diff is None:
                    ans = (
                        f"Time series {j + 1} is totally different from time "
                        f"series {i + 1} in terms of trend. The trend of time "
                        f"series {i + 1} is: "
                        + trends_lib.generate_trend_prompt(all_points[i])
                        + f". While the trend of time series {j + 1} is: "
                        + trends_lib.generate_trend_prompt(
                            all_points[j] if neg == j else pos_points
                        )
                    )
                else:
                    where = int(all_points[neg][diff[0]][0])
                    higher = "higher" if diff[1] > 0 else "lower"
                    ans = (
                        f"Time series {j + 1} is different from time series "
                        f"{i + 1} in terms of trend. Although the trend "
                        f"between may be similar in some parts, their trends "
                        f"near point {where} are different, where time series "
                        f"{neg + 1} has a {higher} trend than time series "
                        f"{pos + 1}."
                    )
            answers.append(ans)

    return all_ts, encoded, all_attr, prompt, questions, answers


def generate_samples(
    num_data: int,
    seed: int = 0,
    seq_len: Optional[int] = None,
    encoding_method: str = "no",
) -> Iterator[dict]:
    gen = TimeSeriesGenerator(seed=seed)
    cnt = 0
    while cnt < num_data:
        try:
            _, encoded, _, prompt, questions, answers = generate_one_mts(
                gen, seq_len, encoding_method
            )
        except (ValueError, IndexError):
            continue
        for q, a in zip(questions, answers):
            yield {
                "input": prompt[:-1] + ". " + q,
                "output": a,
                "timeseries": timeseries_to_list(encoded),
            }
            cnt += 1
            if cnt >= num_data:
                break


def main(output_path: str, num_data: int = 100, seed: int = 0,
         seq_len: Optional[int] = None, encoding_method: str = "no") -> int:
    import os

    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    n = 0
    with open(output_path, "w") as f:
        for row in generate_samples(num_data, seed, seq_len, encoding_method):
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
            n += 1
    return n


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--output", default="data/mts_shape_template_qa.jsonl")
    p.add_argument("--num-data", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--encoding", default="no")
    args = p.parse_args()
    n = main(args.output, args.num_data, args.seed, args.seq_len, args.encoding)
    print(f"wrote {n} rows to {args.output}")
