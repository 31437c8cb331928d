"""Multivariate fluctuation-correlation alignment QA.

The port's copy of ``chatts_tpu/datagen/align/mts_local_template_qa.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference pipeline
(reference: chatts/align/mts_local_template_qa.py:36-255): a positive group
shares one change position (jittered +-10), negatives place changes elsewhere
or none, "same" series are re-generated from an identical realized attribute
pool; QA tasks are describe-one, describe-pair + correlation, find-related.
"""
from __future__ import annotations

import json
from typing import Iterator, List, Optional

import numpy as np

from chatts_tpu_torch.core.encoding import timeseries_encoding, timeseries_to_list
from chatts_tpu_torch.datagen.generator import TimeSeriesGenerator, attribute_to_text

# Fluctuation-task attribute pools (reference: mts_local_template_qa.py:37-78).
LOCAL_CONFIG = {
    "overall_attribute": {
        "seasonal": {"no periodic fluctuation": 0.7, "periodic fluctuation": 0.3},
        "trend": {"decrease": 0.2, "increase": 0.2, "keep steady": 0.6},
        "frequency": {"high frequency": 0.5, "low frequency": 0.5},
        "noise": {"noisy": 0.3, "almost no noise": 0.7},
    },
    "change": {
        "shake": 2,
        "upward spike": 10,
        "downward spike": 6,
        "continuous upward spike": 4,
        "continuous downward spike": 2,
        "upward convex": 2,
        "downward convex": 2,
        "sudden increase": 2,
        "sudden decrease": 2,
        "rapid rise followed by slow decline": 2,
        "slow rise followed by rapid decline": 2,
        "rapid decline followed by slow rise": 2,
        "slow decline followed by rapid rise": 2,
        "decrease after upward spike": 3,
        "increase after downward spike": 3,
        "increase after upward spike": 3,
        "decrease after downward spike": 3,
        "wide upward spike": 3,
        "wide downward spike": 3,
    },
}


def generate_positive(gen: TimeSeriesGenerator, cnt: int, seq_len: int):
    """Positives share one jittered change position (reference:
    mts_local_template_qa.py:85-101)."""
    rng = gen.rng
    change_position = int(rng.integers(int(0.02 * seq_len), int(0.95 * seq_len) + 1))
    timeseries, attributes = [], []
    for _ in range(cnt):
        pos = int(change_position + rng.uniform(-10, 10))
        pos = min(max(pos, 0), seq_len - 2)
        pool = gen.generate_random_attributes(
            LOCAL_CONFIG["overall_attribute"], LOCAL_CONFIG["change"],
            [(pos, None)], seq_len,
        )
        ts, pool = gen.generate(pool, seq_len)
        if not pool["local"]:
            raise ValueError("positive change was rejected")
        timeseries.append(ts)
        attributes.append(pool)
    return timeseries, attributes, change_position


def generate_negative(gen: TimeSeriesGenerator, cnt: int, positive_positions, seq_len: int):
    """Negatives: change far from positives, or no change (reference:
    mts_local_template_qa.py:103-137)."""
    rng = gen.rng
    min_interval = seq_len // 8
    negative_positions: List[int] = []
    timeseries, attributes = [], []
    for _ in range(cnt):
        changes = []
        if rng.random() > 0.8:
            for _ in range(10000):
                cand = int(
                    rng.integers(int(0.02 * seq_len), int(0.95 * seq_len) + 1)
                )
                if all(
                    abs(cand - p) > min_interval
                    for p in list(positive_positions) + negative_positions
                ):
                    negative_positions.append(cand)
                    changes = [(cand, None)]
                    break
        pool = gen.generate_random_attributes(
            LOCAL_CONFIG["overall_attribute"], LOCAL_CONFIG["change"],
            changes, seq_len,
        )
        ts, pool = gen.generate(pool, seq_len)
        timeseries.append(ts)
        attributes.append(pool)
    return timeseries, attributes


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
    n_same = int(rng.integers(0, 3))

    pos_ts, pos_attr, change_position = generate_positive(gen, n_pos, cur_len)
    neg_ts, neg_attr = generate_negative(gen, n_neg, [change_position], cur_len)
    same_ts, same_attr = [], []
    for _ in range(n_same):
        # Re-generate from the identical realized pool -> a near-duplicate
        # series (reference: mts_local_template_qa.py:156-160).
        import copy as _copy

        ts, pool = gen.generate(_copy.deepcopy(pos_attr[0]), cur_len)
        same_ts.append(ts)
        same_attr.append(pool)

    order = rng.permutation(n_pos + n_neg + n_same)
    all_ts = pos_ts + neg_ts + same_ts
    all_attr = pos_attr + neg_attr + same_attr
    all_ts = [all_ts[i] for i in order]
    all_attr = [all_attr[i] for i in order]
    argsort = np.argsort(order)
    positive_idx = set(int(i) for i in argsort[:n_pos])
    negative_idx = set(int(i) for i in argsort[n_pos : n_pos + n_neg])
    same_idx = set(int(i) for i in argsort[n_pos + n_neg :])
    order_list = [int(x) for x in order]

    prompt = f"There are {len(order)} time series:"
    questions, answers = [], []
    encoded = []
    for i in range(len(order)):
        scaled, frag, _ = timeseries_encoding(all_ts[i], encoding_method)
        prompt += f" Time series {i + 1} is of length {cur_len}: {frag};"

        # Task 1: describe one series.
        questions.append(
            f"Based on the characteristics of the time series, please describe "
            f"the characteristics of time series {i + 1} from the aspects of "
            f"periodicity, trend, local characteristics, frequency "
            f"characteristics, and noise. Also include the approximate mean "
            f"values for every 16 points, as well as the maximum and minimum "
            f"values of the time series (rounded to 2 decimal places)."
        )
        answers.append(f"The {i + 1}th " + attribute_to_text(all_ts[i], all_attr[i]))

        # Task 2: describe a pair + correlation.
        for j in range(len(order)):
            if rng.random() < 0.7 or i == j:
                continue
            questions.append(
                f"Based on the characteristics of the time series, please "
                f"describe the characteristics of time series {i + 1} and time "
                f"series {j + 1} from the aspects of periodicity, trend, local "
                f"characteristics, frequency characteristics, and noise, and "
                f"analyze whether there may be a correlation of fluctuation "
                f"between them."
            )
            ans = (
                f" Time series {i + 1} "
                + attribute_to_text(all_ts[i], all_attr[i], generate_values=False)
                + f" Time series {j + 1} "
                + attribute_to_text(all_ts[j], all_attr[j], generate_values=False)
            )
            same_pair = (
                (i in same_idx and order_list[j] == 0)
                or (j in same_idx and order_list[i] == 0)
                or (i in same_idx and j in same_idx)
            )
            related_pair = (
                (i in positive_idx and j in positive_idx)
                or (i in positive_idx and j in same_idx)
                or (j in positive_idx and i in same_idx)
            )
            if same_pair:
                ans += (
                    f" Both time series have very similar periodicity, trend, "
                    f"local characteristics, frequency characteristics, and "
                    f"noise characteristics, and both show sudden changes "
                    f"around point {change_position}, indicating a strong "
                    f"correlation in terms of both overall trend and "
                    f"fluctuations."
                )
            elif related_pair:
                ans += (
                    f" Both time series show sudden changes around point "
                    f"{change_position}, indicating a possible correlation in "
                    f"terms of fluctuation."
                )
            else:
                ans += (
                    " These two time series do not seem to have much "
                    "correlation in terms of fluctuation."
                )
            answers.append(ans)

        # Task 3: find related series.
        questions.append(
            f"Based on the fluctuations in the time series, please find other "
            f"time series that may be related to time series {i + 1}, output "
            f"their numbers, and explain the reasons. If no related time "
            f"series are found, output that no related time series were found."
        )
        if i in negative_idx:
            ans = (
                f"Among these time series, I did not find any other time "
                f"series that may be related to time series {i + 1} in terms "
                f"of fluctuation."
            )
        else:
            ans = (
                f"I found the following time series that may be related to "
                f"time series {i + 1} in terms of fluctuation:"
            )
            i_change = all_attr[i]["local"][0]["type"]
            for j in range(len(order)):
                if i == j or j in negative_idx:
                    continue
                j_change = all_attr[j]["local"][0]["type"]
                if i_change == j_change:
                    ans += (
                        f" Time series {i + 1} and time series {j + 1} both "
                        f"show {i_change} around point {change_position}, "
                        f"indicating a possible correlation in terms of "
                        f"fluctuation."
                    )
                else:
                    ans += (
                        f" Time series {i + 1} shows {i_change} around point "
                        f"{change_position}, while time series {j + 1} shows "
                        f"{j_change} around this point, indicating a possible "
                        f"correlation in terms of fluctuation."
                    )
        answers.append(ans)
        encoded.append(scaled)

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
    p.add_argument("--output", default="data/mts_local_template_qa.jsonl")
    p.add_argument("--num-data", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--encoding", default="no")
    args = p.parse_args()
    n = main(args.output, args.num_data, args.seed, args.seq_len, args.encoding)
    print(f"wrote {n} rows to {args.output}")
