"""Univariate template alignment QA.

The port's copy of ``chatts_tpu/datagen/align/uts_template_qa.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference pipeline
(reference: chatts/align/uts_template_qa.py:37-138): random attributes ->
series -> five QA kinds (shape, shape+values, per-change yes-probe,
non-change no-probe, JSON dump), emitted as ``{input, output, timeseries}``
jsonl rows.  Random-length ladder includes the 5-64 and 1024-4096 tails
unless extreme lengths are disabled.

Differences by design: pure functions over an explicit generator/seed (the
reference reads YAML at import and uses global RNG), so tests and parallel
workers are deterministic.
"""
from __future__ import annotations

import copy
import json
from typing import Iterator, List, Optional

from chatts_tpu_torch.core.encoding import timeseries_encoding, timeseries_to_list
from chatts_tpu_torch.datagen.generator import TimeSeriesGenerator, attribute_to_text


def sample_seq_len(gen: TimeSeriesGenerator, disable_extreme: bool = False) -> int:
    """Length ladder (reference: uts_template_qa.py:52-63)."""
    rng = gen.rng
    p = rng.random()
    if p > 0.4:
        return 256
    if p > 0.1 or disable_extreme:
        return int(rng.integers(64, 1025))
    if p > 0.05:
        return int(rng.integers(5, 65))
    return int(rng.integers(1024, 4097))


def attribute_pool_to_json(attribute_pool: dict) -> str:
    """Public JSON dump: strip internals (reference:
    uts_template_qa.py:37-49)."""
    result = copy.deepcopy(attribute_pool)
    for c in result.get("local", []):
        c["amplitude"] = round(c["amplitude"], 2)
    result.pop("overall_amplitude", None)
    result.pop("overall_bias", None)
    result.pop("statistics", None)
    if "trend_list" in result.get("trend", {}):
        del result["trend"]["trend_list"]
    return json.dumps(result, ensure_ascii=False)


def generate_single(
    gen: TimeSeriesGenerator,
    seq_len: Optional[int] = None,
    encoding_method: str = "no",
    disable_extreme: bool = False,
) -> List[dict]:
    """One synthetic series -> list of QA samples."""
    rng = gen.rng
    cur_len = seq_len if seq_len is not None else sample_seq_len(gen, disable_extreme)

    pool = gen.generate_random_attributes(seq_len=cur_len)
    ts, pool = gen.generate(pool, cur_len)
    scaled_ts, ts_prompt, _ = timeseries_encoding(ts, encoding_method)

    instruction = f"There is a time series of length {cur_len}: {ts_prompt}."
    questions, answers = [], []

    questions.append(
        "Now, please analyze the characteristics of this time series from the "
        "perspectives of periodicity, trend, local characteristics, frequency "
        "characteristics, and noise."
    )
    answers.append(attribute_to_text(ts, pool, generate_values=False))

    questions.append(
        "Now, please analyze the characteristics of this time series from the "
        "perspectives of periodicity, trend, local characteristics, frequency "
        "characteristics, and noise. Also include the approximate mean values "
        "for every 16 points, as well as the maximum and minimum values of the "
        "time series (rounded to 2 decimal places)."
    )
    answers.append(attribute_to_text(ts, pool, generate_values=True))

    for local_char in pool["local"]:
        probe = local_char["position_start"] + int(rng.integers(-5, 6))
        questions.append(
            f"Is there a local characteristic fluctuation starting around "
            f"point {probe} in this time series?"
        )
        answers.append("Yes, this time series " + local_char["detail"])

    change_positions = [c["position_start"] for c in pool["local"]]
    for _ in range(3):
        point = int(rng.integers(0, cur_len))
        if all(abs(point - p) >= 50 for p in change_positions):
            questions.append(
                f"Is there a local characteristic fluctuation starting around "
                f"point {point} in this time series?"
            )
            answers.append(
                f"I did not find any local characteristic fluctuation starting "
                f"around point {point} in this time series."
            )

    questions.append(
        "Please output the characteristics of the current time series in JSON "
        "format, including periodicity, trend, local characteristics, "
        "frequency characteristics, and noise fields."
    )
    answers.append(attribute_pool_to_json(pool))

    return [
        {
            "instruction": instruction,
            "question": q,
            "answer": a,
            "timeseries": [scaled_ts],
            "original_timeseries": [ts],
        }
        for q, a in zip(questions, answers)
    ]


def generate_samples(
    num_data: int,
    seed: int = 0,
    seq_len: Optional[int] = None,
    encoding_method: str = "no",
    disable_extreme: bool = False,
) -> Iterator[dict]:
    """Yield jsonl-ready rows until ``num_data`` produced (rejection sampling
    on generation errors, reference policy: uts_template_qa.py:120-126)."""
    gen = TimeSeriesGenerator(seed=seed)
    cnt = 0
    while cnt < num_data:
        try:
            result = generate_single(gen, seq_len, encoding_method, disable_extreme)
        except (ValueError, IndexError):
            continue
        for item in result:
            yield {
                "input": item["instruction"][:-1] + ". " + item["question"],
                "output": item["answer"],
                "timeseries": timeseries_to_list(item["timeseries"]),
            }
            cnt += 1
            if cnt >= num_data:
                break


def main(
    output_path: str,
    num_data: int = 100,
    seed: int = 0,
    seq_len: Optional[int] = None,
    encoding_method: str = "no",
) -> int:
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
    p.add_argument("--output", default="data/uts_template_qa.jsonl")
    p.add_argument("--num-data", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--encoding", default="no")
    args = p.parse_args()
    n = main(args.output, args.num_data, args.seed, args.seq_len, args.encoding)
    print(f"wrote {n} rows to {args.output}")
