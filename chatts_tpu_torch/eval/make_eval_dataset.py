"""Synthesize an evaluation dataset in the dataset_a format.

The port's copy of ``chatts_tpu/eval/make_eval_dataset.py``: the same numpy code, so a seed
gives the same bits in both packages.

The reference's eval datasets are external Zenodo downloads
(reference: README.md:75-77, evaluation/dataset/.gitkeep); this builder
produces samples with the exact schema ``evaluate_qa`` consumes
(question with <ts><ts/> holes + numbered sub-questions, ``timeseries``,
``ability_types``, ``attributes``, ``cols``, ``answer``) from the synthetic
generator's exact labels — so the full loop
(generate -> serve -> infer -> score) runs without external data, and scores
are exact because the ground truth is constructed, not annotated.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from chatts_tpu_torch.core.encoding import timeseries_encoding
from chatts_tpu_torch.datagen.changes import supported_change_types
from chatts_tpu_torch.datagen.generator import TimeSeriesGenerator

ALL_LOCAL_TYPES = sorted(supported_change_types())


def _trend_qa(pool) -> Optional[Tuple[str, str, dict]]:
    t = pool["trend"]
    if t["type"] == "multiple":
        return None
    question = (
        'What is the trend of this time series? Please choose from ["steady", '
        '"decreasing", "increasing"] and describe the value trend change. '
        "Answer format: steady, the starting point value is around 32.10, and "
        "the trend change value from left to right is around 0.12."
    )
    answer = (
        f"{t['type']}, the starting point value is around {t['start']:.2f}, "
        f"and the trend change value from left to right is around "
        f"{t['amplitude']:.2f}."
    )
    attribute = {"type": t["type"], "start": float(t["start"]),
                 "amplitude": float(t["amplitude"])}
    return question, answer, attribute


def _season_qa(pool) -> Optional[Tuple[str, str, dict]]:
    s = pool["seasonal"]
    question = (
        "What is the periodicity of this time series? Please choose from "
        '["no periodic fluctuation", "periodic fluctuation"]. If there is '
        "periodic fluctuation, describe the period (each period) and "
        "amplitude. Answer format: periodic fluctuation, each period is "
        "around 20.58 points, and the amplitude of the periodic fluctuation "
        "is around 31.51."
    )
    if "no" in s["type"]:
        return question, "no periodic fluctuation", {"type": "no periodic fluctuation"}
    if not s.get("segments"):
        return None
    attribute = {
        "type": s["type"],
        "period": float(pool["frequency"]["period"]),
        "amplitude": float(s["segments"][0]["amplitude"]),
    }
    answer = (
        f"periodic fluctuation, each period is around "
        f"{attribute['period']:.2f} points, and the amplitude of the periodic "
        f"fluctuation is around {attribute['amplitude']:.2f}."
    )
    return question, answer, attribute


def _noise_qa(pool) -> Optional[Tuple[str, str, dict]]:
    n = pool["noise"]
    if "std" not in n:
        return None
    question = (
        "What are the noise characteristics of this time series? Please "
        'choose from ["noisy", "almost no noise"]. Answer format: noisy, the '
        "overall noise standard deviation is around 1.5."
    )
    answer = (
        f"{n['type']}, the overall noise standard deviation is around "
        f"{n['std']:.2f}."
    )
    return question, answer, {"type": n["type"], "std": float(n["std"])}


def _local_qa(pool) -> Optional[Tuple[str, str, list]]:
    local = pool["local"]
    question = (
        "What are the local characteristic fluctuations of this time series? "
        'The optional types include: ["' + '", "'.join(ALL_LOCAL_TYPES) + '"]. '
        "Answer each type, position, and amplitude, separated by semicolons. "
        "Answer format: shake, position around point 125, amplitude 135.03; "
        "sudden decrease, position around point 102, amplitude 31.05."
    )
    if not local:
        return question, "No local characteristic fluctuations found.", []
    answer = "; ".join(
        f"{c['type']}, position around point {c['position_start']}, amplitude "
        f"{c['amplitude']:.2f}"
        for c in local
    )
    attribute = [
        {"type": c["type"], "position": int(c["position_start"]),
         "amplitude": float(c["amplitude"])}
        for c in local
    ]
    return question, answer, attribute


def build_dataset(
    num_samples: int,
    seed: int = 0,
    seq_len: Optional[int] = 256,
    encoding_method: str = "sp",
) -> List[dict]:
    gen = TimeSeriesGenerator(seed=seed)
    samples: List[dict] = []
    while len(samples) < num_samples:
        cur_len = seq_len or int(gen.rng.integers(64, 1025))
        pool = gen.generate_random_attributes(
            change_positions=[(None, None)], seq_len=cur_len
        )
        try:
            ts, pool = gen.generate(pool, cur_len)
        except (ValueError, IndexError):
            continue

        candidates = [
            ("trend", _trend_qa(pool)),
            ("season", _season_qa(pool)),
            ("noise", _noise_qa(pool)),
            ("local", _local_qa(pool)),
        ]
        candidates = [(a, qa) for a, qa in candidates if qa is not None]
        if len(candidates) < 3:
            continue

        _, frag, _ = timeseries_encoding(ts, encoding_method)
        question = (
            f"Here is a time series of length {cur_len}: {frag}, please "
            "analyze its features and answer the following questions:"
        )
        ability_types, attributes = [], []
        answer_lines = []
        for i, (ability, (q, a, attr)) in enumerate(candidates):
            question += f"\n{i + 1}. {q}"
            ability_types.append(ability)
            attributes.append(attr)
            answer_lines.append(f"{i + 1}. {a}")
        question += (
            "\nAnswer each question on its own numbered line, strictly in the "
            "requested format."
        )
        samples.append({
            "question": question,
            "timeseries": [ts.tolist()],
            "cols": ["Time Series"],
            "ability_types": ability_types,
            "attributes": attributes,
            "answer": "\n".join(answer_lines),
        })
    return samples


def build_mts_dataset(
    num_samples: int,
    seed: int = 0,
    seq_len: int = 256,
    encoding_method: str = "sp",
) -> List[dict]:
    """Multivariate samples exercising the correlation/cluster scorers:
    a positive pair shares a change position, a negative series does not
    (schema of the reference's MTS abilities: pair/label/explain +
    cols/col_idx)."""
    from chatts_tpu_torch.datagen.align.mts_local_template_qa import LOCAL_CONFIG

    gen = TimeSeriesGenerator(seed=seed)
    rng = gen.rng
    samples: List[dict] = []
    while len(samples) < num_samples:
        pos = int(rng.integers(int(0.1 * seq_len), int(0.8 * seq_len)))
        series, pools = [], []
        ok = True
        for jitter in (0, int(rng.uniform(-8, 8)), None):
            changes = [] if jitter is None else [(pos + jitter, None)]
            pool = gen.generate_random_attributes(
                LOCAL_CONFIG["overall_attribute"], LOCAL_CONFIG["change"],
                changes, seq_len,
            )
            try:
                ts, pool = gen.generate(pool, seq_len)
            except (ValueError, IndexError):
                ok = False
                break
            if jitter is not None and not pool["local"]:
                ok = False
                break
            series.append(ts)
            pools.append(pool)
        if not ok:
            continue

        cols = ["Metric A", "Metric B", "Metric C"]
        frags = []
        for ts in series:
            _, frag, _ = timeseries_encoding(ts, encoding_method)
            frags.append(frag)
        question = (
            f"There are 3 metrics, each of length {seq_len}: "
            f"Metric A: {frags[0]} Metric B: {frags[1]} Metric C: {frags[2]}. "
            "Answer the following questions:"
        )
        # 1. fluctuation correlation (positive pair A-B)
        q1 = (
            f"From the perspective of local fluctuations, do Metric A and "
            f"Metric B both have fluctuations near point {pos}? Answer yes or "
            "no first; if yes, then list each metric and its fluctuation "
            "type as 'metric, type;' pairs in the next sentence. Explain why "
            "in one sentence at the end. Keep the whole answer on one line."
        )
        a_type = pools[0]["local"][0]["type"]
        b_type = pools[1]["local"][0]["type"]
        answer1 = (
            f"Yes. Metric A, {a_type}; Metric B, {b_type}. Both metrics "
            "fluctuate near the same point, indicating a shared cause."
        )
        attr1 = {
            "label": True,
            "pair": [["Metric A", a_type], ["Metric B", b_type]],
            "explain": "Both metrics fluctuate near the same point.",
        }
        # 2. cluster membership
        q2 = (
            "From the perspective of the position of local fluctuations, "
            "which metric(s) have similar local fluctuation characteristics "
            "with Metric A? List 'metric, type;' pairs first, then explain "
            "why in one sentence, all on one line."
        )
        answer2 = (
            f"Metric A, {a_type}; Metric B, {b_type}. They fluctuate near "
            "the same position."
        )
        attr2 = {
            "cols": ["Metric A", "Metric B"],
            "col_idx": [[0, a_type], [1, b_type]],
            "explain": "They fluctuate near the same position.",
        }
        question += f"\n1. {q1}\n2. {q2}\nAnswer each on its own numbered line."
        samples.append({
            "question": question,
            "timeseries": [ts.tolist() for ts in series],
            "cols": cols,
            "ability_types": ["local_correlation_inductive",
                               "local_cluster_inductive"],
            "attributes": [attr1, attr2],
            "answer": f"1. {answer1}\n2. {answer2}",
        })
    return samples


def main(output_path: str, num_samples: int = 100, seed: int = 0,
         seq_len: Optional[int] = 256) -> int:
    samples = build_dataset(num_samples, seed, seq_len)
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(samples, f, ensure_ascii=False)
    return len(samples)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--output", default="evaluation/dataset/dataset_synth.json")
    p.add_argument("--num-samples", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq-len", type=int, default=256)
    args = p.parse_args()
    print(f"wrote {main(args.output, args.num_samples, args.seed, args.seq_len)} samples")
