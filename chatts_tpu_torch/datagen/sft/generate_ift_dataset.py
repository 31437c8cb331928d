"""Instruction-following (IFT) dataset from alignment labels.

The port's copy of ``chatts_tpu/datagen/sft/generate_ift_dataset.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference pipeline
(reference: chatts/sft/generate_ift_dataset.py:39-272): bundles 3-4 numbered
questions per sample with a strict answer-format footer; question levels are
L0 (trend/season/noise, +physical-meaning variants), L1 (local changes with
the 19-type list in the question text), L2 (shape/fluctuation correlation and
cluster).  Answer formats exactly match what the eval scorers parse
(evaluate_qa keyword contracts: "starting point value", "change value from
left to right", "each period", "amplitude", "position around point").
"""
from __future__ import annotations

import copy
import json
import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from chatts_tpu_torch.core.encoding import timeseries_encoding, timeseries_to_list
from chatts_tpu_torch.datagen.changes import supported_change_types

ALL_LOCAL_TYPES = sorted(supported_change_types())


# --- L0: STL shape + statistics -------------------------------------------

def generate_trend(sample, rng):
    if sample["label"]["trend"]["type"] == "multiple":
        raise NotImplementedError("ift not implemented for multiple trend")
    question = (
        'What is the trend of this time series? Please choose from ["steady", '
        '"decreasing", "increasing"] and describe the value trend change. '
        "Answer format: steady, the starting point value is around 32.10, and "
        "the trend change value from left to right is around 0.12."
    )
    t = sample["label"]["trend"]
    answer = (
        f"{t['type']}, the starting point value is around {t['start']:.2f}, "
        f"and the trend change value from left to right is around "
        f"{t['amplitude']:.2f}."
    )
    return question, answer


def generate_trend_physical(sample, rng):
    if sample["label"]["trend"]["type"] == "multiple":
        raise NotImplementedError("ift not implemented for multiple trend")
    question = (
        'What is the trend of this time series? Please choose from ["steady", '
        '"decreasing", "increasing"], describe the value trend change, and '
        "conclude the physical meaning of this trend change in one sentence. "
        "Answer format: steady, the starting point value is around 32.10, and "
        "the trend change value from left to right is around 0.12. The trend "
        "indicates that the temperature is stable during the period."
    )
    t = sample["label"]["trend"]
    answer = (
        f"{t['type']}, the starting point value is around {t['start']:.2f}, "
        f"and the trend change value from left to right is around "
        f"{t['amplitude']:.2f}. The trend indicates that {t['detail']}"
    )
    return question, answer


def generate_season(sample, rng):
    question = (
        "What is the periodicity of this time series? Please choose from "
        '["no periodic fluctuation", "periodic fluctuation"]. If there is '
        "periodic fluctuation, describe the fluctuation frequency and "
        "amplitude. Answer format: periodic fluctuation, each period is "
        "around 20.58 points, and the amplitude of the periodic fluctuation "
        "is around 31.51."
    )
    label = sample["label"]
    if "no" in label["seasonal"]["type"]:
        answer = "no periodic fluctuation"
    else:
        answer = (
            f"periodic fluctuation, each period is around "
            f"{label['frequency']['period']:.2f} points, and the amplitude of "
            f"the periodic fluctuation is around "
            f"{label['seasonal']['segments'][0]['amplitude']:.2f}."
        )
    return question, answer


def generate_season_physical(sample, rng):
    question = (
        "What is the periodicity of this time series? Please choose from "
        '["no periodic fluctuation", "periodic fluctuation"], and conclude '
        "the physical meaning of the periodicity in one sentence. If there is "
        "periodic fluctuation, also describe the fluctuation frequency and "
        "amplitude. Answer format: periodic fluctuation, each period is "
        "around 20.58 points, and the amplitude of the periodic fluctuation "
        "is around 31.51. The periodic fluctuation indicates that the "
        "temperature is periodically changing in a day."
    )
    label = sample["label"]
    if "no" in label["seasonal"]["type"]:
        answer = (
            f"no periodic fluctuation. It indicates that "
            f"{label['seasonal']['detail']}"
        )
    else:
        answer = (
            f"periodic fluctuation, each period is around "
            f"{label['frequency']['period']:.2f} points, and the amplitude of "
            f"the periodic fluctuation is around "
            f"{label['seasonal']['segments'][0]['amplitude']:.2f}. It "
            f"indicates that {label['seasonal']['detail']}"
        )
    return question, answer


def generate_noise(sample, rng):
    question = (
        "What are the noise characteristics of this time series? Please "
        'choose from ["noisy", "almost no noise"]. Answer format: noisy, the '
        "overall noise standard deviation is around 1.5."
    )
    n = sample["label"]["noise"]
    answer = (
        f"{n['type']}, the overall noise standard deviation is around "
        f"{n.get('std', 0.0):.2f}."
    )
    return question, answer


# --- L1: local changes -----------------------------------------------------

def _types_list() -> str:
    return '["' + '", "'.join(ALL_LOCAL_TYPES) + '"]'


def generate_local(sample, rng):
    question = (
        "What are the local characteristic fluctuations of this time series? "
        "The optional types of local characteristic fluctuations include: "
        + _types_list()
        + ". You need to analyze all the characteristic fluctuations that "
        "appear in this time series and answer each type, position, and "
        "amplitude in the format. Different local characteristic fluctuations "
        "should be separated by semicolons. Answer format: shake, position "
        "around point 125, amplitude 135.03; small sudden decrease, position "
        "around point 102, amplitude 31.05."
    )
    local = sample["label"]["local"]
    if not local:
        return question, "No local characteristic fluctuations found."
    answer = "; ".join(
        f"{c['type'] if isinstance(c['type'], str) else c['type'][0]}, "
        f"position around point {c['position_start']}, amplitude "
        f"{c['amplitude']:.2f}"
        for c in local
    )
    return question, answer


def generate_local_physical(sample, rng):
    question = (
        "What are the local characteristic fluctuations of this time series? "
        "The optional types of local characteristic fluctuations include: "
        + _types_list()
        + ". You need to analyze all the characteristic fluctuations that "
        "appear in this time series and answer each type, position, and "
        "amplitude in the format, and conclude the physical meaning of "
        "**each** fluctuation in one sentence. Different local characteristic "
        "fluctuations should be separated by semicolons. Answer format: "
        "shake, position around point 125, amplitude 135.03. A sudden surge "
        "in public interest; small sudden decrease, position around point "
        "102, amplitude 31.05. A slight dip in interest."
    )
    local = sample["label"]["local"]
    if not local:
        return question, "No local characteristic fluctuations found."
    answer = "; ".join(
        f"{c['type'] if isinstance(c['type'], str) else c['type'][0]}, "
        f"position around point {c['position_start']}, amplitude "
        f"{c['amplitude']:.2f}. "
        f"{c['detail'].rstrip('.')}"
        for c in local
    )
    return question, answer


# --- L2: correlation + cluster (MTS labels) --------------------------------

def generate_shape_correlation(sample, rng):
    correlations = sample["label"].get("correlations", [])
    if not correlations:
        raise NotImplementedError("no correlations in sample")
    pairs = correlations[int(rng.integers(0, len(correlations)))]
    question = (
        f"From the perspective of the overall trend, do {pairs['pair'][0]} "
        f"and {pairs['pair'][1]} have very similar trend characteristics? "
        "Just answer yes or no, and explain why they are correlated/no "
        "correlated considering their physical meaning in one sentence. "
        "Answer format: Yes. Both metrics are related to the same system "
        "component, so they are highly correlated."
    )
    prefix = "Yes. " if pairs["label"] else "No. "
    return question, prefix + pairs["explain"]


def _fluctuation_type(sample, metric):
    for cluster in sample["label"].get("clusters", []):
        if metric in cluster["cols"]:
            return cluster["col_idx"][cluster["cols"].index(metric)][1]
    return None


def generate_fluctuation_correlation(sample, rng):
    correlations = sample["label"].get("correlations", [])
    positive = [p for p in correlations if p["label"]]
    negative = [p for p in correlations if not p["label"]]
    if not correlations:
        raise NotImplementedError("no correlations in sample")
    if positive and (rng.random() > 0.5 or not negative):
        pairs = positive[int(rng.integers(0, len(positive)))]
    else:
        pairs = negative[int(rng.integers(0, len(negative)))]
    question = (
        f"From the perspective of local fluctuations, do {pairs['pair'][0]} "
        f"and {pairs['pair'][1]} both have fluctuations near point "
        f"{sample['label']['position']}? Answer yes or no, the types of their "
        "correlated fluctuations (if yes), and explain why they are "
        "correlated/no correlated considering their physical meaning in one "
        "sentence. Answer format: Yes. [metric 1], shake; [metric 2], upward "
        "spike. Both metrics are related to CPU, so they fluctuate together."
    )
    if pairs["label"]:
        answer = "Yes. " + "; ".join(
            f"{m}, {_fluctuation_type(sample, m)}" for m in pairs["pair"]
        ) + ". " + pairs["explain"]
    else:
        answer = "No. " + pairs["explain"]
    return question, answer


def generate_shape_cluster(sample, rng):
    clusters = sample["label"].get("clusters", [])
    if not clusters:
        raise NotImplementedError("no clusters in sample")
    cluster = clusters[int(rng.integers(0, len(clusters)))]
    anchor = cluster["cols"][int(rng.integers(0, len(cluster["cols"])))]
    question = (
        f"From the perspective of the overall trend, which metric(s) have "
        f"very similar trend characteristics with {anchor}? List the metrics "
        "(including itself) and explain why they have similar overall trend "
        "considering their physical meaning in one sentence. Answer format: "
        "A, B, C. All metrics are related to the same system component, so "
        "they may have similar overall trend."
    )
    return question, ", ".join(cluster["cols"]) + ". " + cluster["explain"]


def generate_fluctuation_cluster(sample, rng):
    clusters = sample["label"].get("clusters", [])
    if not clusters:
        raise NotImplementedError("no clusters in sample")
    cluster = clusters[int(rng.integers(0, len(clusters)))]
    anchor = cluster["cols"][int(rng.integers(0, len(cluster["cols"])))]
    question = (
        f"From the perspective of the position of local fluctuations, which "
        f"metric(s) have very similar local fluctuation characteristics with "
        f"{anchor}? The optional types of local characteristic fluctuations "
        f"include: " + _types_list() + ". List the metrics (including "
        "itself), the types of fluctuations, and explain why they have "
        "similar local fluctuations considering their physical meaning in one "
        "sentence. Answer format: [metric 1], shake; [metric 2], upward "
        "spike; [metric 3], downward spike. All metrics are related to the "
        "same system component."
    )
    answer = "; ".join(
        f"{m}, {cluster['col_idx'][idx][1]}"
        for idx, m in enumerate(cluster["cols"])
    ) + ". " + cluster["explain"]
    return question, answer


UTS_FUNCS: List[Callable] = [
    generate_trend, generate_season, generate_noise, generate_local,
    generate_trend_physical, generate_season_physical, generate_local_physical,
]
SHAPE_FUNCS: List[Callable] = [generate_shape_correlation, generate_shape_cluster]
LOCAL_FUNCS: List[Callable] = [
    generate_fluctuation_correlation, generate_fluctuation_cluster,
]


def generate_qa(
    sample: dict, kind: str, rng: np.random.Generator,
    encoding_method: str = "no",
) -> dict:
    """Bundle 3-4 numbered questions for one labeled sample (reference:
    generate_ift_dataset.py:163-229).  ``kind``: 'uts' | 'shape' | 'local'."""
    candidates: List[Callable] = []
    mts_flag = kind in ("shape", "local")
    if kind == "uts":
        candidates += UTS_FUNCS
    if kind == "shape":
        candidates += SHAPE_FUNCS
    if kind == "local":
        candidates += LOCAL_FUNCS

    size = min(len(candidates), int(rng.integers(3, 5)))
    picks = rng.choice(len(candidates), size=size, replace=False)
    funcs = [candidates[int(i)] for i in picks]

    original_ts = copy.deepcopy(sample["timeseries"])
    if mts_flag:
        timeseries = [np.array(t) for t in sample["timeseries"]]
        cols = sample["label"]["cols"]
        question = (
            f"You are a time series analysis expert. In a monitoring system "
            f"of {sample['label']['situation']}, there are {len(timeseries)} "
            f"metrics collected."
        )
        encoded = []
        for i, ts in enumerate(timeseries):
            scaled, frag, _ = timeseries_encoding(ts, encoding_method)
            encoded.append(scaled)
            question += (
                f'\n "{cols[i]}" is a time series with length of {len(ts)}: '
                f"{frag}"
            )
        question += (
            ", please analyze the time series features and answer the "
            "following questions:"
        )
        timeseries = encoded
    else:
        ts = np.array(sample["timeseries"])
        scaled, frag, _ = timeseries_encoding(ts, encoding_method)
        timeseries = [scaled]
        metric = sample["label"].get("metric_name")
        if metric:
            cols = [metric]
            question = (
                f'You are a time series analysis expert. This time series is '
                f'"{metric}" from {sample["label"].get("situation")} with '
                f"length of {len(ts)}: {frag}, please analyze the time series "
                "features and answer the following questions:"
            )
        else:
            cols = ["Time Series"]
            question = (
                f"You are a time series analysis expert. Here is a time "
                f"series of length {len(ts)}: {frag}, please analyze the time "
                "series features and answer the following questions:"
            )

    answer = ""
    for idx, func in enumerate(funcs):
        q, a = func(sample, rng)
        question += f"\n{idx + 1}. {q}"
        answer += f"{idx + 1}. {a}\n"
    question += (
        "\nNow, based on the above questions, please strictly follow the "
        "output format requirements and provide the answers. Each line "
        "corresponds to an answer to a question, formatted as:"
    )
    question += "\n".join(
        f"{i + 1}. Strictly formatted answer {i + 1}" for i in range(len(funcs))
    )
    return {
        "timeseries": timeseries,
        "original_timeseries": original_ts,
        "cols": cols,
        "question": question,
        "answer": answer,
    }


def generate_dataset(
    label_files: List[Tuple[str, str]],
    target_cnt: int,
    output_path: str,
    seed: int = 0,
    encoding_method: str = "no",
) -> int:
    """``label_files``: list of (path, kind) where kind in uts/shape/local."""
    rng = np.random.default_rng(seed)
    samples, kinds = [], []
    for path, kind in label_files:
        with open(path) as f:
            for sample in json.load(f):
                samples.append(sample)
                kinds.append(kind)
    if not samples:
        raise ValueError("no labeled samples found")

    result = []
    attempts = 0
    while len(result) < target_cnt and attempts < target_cnt * 50:
        attempts += 1
        idx = int(rng.integers(0, len(samples)))
        try:
            qa = generate_qa(
                copy.deepcopy(samples[idx]), kinds[idx], rng, encoding_method
            )
        except (NotImplementedError, KeyError, IndexError, ValueError):
            continue
        result.append(qa)

    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        for item in result:
            f.write(json.dumps({
                "input": item["question"],
                "output": item["answer"],
                "timeseries": timeseries_to_list(item["timeseries"]),
            }, ensure_ascii=False) + "\n")
    return len(result)
