"""Seed template QA with TSEvol fields metadata (uni- and multivariate).

The port's copy of ``chatts_tpu/datagen/seed_template_qa.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference seed generator
(reference: demo/generate_template_qa.py:44-328): metric-conditioned series
with template QAs carrying the ``fields`` coverage dicts TSEvol uses to
decide what remains unexplored, for 1 (univariate) or 2-10 (multivariate)
series per sample.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from chatts_tpu_torch.core.encoding import timeseries_encoding, timeseries_to_list
from chatts_tpu_torch.datagen.generator import TimeSeriesGenerator, attribute_to_text
from chatts_tpu_torch.datagen.metric_set import MetricSet


class SeedTemplateQAGenerator:
    def __init__(
        self,
        metric_set: Optional[MetricSet] = None,
        seed: int = 0,
        encoding_method: str = "no",
        seq_len: Optional[int] = None,
    ):
        self.metric_set = metric_set or MetricSet.load()
        self.gen = TimeSeriesGenerator(seed=seed)
        self.encoding_method = encoding_method
        self.seq_len = seq_len

    def _metric_series(self, metric: str, seq_len: int):
        pool = self.gen.generate_controlled_attributes(
            self.metric_set.metric_to_controlled_attributes(metric),
            seq_len=seq_len,
        )
        return self.gen.generate(pool, seq_len)

    def univariate_seed_qa(self) -> List[dict]:
        """(reference: generate_template_qa.py:44-103)"""
        rng = self.gen.rng
        seq_len = self.seq_len or int(rng.integers(64, 1025))
        metrics = self.metric_set.all_metrics()
        metric = metrics[int(rng.integers(0, len(metrics)))]
        category = self.metric_set.category_of(metric)
        ts, pool = self._metric_series(metric, seq_len)
        scaled, frag, _ = timeseries_encoding(ts, self.encoding_method)

        instruction = (
            f"You are a time series analysis expert. This is a metric called "
            f"{metric} collected from {category} with length of {seq_len}: "
            f"{frag}."
        )
        questions, answers, fields = [], [], []
        questions.append(
            "Now, please analyze the characteristics of this time series from "
            "the perspectives of periodicity, trend, local characteristics, "
            "frequency characteristics, and noise."
        )
        answers.append(attribute_to_text(ts, pool, generate_values=False))
        fields.append({"trend": [0], "seasonal": [0], "noise": [0], "local": [0]})

        questions.append(
            "Now, please analyze the characteristics of this time series from "
            "the perspectives of periodicity, trend, local characteristics, "
            "frequency characteristics, and noise. Also include the "
            "approximate mean values for every 16 points, as well as the "
            "maximum and minimum values of the time series (rounded to 2 "
            "decimal places)."
        )
        answers.append(attribute_to_text(ts, pool, generate_values=True))
        fields.append({"trend": [0], "seasonal": [0], "noise": [0],
                       "local": [0], "statistic": [0]})

        for c in pool["local"]:
            probe = c["position_start"] + int(rng.integers(-5, 6))
            questions.append(
                f"Is there a local characteristic fluctuation starting around "
                f"point {probe} in this time series?"
            )
            answers.append("Yes, this time series " + c["detail"])
            fields.append({"local": [0]})

        return [
            {
                "instruction": instruction,
                "question": q,
                "answer": a,
                "fields": f,
                "metrics": [metric],
                "attribute_pool": [pool],
                "timeseries": [scaled],
                "original_timeseries": [ts],
                "corr_pool": [],
            }
            for q, a, f in zip(questions, answers, fields)
        ]

    def multivariate_seed_qa(self) -> List[dict]:
        """2-10 series from one category with per-series shape QA
        (reference: generate_template_qa.py:104-277)."""
        rng = self.gen.rng
        seq_len = self.seq_len or int(rng.integers(64, 1025))
        candidates = [
            c for c in self.metric_set.categories if len(c.get("metrics", [])) >= 2
        ]
        cat = candidates[int(rng.integers(0, len(candidates)))]
        n = int(rng.integers(2, min(10, len(cat["metrics"])) + 1))
        metrics = [str(m) for m in rng.choice(cat["metrics"], size=n, replace=False)]

        series, pools, scaled_list = [], [], []
        prompt = (
            f"You are a time series analysis expert. In a monitoring system "
            f"of {cat['category']}, there are {n} metrics collected."
        )
        for metric in metrics:
            ts, pool = self._metric_series(metric, seq_len)
            scaled, frag, _ = timeseries_encoding(ts, self.encoding_method)
            series.append(ts)
            pools.append(pool)
            scaled_list.append(scaled)
            prompt += (
                f'\n "{metric}" is a time series with length of {seq_len}: '
                f"{frag}"
            )

        questions, answers, fields = [], [], []
        for i in range(n):
            if rng.random() > 0.5:
                continue
            questions.append(
                f"Analyze the characteristics of {metrics[i]} from the "
                f"perspectives of periodicity, trend, local characteristics, "
                f"frequency characteristics, and noise."
            )
            answers.append(
                f"{metrics[i]}: "
                + attribute_to_text(series[i], pools[i], generate_values=False)
            )
            fields.append({"trend": [i], "seasonal": [i], "noise": [i],
                           "local": [i]})
        if not questions:
            raise ValueError("no questions drawn for this sample")

        return [
            {
                "instruction": prompt,
                "question": q,
                "answer": a,
                "fields": f,
                "metrics": metrics,
                "attribute_pool": pools,
                "timeseries": scaled_list,
                "original_timeseries": series,
                "corr_pool": [],
            }
            for q, a, f in zip(questions, answers, fields)
        ]

    def generate(self, num_data: int, multivariate_ratio: float = 0.3):
        """(dataset rows, evol labels)"""
        rows, labels = [], []
        ts_idx = 0
        while len(rows) < num_data:
            try:
                if self.gen.rng.random() < multivariate_ratio:
                    items = self.multivariate_seed_qa()
                else:
                    items = self.univariate_seed_qa()
            except (ValueError, IndexError):
                continue
            for item in items:
                rows.append({
                    "input": item["instruction"].rstrip(".") + ". " + item["question"],
                    "output": item["answer"],
                    "timeseries": timeseries_to_list(item["timeseries"]),
                    "ts_idx": ts_idx,
                    "fields": item["fields"],
                })
                labels.append({
                    "fields": item["fields"],
                    "metrics": item["metrics"],
                    "corr_pool": item["corr_pool"],
                    "attribute_pool": item["attribute_pool"],
                    "instruction": item["instruction"],
                    "question": item["question"],
                    "ts_idx": ts_idx,
                })
            ts_idx += 1
        return rows[:num_data], labels[:num_data]


def main(output_path: str, label_path: str, num_data: int = 100,
         seed: int = 0, **kw) -> int:
    g = SeedTemplateQAGenerator(seed=seed, **kw)
    rows, labels = g.generate(num_data)
    for p in (output_path, label_path):
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    with open(label_path, "w") as f:
        json.dump(labels, f, ensure_ascii=False, indent=4)
    return len(rows)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--output", default="data/seed_template_qa.jsonl")
    p.add_argument("--labels", default="data/evol_labels/seed_template_qa.json")
    p.add_argument("--num-data", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    print(f"wrote {main(args.output, args.labels, args.num_data, args.seed)} rows")
