"""Multivariate LLM-assisted alignment QA (local-fluctuation and shape/trend
variants).

The port's copy of ``chatts_tpu/datagen/align/mts_llm_qa.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference pipelines
(reference: chatts/align/mts_local_llm_qa.py:110-482 and
chatts/align/mts_shape_llm_qa.py:270-436): metric names and clusters come
from the metric-set prior; positive groups share a change position (local) or
trend keypoints (shape); the label structures carry ``correlations``
([{pair, label, explain}]), ``clusters`` ([{cols, col_idx, explain}]),
``position``, ``cols``, and ``situation`` with ``<|promptN|>`` holes that a
local LLM fills with physical-meaning explanations.  These labels feed the
IFT generator (chatts_tpu_torch.datagen.sft.generate_ift_dataset) and TSEvol.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from chatts_tpu_torch.core.encoding import timeseries_encoding, timeseries_to_list
from chatts_tpu_torch.datagen import trends as trends_lib
from chatts_tpu_torch.datagen.align.mts_local_template_qa import LOCAL_CONFIG
from chatts_tpu_torch.datagen.align.mts_shape_template_qa import SHAPE_CONFIG
from chatts_tpu_torch.datagen.align.uts_llm_qa import PROMPT_HOLE
from chatts_tpu_torch.datagen.generator import TimeSeriesGenerator, attribute_to_text
from chatts_tpu_torch.datagen.metric_set import MetricSet
from chatts_tpu_torch.utils.llm_client import LLMClient


class _MTSLLMBase:
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
        self.prompt_idx = 0

    def _hole(self) -> str:
        h = f"<|prompt{self.prompt_idx}|>"
        self.prompt_idx += 1
        return h

    def _pick_category(self):
        rng = self.gen.rng
        candidates = [
            c for c in self.metric_set.categories
            if c.get("cluster") and len(c.get("metrics", [])) >= 3
        ]
        if not candidates:
            raise ValueError("no categories with clusters")
        return candidates[int(rng.integers(0, len(candidates)))]

    def _pick_positive_clusters(self, category: dict, num_clusters: int):
        """Pick up to ``num_clusters`` disjoint metric groups from the
        category's clusters (reference: mts_local_llm_qa.py:195-226)."""
        rng = self.gen.rng
        cluster = category["cluster"]
        visited_metrics: set = set()
        visited_clusters: set = set()
        groups: List[List[str]] = []
        for _ in range(num_clusters):
            candidates = [
                name for name in cluster
                if len(set(cluster[name]) - visited_metrics) > 1
                and name not in visited_clusters
            ]
            if not candidates:
                break
            name = candidates[int(rng.integers(0, len(candidates)))]
            visited_clusters.add(name)
            avail = sorted(set(cluster[name]) - visited_metrics)
            size = int(rng.integers(2, len(avail) + 1))
            members = [str(m) for m in rng.choice(avail, size=size, replace=False)]
            visited_metrics.update(members)
            groups.append(members)
        if not groups:
            raise ValueError("could not build positive clusters")
        return groups

    def _metric_to_cluster(self, category: dict) -> Dict[str, str]:
        out = {}
        for name, members in category.get("cluster", {}).items():
            for m in members:
                out[m] = name
        return out

    def _series_for_metric(self, metric: str, category: str, config: dict,
                           changes, seq_len: int):
        pool = self.gen.generate_random_attributes(
            config["overall_attribute"], config["change"], changes, seq_len
        )
        pool["metric_name"] = metric
        pool["situation"] = category
        return self.gen.generate(pool, seq_len)

    def _finalize(self, result, labels, corr_pools, llm_client: LLMClient):
        """Fill the <|promptN|> holes across datasets, labels, and corr
        pools."""
        all_prompts: List[str] = []
        for item in result:
            for plist in item["llm_prompts"]:
                all_prompts.extend(plist)
        answers = llm_client.llm_batch_generate(all_prompts)
        data = [a or "" for a in answers]

        def fill(obj):
            if isinstance(obj, dict):
                return {k: fill(v) for k, v in obj.items()}
            if isinstance(obj, list):
                return [fill(v) for v in obj]
            if isinstance(obj, str):
                return PROMPT_HOLE.sub(
                    lambda m: data[int(m.group(1))]
                    if int(m.group(1)) < len(data) else "",
                    obj,
                )
            return obj

        return fill(result), fill(labels), fill(corr_pools)


class MTSLocalLLMQAGenerator(_MTSLLMBase):
    """Fluctuation-correlation variant (reference: mts_local_llm_qa.py)."""

    def generate_prompt_data(self) -> Tuple[dict, dict, list]:
        rng = self.gen.rng
        seq_len = self.seq_len or (
            256 if rng.random() > 0.4 else int(rng.integers(64, 1025))
        )
        category = self._pick_category()
        situation = category["category"]
        metric_to_cluster = self._metric_to_cluster(category)

        num_clusters = int(rng.integers(1, 4))
        positive_clusters = self._pick_positive_clusters(category, num_clusters)

        # Change position per cluster, separated by seq_len // 5
        # (reference: mts_local_llm_qa.py:228-238).
        positions: List[int] = []
        for _ in positive_clusters:
            for _ in range(100):
                cand = int(rng.integers(int(0.02 * seq_len), int(0.95 * seq_len) + 1))
                if all(abs(cand - p) > seq_len // 5 for p in positions):
                    positions.append(cand)
                    break
            else:
                raise ValueError("could not separate cluster positions")

        used = {m for grp in positive_clusters for m in grp}
        leftovers = [m for m in category["metrics"] if m not in used]
        num_negative = min(int(rng.integers(0, 3)), len(leftovers))
        negatives = (
            [str(m) for m in rng.choice(leftovers, size=num_negative, replace=False)]
            if num_negative else []
        )

        metrics, cluster_idx, series, pools = [], [], [], []
        for ci, grp in enumerate(positive_clusters):
            for metric in grp:
                pos = min(max(int(positions[ci] + rng.uniform(-10, 10)), 0),
                          seq_len - 2)
                ts, pool = self._series_for_metric(
                    metric, situation, LOCAL_CONFIG, [(pos, None)], seq_len
                )
                if not pool["local"]:
                    raise ValueError("positive change rejected")
                metrics.append(metric)
                cluster_idx.append(ci)
                series.append(ts)
                pools.append(pool)
        for metric in negatives:
            ts, pool = self._series_for_metric(
                metric, situation, LOCAL_CONFIG, [], seq_len
            )
            metrics.append(metric)
            cluster_idx.append(None)
            series.append(ts)
            pools.append(pool)

        order = rng.permutation(len(metrics))
        metrics = [metrics[i] for i in order]
        cluster_idx = [cluster_idx[i] for i in order]
        series = [series[i] for i in order]
        pools = [pools[i] for i in order]

        label = {
            "timeseries": [t.tolist() for t in series],
            "label": {
                "clusters": [],
                "position": int(positions[0]),
                "correlations": [],
                "cols": metrics,
                "situation": situation,
            },
            "attribute_pool": pools,
        }

        prompt = f"In a {situation} system, there are {len(metrics)} metrics:"
        questions, answers, llm_prompts, fields_list = [], [], [], []
        corr_pool = [None] * len(metrics)
        encoded = []
        positive_idx = [
            i for i in range(len(metrics))
            if cluster_idx[i] == 0
        ]

        for i in range(len(metrics)):
            scaled, frag, _ = timeseries_encoding(series[i], self.encoding_method)
            encoded.append(scaled)
            prompt += f"\n {metrics[i]} is of length {seq_len}: {frag};"
            pos0 = positions[0]

            # Pairwise correlation QAs.
            for j in range(len(metrics)):
                if i == j:
                    continue
                if rng.random() < 0.8 and not (
                    i in positive_idx and j in positive_idx
                ):
                    continue
                questions.append(
                    f"Based on the characteristics of the time series, please "
                    f"describe the characteristics of {metrics[i]} and "
                    f"{metrics[j]} from the aspects of periodicity, trend, "
                    f"local characteristics, frequency characteristics, and "
                    f"noise. And analyze whether there may be a correlation "
                    f"of fluctuation between them around point {pos0}. "
                    f"Conclude the physical meaning of the fluctuation "
                    f"correlation (or no correlation) in one sentence."
                )
                fields_list.append({
                    "local": [i, j], "seasonal": [i, j], "trend": [i, j],
                    "noise": [i, j], "statistic": [i, j],
                })
                ans = (
                    f"{metrics[i]}: "
                    + attribute_to_text(series[i], pools[i], generate_values=False)
                    + f"; {metrics[j]}: "
                    + attribute_to_text(series[j], pools[j], generate_values=False)
                )
                same_cluster_hint = (
                    f"(Hint: These two metrics are both "
                    f"{metric_to_cluster.get(metrics[i])}-related.)"
                    if metric_to_cluster.get(metrics[i])
                    == metric_to_cluster.get(metrics[j]) else ""
                )
                if i in positive_idx and j in positive_idx:
                    hole = self._hole()
                    ans += (
                        f" Both metrics show sudden changes around point "
                        f"{pos0}, indicating a possible correlation in terms "
                        f"of fluctuation. {hole}"
                    )
                    label["label"]["correlations"].append(
                        {"pair": [metrics[i], metrics[j]], "explain": hole,
                         "label": True}
                    )
                    llm_prompts.append([
                        f"In a {situation} system, there are many monitoring "
                        f"metrics. Near a timestamp (maybe during a failure), "
                        f"we found there are fluctuations in {metrics[i]} and "
                        f"{metrics[j]} that happens together. Please explain "
                        f"why {metrics[i]} and {metrics[j]} fluctuates "
                        "together in their physical meaning in English in one "
                        "sentence. Make sure to keep it simple. "
                        + same_cluster_hint
                    ])
                elif cluster_idx[i] is not None and cluster_idx[i] == cluster_idx[j]:
                    hole = self._hole()
                    ans += (
                        f" No. Both metrics show sudden changes around point "
                        f"{positions[cluster_idx[i]]}, but no sudden changes "
                        f"around point {pos0}. {hole}"
                    )
                    label["label"]["correlations"].append(
                        {"pair": [metrics[i], metrics[j]], "explain": hole,
                         "label": False}
                    )
                    llm_prompts.append([
                        f"In a {situation} system, metrics {metrics[i]} and "
                        f"{metrics[j]} fluctuate together at another time but "
                        "not at this timestamp. Explain why they are not "
                        "fluctuating together at this time in their physical "
                        "meaning in English in one sentence. Keep it simple. "
                        + same_cluster_hint
                    ])
                else:
                    hole = self._hole()
                    ans += (
                        f" These two time series do not seem to have much "
                        f"correlation in terms of fluctuation around point "
                        f"{pos0}. {hole}"
                    )
                    label["label"]["correlations"].append(
                        {"pair": [metrics[i], metrics[j]], "explain": hole,
                         "label": False}
                    )
                    a, b = (i, j) if i in positive_idx else (j, i)
                    llm_prompts.append([
                        f"In a {situation} system, near a timestamp we found "
                        f"fluctuations in {metrics[a]} but not in "
                        f"{metrics[b]}. Explain why they are **not** "
                        "fluctuating together in their physical meaning in "
                        "English in one simple sentence:"
                    ])
                answers.append(ans)

            # Find-related QA.
            questions.append(
                f"Based on the fluctuations in the metrics around point "
                f"{pos0}, please find other metric(s) that may be related to "
                f"{metrics[i]}, output their numbers, and explain the "
                f"reasons. If related metrics are found, explain why they "
                f"have similar local fluctuations considering their physical "
                f"meaning in one sentence. If no related metrics are found, "
                f"output that no related metrics were found."
            )
            if i not in positive_idx:
                answers.append(
                    f"Among these metrics, I did not find any other metrics "
                    f"that may be related to {metrics[i]} in terms of "
                    f"fluctuation around point {pos0}. It seems that "
                    f"{metrics[i]} shows no significant fluctuation around "
                    f"this point."
                )
                fields_list.append({"local": [i]})
                llm_prompts.append([])
            else:
                ans = (
                    f"I found the following metrics that may be related to "
                    f"{metrics[i]} in terms of fluctuation:"
                )
                i_change = pools[i]["local"][0]["type"]
                for j in positive_idx:
                    if i == j:
                        continue
                    j_change = pools[j]["local"][0]["type"]
                    if i_change == j_change:
                        ans += (
                            f" {metrics[i]} and {metrics[j]} both show "
                            f"{i_change} around point {pos0}, indicating a "
                            f"possible correlation in terms of fluctuation."
                        )
                    else:
                        ans += (
                            f" {metrics[i]} shows {i_change} around point "
                            f"{pos0}, while {metrics[j]} shows {j_change} "
                            f"around this point, indicating a possible "
                            f"correlation in terms of fluctuation."
                        )
                hole = self._hole()
                ans += f" {hole}"
                fields_list.append({"local": list(positive_idx)})
                corr_pool[i] = [list(positive_idx), ans]
                if not label["label"]["clusters"]:
                    label["label"]["clusters"].append({
                        "col_idx": [
                            [int(j), pools[j]["local"][0]["type"]]
                            for j in positive_idx
                        ],
                        "cols": [metrics[j] for j in positive_idx],
                        "explain": hole,
                    })
                llm_prompts.append([
                    f"In a {situation} system, near a timestamp we found "
                    "fluctuations in "
                    + ", ".join(metrics[j] for j in positive_idx)
                    + ". Please explain their relationship in physical "
                    f"meaning and simply describe what may be happening in "
                    f"the {situation} system in English in 1 sentence:"
                ])
                answers.append(ans)

        item = {
            "prompt": prompt,
            "questions": questions,
            "answers": answers,
            "llm_prompts": llm_prompts,
            "fields": fields_list,
            "timeseries": encoded,
            "metrics": metrics,
            "attribute_pool": pools,
        }
        return item, label, corr_pool

    def generate_dataset(
        self, num_data: int, llm_client: LLMClient
    ) -> Tuple[List[dict], List[dict], List[dict]]:
        result, labels, corr_pools = [], [], []
        cnt = 0
        while cnt < num_data:
            try:
                item, label, corr_pool = self.generate_prompt_data()
            except (ValueError, IndexError):
                continue
            result.append(item)
            labels.append(label)
            corr_pools.append(corr_pool)
            cnt += len(item["questions"])
        result, labels, corr_pools = self._finalize(
            result, labels, corr_pools, llm_client
        )

        rows, evol_labels = [], []
        for ts_idx, item in enumerate(result):
            for q, a, f in zip(item["questions"], item["answers"], item["fields"]):
                rows.append({
                    "input": item["prompt"][:-1] + ". " + q,
                    "output": a,
                    "timeseries": timeseries_to_list(item["timeseries"]),
                    "ts_idx": ts_idx,
                    "fields": f,
                })
                evol_labels.append({
                    "fields": f,
                    "metrics": item["metrics"],
                    "corr_pool": corr_pools[ts_idx],
                    "attribute_pool": item["attribute_pool"],
                    "instruction": item["prompt"],
                    "question": q,
                    "ts_idx": ts_idx,
                })
        return rows, evol_labels, labels


class MTSShapeLLMQAGenerator(_MTSLLMBase):
    """Trend-correlation variant (reference: mts_shape_llm_qa.py)."""

    def generate_prompt_data(self) -> Tuple[dict, dict, list]:
        rng = self.gen.rng
        seq_len = self.seq_len or (
            256 if rng.random() > 0.4 else int(rng.integers(64, 1025))
        )
        category = self._pick_category()
        situation = category["category"]
        metric_to_cluster = self._metric_to_cluster(category)
        positive_cluster = self._pick_positive_clusters(category, 1)[0]

        used = set(positive_cluster)
        leftovers = [m for m in category["metrics"] if m not in used]
        num_negative = min(int(rng.integers(0, 4)), len(leftovers))
        negatives = (
            [str(m) for m in rng.choice(leftovers, size=num_negative, replace=False)]
            if num_negative else []
        )

        base_points, _ = trends_lib.generate_random_points(rng, seq_len)
        metrics, is_positive, series, pools, point_sets = [], [], [], [], []
        for metric in positive_cluster:
            changes = [(None, None)] if rng.random() > 0.8 else []
            ts, pool = self._series_for_metric(
                metric, situation, SHAPE_CONFIG, changes, seq_len
            )
            y_range = max(p[1] for p in base_points) - min(p[1] for p in base_points)
            pts = [
                (
                    min(max(0, x + int(rng.integers(-5, 6))), seq_len - 1),
                    y + rng.uniform(-0.05, 0.05) * y_range,
                )
                for x, y in base_points
            ]
            _, curve, _ = trends_lib.generate_trend_curve(rng, seq_len, pts)
            if curve.max() - curve.min() > 1e-3:
                ts = ts + (
                    curve / (curve.max() - curve.min())
                    * pool["overall_amplitude"] * rng.uniform(3.0, 15.0)
                )
            metrics.append(metric)
            is_positive.append(True)
            series.append(ts)
            pools.append(pool)
            point_sets.append(pts)
        for metric in negatives:
            changes = [(None, None)] if rng.random() > 0.8 else []
            ts, pool = self._series_for_metric(
                metric, situation, SHAPE_CONFIG, changes, seq_len
            )
            pts, _ = trends_lib.generate_random_points(rng, seq_len)
            _, curve, _ = trends_lib.generate_trend_curve(rng, seq_len, pts)
            if curve.max() - curve.min() > 1e-3:
                ts = ts + (
                    curve / (curve.max() - curve.min())
                    * pool["overall_amplitude"] * rng.uniform(3.0, 15.0)
                )
            metrics.append(metric)
            is_positive.append(False)
            series.append(ts)
            pools.append(pool)
            point_sets.append(pts)

        order = rng.permutation(len(metrics))
        metrics = [metrics[i] for i in order]
        is_positive = [is_positive[i] for i in order]
        series = [series[i] for i in order]
        pools = [pools[i] for i in order]
        point_sets = [point_sets[i] for i in order]
        positive_idx = [i for i in range(len(metrics)) if is_positive[i]]

        label = {
            "timeseries": [t.tolist() for t in series],
            "label": {
                "clusters": [],
                "correlations": [],
                "cols": metrics,
                "situation": situation,
            },
            "attribute_pool": pools,
        }

        prompt = f"In a {situation} system, there are {len(metrics)} metrics:"
        questions, answers, llm_prompts, fields_list = [], [], [], []
        corr_pool = [None] * len(metrics)
        encoded = []
        for i in range(len(metrics)):
            scaled, frag, _ = timeseries_encoding(series[i], self.encoding_method)
            encoded.append(scaled)
            prompt += f"\n {metrics[i]} is of length {seq_len}: {frag};"

            for j in range(len(metrics)):
                if i == j:
                    continue
                if rng.random() < 0.8 and not (
                    i in positive_idx and j in positive_idx
                ):
                    continue
                questions.append(
                    f"From the perspective of the overall trend, do "
                    f"{metrics[i]} and {metrics[j]} have very similar trend "
                    f"characteristics? Answer yes or no and explain why they "
                    f"are correlated/no correlated considering their physical "
                    f"meaning in one sentence."
                )
                fields_list.append({"trend": [i, j]})
                hole = self._hole()
                if i in positive_idx and j in positive_idx:
                    ans = (
                        "Yes. Both metrics show similar trends: "
                        + trends_lib.generate_trend_prompt(point_sets[i])
                        + f" {hole}"
                    )
                    label["label"]["correlations"].append(
                        {"pair": [metrics[i], metrics[j]], "explain": hole,
                         "label": True}
                    )
                    hint = (
                        f"(Hint: These two metrics are both "
                        f"{metric_to_cluster.get(metrics[i])}-related.)"
                        if metric_to_cluster.get(metrics[i])
                        == metric_to_cluster.get(metrics[j]) else ""
                    )
                    llm_prompts.append([
                        f"In a {situation} system, metrics {metrics[i]} and "
                        f"{metrics[j]} show very similar overall trends. "
                        "Explain why in their physical meaning in English in "
                        "one simple sentence. " + hint
                    ])
                else:
                    ans = (
                        f"No. The trends of {metrics[i]} and {metrics[j]} "
                        f"look different. {hole}"
                    )
                    label["label"]["correlations"].append(
                        {"pair": [metrics[i], metrics[j]], "explain": hole,
                         "label": False}
                    )
                    llm_prompts.append([
                        f"In a {situation} system, metrics {metrics[i]} and "
                        f"{metrics[j]} show different overall trends. Explain "
                        "why their trends may differ in their physical "
                        "meaning in English in one simple sentence:"
                    ])
                answers.append(ans)

            # Cluster QA for positives.
            if i in positive_idx and not label["label"]["clusters"]:
                hole = self._hole()
                label["label"]["clusters"].append({
                    "col_idx": [
                        [int(j), pools[j]["trend"]["type"]] for j in positive_idx
                    ],
                    "cols": [metrics[j] for j in positive_idx],
                    "explain": hole,
                })
                questions.append(
                    f"From the perspective of the overall trend, which "
                    f"metric(s) have very similar trend characteristics with "
                    f"{metrics[i]}? List the metrics (including itself) and "
                    f"explain why in one sentence."
                )
                ans = ", ".join(metrics[j] for j in positive_idx) + f". {hole}"
                fields_list.append({"trend": list(positive_idx)})
                corr_pool[i] = [list(positive_idx), ans]
                llm_prompts.append([
                    f"In a {situation} system, metrics "
                    + ", ".join(metrics[j] for j in positive_idx)
                    + " all show very similar overall trends. Explain their "
                    "relationship in physical meaning in English in one "
                    "simple sentence:"
                ])
                answers.append(ans)

        item = {
            "prompt": prompt,
            "questions": questions,
            "answers": answers,
            "llm_prompts": llm_prompts,
            "fields": fields_list,
            "timeseries": encoded,
            "metrics": metrics,
            "attribute_pool": pools,
        }
        return item, label, corr_pool

    generate_dataset = MTSLocalLLMQAGenerator.generate_dataset


def write_outputs(rows, evol_labels, labels, output_path, evol_label_path,
                  label_path) -> int:
    for p in (output_path, evol_label_path, label_path):
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    with open(evol_label_path, "w") as f:
        json.dump(evol_labels, f, ensure_ascii=False, indent=4)
    with open(label_path, "w") as f:
        json.dump(labels, f, ensure_ascii=False, indent=4)
    return len(rows)
