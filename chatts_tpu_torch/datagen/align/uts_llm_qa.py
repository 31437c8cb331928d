"""Univariate LLM-assisted alignment QA.

The port's copy of ``chatts_tpu/datagen/align/uts_llm_qa.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference pipeline
(reference: chatts/align/uts_llm_qa.py:46-253): metric-conditioned series,
answers composed of exact template text plus ``<|promptN|>`` holes that a
local LLM later fills with one-sentence physical-meaning explanations; emits
the dataset plus ``labels/`` (for IFT) and ``evol_labels/`` (for TSEvol).
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from chatts_tpu_torch.core.encoding import timeseries_encoding, timeseries_to_list
from chatts_tpu_torch.datagen.generator import TimeSeriesGenerator, attribute_to_text
from chatts_tpu_torch.datagen.metric_set import MetricSet
from chatts_tpu_torch.utils.llm_client import LLMClient

PROMPT_HOLE = re.compile(r"<\|prompt(\d+)\|>")


def replace_prompts(data: List[str], obj):
    """Recursively substitute ``<|promptN|>`` holes with generated text
    (reference: uts_llm_qa.py:46-56)."""
    if isinstance(obj, dict):
        return {k: replace_prompts(data, v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [replace_prompts(data, v) for v in obj]
    if isinstance(obj, str):
        return PROMPT_HOLE.sub(lambda m: data[int(m.group(1))], obj)
    return obj


class UTSLLMQAGenerator:
    def __init__(
        self,
        metric_set: Optional[MetricSet] = None,
        seed: int = 0,
        encoding_method: str = "no",
        seq_len: Optional[int] = None,
        disable_metric_config: bool = False,
        disable_extreme_lengths: bool = False,
    ):
        self.metric_set = metric_set or MetricSet.load()
        self.gen = TimeSeriesGenerator(seed=seed)
        self.encoding_method = encoding_method
        self.seq_len = seq_len
        self.disable_metric_config = disable_metric_config
        self.disable_extreme_lengths = disable_extreme_lengths
        self.prompt_idx = 0

    def _seq_len(self) -> int:
        if self.seq_len is not None:
            return self.seq_len
        from chatts_tpu_torch.datagen.align.uts_template_qa import sample_seq_len

        return sample_seq_len(self.gen, self.disable_extreme_lengths)

    def generate_prompt_data(self) -> List[dict]:
        """One series -> seed QA items with LLM-prompt holes
        (reference: uts_llm_qa.py:59-179)."""
        rng = self.gen.rng
        cur_len = self._seq_len()
        metrics = self.metric_set.all_metrics()
        metric = metrics[int(rng.integers(0, len(metrics)))]
        category = self.metric_set.category_of(metric)

        if self.disable_metric_config:
            pool = self.gen.generate_random_attributes(seq_len=cur_len)
        else:
            pool = self.gen.generate_controlled_attributes(
                self.metric_set.metric_to_controlled_attributes(metric),
                seq_len=cur_len,
            )
        pool["metric_name"] = metric
        pool["situation"] = category
        ts, pool = self.gen.generate(pool, cur_len)
        scaled_ts, ts_prompt, _ = timeseries_encoding(ts, self.encoding_method)

        instruction = (
            f"You are a time series analysis expert. This is a metric called "
            f"{metric} collected from {category} with length of {cur_len}: "
            f"{ts_prompt}."
        )
        questions, answers, prompts, fields = [], [], [], []

        # Periodicity QA with a physical-meaning hole.
        questions.append(
            "Now, please analyze the characteristics of this metric from the "
            "perspectives of periodicity, and conclude the physical meaning of "
            "the periodicity in one sentence."
        )
        fields.append({"seasonal": [0]})
        answers.append(
            attribute_to_text(
                ts, pool, generate_values=False,
                include_attributes=["periodicity", "frequency"],
            )
            + f"<|prompt{self.prompt_idx}|>"
        )
        prompts.append([
            f"There is a metric called {metric} collected from {category} with "
            f"length of {cur_len}. The periodicity of this metric is as "
            "follow: "
            + attribute_to_text(
                ts, pool, generate_values=False, include_attributes=["periodicity"]
            )
            + " Please analyze the physical meaning of this kind of "
            "periodicity in one sentence (xxx indicates that xxx):"
        ])
        self.prompt_idx += 1

        # Trend QA.
        questions.append(
            "Now, please analyze the characteristics of this metric from the "
            "perspectives of trend, and conclude the physical meaning of the "
            "trend in one sentence."
        )
        fields.append({"trend": [0]})
        answers.append(
            attribute_to_text(
                ts, pool, generate_values=False, include_attributes=["trend"]
            )
            + f"<|prompt{self.prompt_idx}|>"
        )
        prompts.append([
            f"There is a metric called {metric} collected from {category} with "
            f"length of {cur_len}. The trend of this metric is "
            f"{pool['trend']['type']}. Please analyze the physical meaning of "
            "this kind of trend in one sentence."
        ])
        self.prompt_idx += 1

        # Local-fluctuation QA: one hole per change.
        if pool.get("local"):
            questions.append(
                "Now, please analyze the characteristics of this metric from "
                "the perspectives of local fluctuations, and conclude the "
                "physical meaning of each in one sentence. Answer format: "
                "shake, position around point 125, amplitude 135.03. A sudden "
                "surge in public interest, likely due to significant news, a "
                "major event, or a trending topic related to the platform that "
                "rapidly captured user attention; small sudden decrease, "
                "position around point 102, amplitude 31.05. A slight increase "
                "in interest, possibly driven by minor news, promotions, or "
                "social media discussions that briefly captured attention "
                "without indicating a significant trend."
            )
            fields.append({"local": [0]})
            local_texts, local_prompts = [], []
            for c in pool["local"]:
                local_texts.append(
                    f"{c['type']}, position around point {c['position_start']}, "
                    f"amplitude {c['amplitude']:.2f}. "
                    f"<|prompt{self.prompt_idx}|>"
                )
                self.prompt_idx += 1
                local_prompts.append(
                    f"There is a metric called {metric} collected from "
                    f"{category} with length of {cur_len}. A local fluctuation "
                    f"of this metric is found. The type is {c['type']}. Please "
                    "analyze the physical meaning of this fluctuation in one "
                    "sentence (keep it simple, just output the physical "
                    "meaning itself, do not output any description words like "
                    "`the fluctuation of this metric`. Output Example: "
                    "indicates that there are many computational extensive "
                    "programs using CPU):"
                )
            answers.append(";".join(local_texts))
            prompts.append(local_prompts)

        return [
            {
                "instruction": instruction,
                "question": q,
                "answer": a,
                "fields": f,
                "prompt": p,
                "timeseries": [scaled_ts],
                "original_timeseries": [ts],
                "metrics": [metric],
                "attribute_pool": [pool],
                "corr_pool": [],
            }
            for q, a, p, f in zip(questions, answers, prompts, fields)
        ]

    def generate_dataset(
        self, num_data: int, llm_client: LLMClient
    ) -> Tuple[List[dict], List[dict], List[dict]]:
        """(dataset rows, evol_labels, labels) — reference:
        uts_llm_qa.py:182-231."""
        result: List[dict] = []
        prompts: List[str] = []
        cnt = 0
        while cnt < num_data:
            try:
                items = self.generate_prompt_data()
            except (ValueError, IndexError):
                continue
            for item in items:
                item["ts_idx"] = len(result)
                result.append(item)
                prompts.extend(item["prompt"])
                cnt += 1

        llm_answers = llm_client.llm_batch_generate(prompts)

        idx = 0
        for item in result:
            for _ in item["prompt"]:
                answer = llm_answers[idx] or ""
                item["answer"] = item["answer"].replace(f"<|prompt{idx}|>", answer)
                idx += 1

        rows, evol_labels, labels = [], [], []
        for item in result:
            rows.append({
                "input": item["instruction"].rstrip(".") + ". " + item["question"],
                "output": item["answer"],
                "timeseries": timeseries_to_list(item["timeseries"]),
                "ts_idx": item["ts_idx"],
                "fields": item["fields"],
            })
            evol_labels.append({
                "fields": item["fields"],
                "metrics": item["metrics"],
                "corr_pool": item["corr_pool"],
                "attribute_pool": item["attribute_pool"],
                "instruction": item["instruction"],
                "question": item["question"],
                "ts_idx": item["ts_idx"],
            })
            labels.append({
                "label": item["attribute_pool"][0],
                "ts_idx": item["ts_idx"],
                "timeseries": timeseries_to_list(item["original_timeseries"][0]),
            })
        return rows, evol_labels, labels


def main(
    output_path: str,
    label_path: str,
    evol_label_path: str,
    num_data: int = 50,
    seed: int = 0,
    llm_client: Optional[LLMClient] = None,
    **kw,
) -> int:
    import os

    llm_client = llm_client or LLMClient(
        engine="dryrun", dryrun_output="This is a test answer."
    )
    g = UTSLLMQAGenerator(seed=seed, **kw)
    rows, evol_labels, labels = g.generate_dataset(num_data, llm_client)
    for p in (output_path, label_path, evol_label_path):
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    with open(evol_label_path, "w") as f:
        json.dump(evol_labels, f, ensure_ascii=False, indent=4)
    with open(label_path, "w") as f:
        json.dump(labels, f, ensure_ascii=False, indent=4)
    return len(rows)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--output", default="data/uts_llm_qa.jsonl")
    p.add_argument("--labels", default="data/labels/uts_llm_qa.json")
    p.add_argument("--evol-labels", default="data/evol_labels/uts_llm_qa.json")
    p.add_argument("--num-data", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    n = main(args.output, args.labels, args.evol_labels, args.num_data, args.seed)
    print(f"wrote {n} rows")
