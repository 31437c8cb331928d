"""Stage-2 seed QA generation via a local LLM.

The port's copy of ``chatts_tpu/datagen/sft/generate_llm_qa.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference pipeline
(reference: chatts/sft/generate_llm_qa.py:47-217): for each metric-conditioned
series, one of four tasks (``stl`` / ``local-all`` / ``statistic-all`` /
``statistic-part``) prompts an LLM to emit a JSON list of QA pairs with
reference fragments; parsed rows become the seed dataset + ``evol_labels/``
for TSEvol.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from chatts_tpu_torch.core.encoding import timeseries_encoding, timeseries_to_list
from chatts_tpu_torch.datagen.generator import TimeSeriesGenerator, attribute_to_text
from chatts_tpu_torch.datagen.metric_set import MetricSet
from chatts_tpu_torch.utils.json_utils import parse_llm_json
from chatts_tpu_torch.utils.llm_client import LLMClient

TASKS = ("stl", "local-all", "statistic-all", "statistic-part")

JSON_FOOTER = (
    'Now, please strictly follow the above requirements to generate as many '
    'QA pairs as possible, and include the reference text for the answers. '
    'Output in JSON format, for example: [{"question": "Strictly follow the '
    'task question 1", "answer": "Answer 1 found from the data", "reference": '
    '"Precise original text fragment for answer 1"}, {"question": "Strictly '
    'follow the task question 2", "answer": "Answer 2 found from the data", '
    '"reference": "Precise original text fragment for answer 2"}]. Please '
    'note that you need to ask questions in as many forms as possible, such '
    'as active-passive conversion, logical reasoning, multiple-choice '
    'questions, search questions, etc. However, the features in answers must '
    'be found from the original data, and the answers must be accurate. The '
    'generated QA pairs should not be repetitive, and the answers can be '
    'relatively long and rich, leaning towards human preferences. Specific '
    'time series feature must **not** be mentioned in the question (e.g., '
    'using words like "the spike of amplitude 50", "the sudden increase in '
    'the time series") as we will provide them. Just use words like '
    '"according to the time series" or "according to the values near point '
    '50". I hope you can ask questions by combining the physical meaning and '
    'scenarios of the metrics as much as possible, just like a professional '
    'analysis expert. '
)


class LLMQAGenerator:
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

    def generate_prompt_data(self) -> List[dict]:
        rng = self.gen.rng
        cur_len = self.seq_len or int(rng.integers(64, 1025))
        metrics = self.metric_set.all_metrics()
        metric = metrics[int(rng.integers(0, len(metrics)))]
        category = self.metric_set.category_of(metric)

        pool = self.gen.generate_controlled_attributes(
            self.metric_set.metric_to_controlled_attributes(metric),
            seq_len=cur_len,
        )
        ts, pool = self.gen.generate(pool, cur_len)
        scaled_ts, ts_prompt, _ = timeseries_encoding(ts, self.encoding_method)

        instruction = (
            f"You are a time series analysis expert. This is a metric called "
            f"{metric} collected from {category} with length of {cur_len}: "
            f"{ts_prompt}."
        )
        task = str(rng.choice(list(TASKS)))
        header = (
            "I am creating a dataset for a time series analysis large language "
            "model. Based on the information I provide about the time series, "
            "I need you to generate as many rich QA pairs as possible "
            "according to the specified task requirements. This will be used "
            "as training data for the large language model. Now, I have a "
            f"time series named {metric} from the {category} domain."
        )

        if task == "stl":
            field = {"trend": [0], "seasonal": [0], "noise": [0]}
            body = (
                "From the overall trend, periodicity, and noise "
                "characteristics, the description of this time series is as "
                "follows:"
                + attribute_to_text(
                    ts, pool,
                    include_attributes=["length", "trend", "periodicity",
                                        "frequency", "noise"],
                    generate_values=False,
                )
                + "Now, I need you to generate some questions and answers "
                "about this time series based on the information provided "
                "above. Some optional questions include: asking about the "
                "trend, periodicity, noise, etc., in different ways, and "
                "trying to combine the metric with the environment to ask "
                "comprehensive questions (e.g., asking about the trend of CPU "
                "Usage to explain what problem it is experiencing)."
            )
        elif task == "local-all":
            if not pool["local"]:
                raise ValueError("no local changes for local-all task")
            field = {"local": [0]}
            body = (
                "From the local fluctuations in ths time series, the "
                "description is as follows:"
                + attribute_to_text(
                    ts, pool, include_attributes=["local"], generate_values=False
                )
                + "Now, I need you to generate some questions and answers "
                "about this time series based on the information provided "
                "above. Some optional questions include: asking about the "
                "characteristics of different local features of the time "
                "series, or asking what kind of feature fluctuations occurred "
                "in a certain time interval (from point X to point Y), or "
                "asking whether a certain type of local fluctuation occurred, "
                "etc., in different ways, and trying to combine the metric "
                "with the environment to ask comprehensive questions."
            )
        elif task == "statistic-all":
            field = {"statistic": [0]}
            extra_points = ";".join(
                f"The value of point {int(i)} is {float(ts[int(i)]):.2f}"
                for i in rng.choice(cur_len, 5)
            )
            body = (
                "From the perspective of statistic, the information about this "
                "time series is:"
                + attribute_to_text(
                    ts, pool, include_attributes=["length"], generate_values=True
                )
                + "Some other information fyi: " + extra_points + ". "
                + "Now, I need you to generate some questions and answers "
                "about this time series based on the information provided "
                "above. Some optional questions include: asking about the "
                "max/min values, period values, the value of some of the data "
                "points above, etc., in different ways, and trying to combine "
                "the metric with the environment to ask comprehensive "
                "questions."
            )
        else:  # statistic-part
            field = {"statistic": [0]}
            start = int(rng.integers(0, cur_len - 10))
            end = min(start + int(rng.integers(5, 20)), cur_len)
            window = ts[start:end]
            body = (
                "From the perspective of period statistic, the information "
                "about this time series is:"
                f"In the time series data points from {start} to {end}, the "
                f"values are: "
                + ", ".join(f"{float(v):.2f}" for v in window)
                + f". During this period, the difference between the rightmost "
                f"and leftmost values is {float(window[-1] - window[0]):.2f}, "
                f"the maximum value is {float(np.max(window)):.2f}, the "
                f"minimum value is {float(np.min(window)):.2f}, the average "
                f"value is {float(np.mean(window)):.2f}, and the standard "
                f"deviation is {float(np.std(window)):.2f}."
                f"Now, I need you to generate some questions and answers about "
                f"this period of time series (between point {start} to point "
                f"{end}) based on the information provided above. Some "
                "optional questions include: asking about the max/min values, "
                "the shape of this period, the trend of this period, the "
                "value of some of the data points above, etc."
            )

        return [{
            "instruction": instruction,
            "prompt": header + body + JSON_FOOTER,
            "fields": field,
            "timeseries": [scaled_ts],
            "original_timeseries": [ts],
            "metrics": [metric],
            "attribute_pool": [pool],
            "corr_pool": [],
        }]

    def generate_dataset(
        self, total_cnt: int, llm_client: LLMClient
    ) -> Tuple[List[dict], List[dict]]:
        """(dataset rows, evol labels) — reference:
        generate_llm_qa.py:143-201."""
        result: List[dict] = []
        prompts: List[str] = []
        num_cnt = 0
        while len(result) < total_cnt:
            try:
                items = self.generate_prompt_data()
            except (ValueError, IndexError):
                continue
            for item in items:
                item["ts_idx"] = num_cnt
                result.append(item)
                prompts.append(item["prompt"])
            num_cnt += 1

        llm_answers = llm_client.llm_batch_generate(prompts)

        dataset, labels = [], []
        failed = 0
        for item, raw in zip(result, llm_answers):
            qa_list = parse_llm_json(raw or "")
            if not isinstance(qa_list, list):
                failed += 1
                continue
            for qa in qa_list:
                if not isinstance(qa, dict) or "question" not in qa:
                    continue
                dataset.append({
                    "input": item["instruction"] + qa["question"],
                    "output": qa.get("answer", ""),
                    "timeseries": timeseries_to_list(item["timeseries"]),
                })
                labels.append({
                    "instruction": item["instruction"],
                    "question": qa["question"],
                    "fields": item["fields"],
                    "ts_idx": item["ts_idx"],
                    "metrics": item["metrics"],
                    "corr_pool": item["corr_pool"],
                    "attribute_pool": item["attribute_pool"],
                })
        return dataset, labels


def main(
    output_path: str,
    evol_label_path: str,
    total_cnt: int = 50,
    seed: int = 0,
    llm_client: Optional[LLMClient] = None,
    **kw,
) -> int:
    llm_client = llm_client or LLMClient(
        engine="dryrun",
        dryrun_output='[{"question": "This is a test question.", '
                      '"answer": "This is a test answer."}]',
    )
    g = LLMQAGenerator(seed=seed, **kw)
    dataset, labels = g.generate_dataset(total_cnt, llm_client)
    for p in (output_path, evol_label_path):
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        for row in dataset:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    with open(evol_label_path, "w") as f:
        json.dump(labels, f, ensure_ascii=False, indent=4)
    return len(dataset)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--output", default="data/llm_qa.jsonl")
    p.add_argument("--evol-labels", default="data/evol_labels/llm_qa.json")
    p.add_argument("--num-data", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    print(f"wrote {main(args.output, args.evol_labels, args.num_data, args.seed)} rows")
