"""TS-MLLM evaluation inference drivers + shard merging.

The port's copy of ``chatts_tpu/eval/inference.py``.

Replacement for the reference's eval inference stack
(reference: chatts/utils/inference_tsmllm_vllm.py:32-95,
inference_tsmllm_deepspeed.py:64-147, evaluation/evaluate_tsmllm_models.py:34-46):

* :func:`run_inference` — dataset_a-style JSON -> chat-templated prompts ->
  the serving engine (or any LLMClient) -> ``exp/{EXP}/generated_answer.json``
  with per-answer token accounting.
* Shard mode: ``shard_idx/num_shards`` splits samples ``i % num_shards``
  (the DeepSpeed rank-sharding analog) and writes per-shard files merged
  later by :func:`merge_shards`.
* :func:`evaluate_experiment` — merge shards by idx, score via
  evaluate_batch_qa, write result.json.

Defaults mirror the reference eval envelope: max_tokens 512, temperature 0.2
(inference_tsmllm_vllm.py:43-46).
"""
from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

CHAT_TEMPLATE = (
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>"
    "<|im_start|>user\n{prompt}<|im_end|><|im_start|>assistant\n"
)


def load_eval_dataset(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)


def run_inference(
    dataset: Sequence[dict],
    llm_client,
    exp: str,
    *,
    exp_root: str = "exp",
    shard_idx: int = 0,
    num_shards: int = 1,
    patch_size: Optional[int] = None,
) -> str:
    """Generate answers for (a shard of) the dataset; returns the output
    path.  Counts TS tokens as sum(len)/patch_size when patch_size is given
    (reference: inference_tsmllm_deepspeed.py:86)."""
    indices = [i for i in range(len(dataset)) if i % num_shards == shard_idx]
    prompts, ts_lists = [], []
    for i in indices:
        sample = dataset[i]
        prompts.append(CHAT_TEMPLATE.format(prompt=sample["question"]))
        ts_lists.append([np.asarray(t) for t in (sample.get("timeseries") or [])])

    t0 = time.perf_counter()
    answers = llm_client.llm_batch_generate(prompts, ts_lists)
    elapsed = time.perf_counter() - t0

    generated = []
    for idx, prompt, ts, answer in zip(indices, prompts, ts_lists, answers):
        num_tokens = len(prompt.split()) + len((answer or "").split())
        if patch_size:
            num_tokens += sum(len(t) for t in ts) // patch_size
        generated.append({
            "idx": idx,
            "question_text": prompt,
            "response": answer or "",
            "num_tokens": num_tokens,
        })

    out_dir = os.path.join(exp_root, exp)
    os.makedirs(out_dir, exist_ok=True)
    if num_shards > 1:
        out_path = os.path.join(
            out_dir, f"generated_answer_{num_shards}_{shard_idx}.json"
        )
    else:
        out_path = os.path.join(out_dir, "generated_answer.json")
    with open(out_path, "w") as f:
        json.dump(generated, f, ensure_ascii=False, indent=4)
    print(
        f"[inference] {len(generated)} answers in {elapsed:.1f}s "
        f"({len(generated) / max(elapsed, 1e-9):.2f} req/s) -> {out_path}"
    )
    return out_path


def merge_shards(exp: str, exp_root: str = "exp") -> List[dict]:
    """Merge all generated_answer*.json shards by idx (reference:
    evaluate_tsmllm_models.py:34-46)."""
    out_dir = os.path.join(exp_root, exp)
    merged: Dict[int, dict] = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "generated_answer*.json"))):
        with open(path) as f:
            for item in json.load(f):
                merged[item["idx"]] = item
    return [merged[i] for i in sorted(merged)]


def evaluate_experiment(
    dataset: Sequence[dict],
    exp: str,
    *,
    exp_root: str = "exp",
    num_workers: int = 8,
    judge=None,
) -> dict:
    """Merge shards + score (the evaluate_tsmllm_models entry point)."""
    from chatts_tpu_torch.eval.scorers import evaluate_batch_qa, null_judge

    generated = merge_shards(exp, exp_root)
    return evaluate_batch_qa(
        dataset, generated, exp,
        num_workers=num_workers,
        judge=judge or null_judge,
        exp_root=exp_root,
    )
