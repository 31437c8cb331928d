"""TSEvol: evolution-instruct dataset engine.

The port's copy of ``chatts_tpu/datagen/sft/tsevol.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference engine
(reference: chatts/sft/generate_tsevol_dataset.py:39-266): load seed QA
datasets + evol labels into EvolPrompt states, then DFS with branching
``dfs_k=3`` — each iteration mutates (``evol()`` unlocks one field), asks the
LLM to rewrite, then runs a validation pass (Equal/Invalid/Valid comparison)
before accepting + re-queueing children.

The reference's dual-queue multiprocess worker pool (validation prioritized)
becomes synchronous batched rounds over an ``LLMClient``: the outcome —
validated evolution with branching — is identical, while the TPU engine owns
batching internally.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from chatts_tpu_torch.datagen.sft.evol import EvolPrompt
from chatts_tpu_torch.utils.llm_client import LLMClient
from chatts_tpu_torch.utils.json_utils import parse_llm_json

DFS_K = 3  # branching factor (reference: generate_tsevol_dataset.py:51)


def _chat_wrap(prompt: str) -> str:
    return (
        "<|im_start|>system\nYou are a helpful assistant.<|im_end|>"
        f"<|im_start|>user\n{prompt}<|im_end|><|im_start|>assistant\n"
    )


def load_seeds(
    input_files: List[Tuple[str, str]],
    rng: Optional[np.random.Generator] = None,
) -> List[EvolPrompt]:
    """Load (dataset.jsonl, evol_labels.json) pairs into EvolPrompt seeds
    (reference: generate_tsevol_dataset.py:231-252)."""
    rng = rng or np.random.default_rng()
    seeds: List[EvolPrompt] = []
    for input_file, label_file in input_files:
        with open(input_file) as f:
            qa_dataset = [json.loads(line) for line in f if line.strip()]
        with open(label_file) as f:
            labels = json.load(f)
        for data, label in zip(qa_dataset, labels):
            seeds.append(
                EvolPrompt(
                    ts_idx=label["ts_idx"],
                    seed_q=label["question"],
                    seed_a=data["output"],
                    seed_fields=label["fields"],
                    instruction=label["instruction"],
                    timeseries=np.array(data["timeseries"]),
                    attribute_pool=label["attribute_pool"],
                    metrics=label["metrics"],
                    corr_pool=label["corr_pool"],
                    rng=rng,
                )
            )
    order = rng.permutation(len(seeds))
    return [seeds[i] for i in order]


class TSEvolEngine:
    def __init__(
        self,
        llm_client: LLMClient,
        dfs_k: int = DFS_K,
        use_chat_template: bool = True,
        rng: Optional[np.random.Generator] = None,
    ):
        self.llm = llm_client
        self.dfs_k = dfs_k
        self.use_chat_template = use_chat_template
        self.rng = rng or np.random.default_rng()
        self.parse_failed = 0
        self.validation_failed = 0

    def _wrap(self, prompt: str) -> str:
        return _chat_wrap(prompt) if self.use_chat_template else prompt

    def _expand(self, seeds: List[EvolPrompt]) -> List[Tuple[str, EvolPrompt]]:
        work = []
        for seed in seeds:
            for _ in range(self.dfs_k):
                child = seed.clone()
                child.evol()
                work.append((self._wrap(child.generate_prompt()), child))
        return work

    def run(
        self,
        seeds: List[EvolPrompt],
        total_cnt: int,
        output_file: Optional[str] = None,
    ) -> List[dict]:
        """DFS rounds until ``total_cnt`` validated QAs produced."""
        out_rows: List[dict] = []
        frontier = self._expand(seeds)
        fo = open(output_file, "w") if output_file else None
        try:
            while frontier and len(out_rows) < total_cnt:
                prompts = [p for p, _ in frontier]
                states = [s for _, s in frontier]
                answers = self.llm.llm_batch_generate(prompts)

                # Parse mutations; build validation prompts.
                to_validate: List[EvolPrompt] = []
                val_prompts: List[str] = []
                for raw, state in zip(answers, states):
                    qa = parse_llm_json(raw or "")
                    if not isinstance(qa, dict) or "question" not in qa or "answer" not in qa:
                        self.parse_failed += 1
                        continue
                    val_prompts.append(
                        self._wrap(
                            state.generate_comparison_prompt(
                                qa["question"], qa["answer"]
                            )
                        )
                    )
                    state.push(qa["question"], qa["answer"])
                    to_validate.append(state)

                verdicts = self.llm.llm_batch_generate(val_prompts)
                accepted: List[EvolPrompt] = []
                for verdict, state in zip(verdicts, to_validate):
                    v = (verdict or "").lower()
                    if "valid" in v and "invalid" not in v:
                        row = state.to_dataset()
                        out_rows.append(row)
                        if fo:
                            fo.write(json.dumps(row, ensure_ascii=False) + "\n")
                        accepted.append(state)
                        if len(out_rows) >= total_cnt:
                            break
                    else:
                        self.validation_failed += 1
                frontier = self._expand(accepted)
        finally:
            if fo:
                fo.close()
        return out_rows


def evol_instruct(
    input_files: List[Tuple[str, str]],
    output_file: str,
    total_cnt: int,
    llm_client: Optional[LLMClient] = None,
    seed: int = 0,
) -> List[dict]:
    """End-to-end TSEvol (reference: generate_tsevol_dataset.py:231-263)."""
    rng = np.random.default_rng(seed)
    llm_client = llm_client or LLMClient(
        engine="dryrun",
        dryrun_output=json.dumps(
            {"question": "This is a test question.", "answer": "This is a test answer."}
        ),
    )
    seeds = load_seeds(input_files, rng)
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    engine = TSEvolEngine(llm_client, rng=rng)
    return engine.run(seeds, total_cnt, output_file)
