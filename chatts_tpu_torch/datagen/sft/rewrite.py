"""Rewrite-instruct pipeline: QA style mutations + validity judging.

The port's copy of ``chatts_tpu/datagen/sft/rewrite.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral re-implementation of the reference rewrite machinery
(reference: chatts/sft/utils/rewrite_prompt.py:22-170 and
chatts/sft/generate_rewrite_dataset.py:59-249): five rewrite mutations
(word-order / expansion / compression / translation-to-Chinese / scenario
change) applied to reasoning QAs, each validated by an LLM judge with the
Invalid(out of context) / Invalid(reveal information) / Invalid(meaning
changed) / Invalid(additional prompt) / Valid taxonomy before acceptance.

Runs on the same engine shape as TSEvol: synchronous batched rounds over an
LLMClient instead of the reference's multiprocess dual-queue pool.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from chatts_tpu_torch.datagen.sft.evol import attribute_prompt
from chatts_tpu_torch.utils.json_utils import parse_llm_json
from chatts_tpu_torch.utils.llm_client import LLMClient

REWRITE_INSTRUCTION = """You will act as a Q&A Rewriter for a time series question-answering system.

Objective: Rewrite the provided Q&A using the specified rewrite method while keeping the core meaning and accuracy intact. The result must stay logical, readable, and aligned with the CONTEXT information.

Instructions:
- **Time Series Attributes**: Use only information from CONTEXT; invent nothing beyond it.
- **Non-Text Elements**: Keep any non-text parts of #The Given Q&A# (tables, charts, code).
- **Content Integrity**: All essential information of #The Given Q&A# must survive the rewrite.

You SHOULD rewrite the Q&A by:
{}
The #Generated Q&A# must be reasonable and human-readable.
Never write the literal phrases '#The Given Q&A#', '#Generated Q&A#', 'given q&a', or 'rewritten q&a' inside #Generated Q&A#."""

CONSTRAINTS_INSTRUCTION = """
- **Logical Consistency**: The answer must follow from the question and agree with CONTEXT.
- **No time series details in Questions**: Questions stay generic about the series (no "noise of 0.5", no "spike near position 100"); specifics belong **only** in the answer, sourced from CONTEXT.
- **Cross-Verification**: Check every detail against CONTEXT.
- **No New Features or Names**: Only features and names defined in CONTEXT.
- **Unit and Start Information**: When units or starting values are given, the question must include them.
- **Preserve Core Meaning**: The rewrite keeps the original Q&A's essential meaning and information.
- **Output Format**: Respond in JSON only: {"question": "your rewritten question", "answer": "your rewritten answer"}. No task labels like '#Given Q&A#'.
- **No Additional Prompts in Question**: Never append instructions like "Please justify your answer" or "Please analyze step by step" to the question; keep it straightforward."""

COMPARISON_INSTRUCTION = """Here are two Q&A pairs, please evaluate if the second Q&A is a valid rewrite of the first Q&A.

A valid rewrite should meet the following requirements:
    1. All information about the time series in the **second** Q&A can be sourced from the CONTEXT section and not generated without CONTEXT.
    2. The question itself should not reveal any time series features. Avoid terms like noise of 0.5/spike near position 100/given the downward spike/etc **in the question** (but it can be in the answer).
    3. The core meaning and essential information from the first Q&A should be preserved in the second Q&A.
    4. The second Q&A **should not** contain any additional prompts or instructions in the last part of the question, such as "Please justify your answer" or "Please analyze step by step". The question should be straightforward.

The First Q&A: <FIRST>
The Second Q&A: <SECOND>

Your Judgement (Just answer: Invalid(out of context)/Invalid(reveal information)/Invalid(meaning changed)/Invalid(additional prompt)/Valid. No need to explain the reason.):"""


def create_word_order_prompt():
    return REWRITE_INSTRUCTION.format(
        "Rearrange the word order and sentence structure of both the question "
        "and answer while maintaining the original meaning. Change the "
        "sequence of phrases, clauses, or sentences to create a different "
        "flow. The answer should be in detail, in a step-by-step manner."
    ), (
        "The question format should maintain the same information but with "
        "rearranged word order and sentence structure."
    )


def create_expansion_prompt():
    return REWRITE_INSTRUCTION.format(
        "Expand the given Q&A by adding more detailed descriptions, "
        "explanations, and context grounded in CONTEXT. The answer should be "
        "in very detail, in a step-by-step manner."
    ), (
        "The question format should be expanded with more detailed "
        "descriptions and context while keeping the core question intact."
    )


def create_compression_prompt():
    return REWRITE_INSTRUCTION.format(
        "Simplify and compress ONLY the question, as if written by a user "
        "unskilled in prompt engineering. IMPORTANT: keep the answer "
        "unchanged — only compress the question. The answer should be in "
        "very detail, in a step-by-step manner."
    ), (
        "The question format should be simplified and compressed, using "
        "simpler language and shorter sentences."
    )


def create_translation_prompt():
    return REWRITE_INSTRUCTION.format(
        "Translate both the question and answer. If the current language is "
        "English, translate to Chinese. If already Chinese, keep Chinese but "
        "vary the ordering. Maintain technical accuracy. The answer should "
        "be in very detail in Chinese, in a step-by-step manner, from "
        "reasoning to answer."
    ), (
        "The question format should be translated to the target language "
        "while preserving all technical details and meaning."
    )


def create_scenario_prompt():
    return REWRITE_INSTRUCTION.format(
        "Change the scenario/context of the Q&A while keeping the time "
        "series analysis content the same (e.g., IT operations -> "
        "manufacturing, finance, healthcare). The answer should be in "
        "detail, in a step-by-step manner."
    ), (
        "The question format should present the same time series analysis in "
        "a different real-world scenario or domain context."
    )


REWRITE_BUILDERS = [
    create_word_order_prompt,
    create_expansion_prompt,
    create_compression_prompt,
    create_translation_prompt,
    create_scenario_prompt,
]


class RewritePrompt:
    """Rewrite state over one seed QA (reference: rewrite_prompt.py:93-170)."""

    def __init__(
        self,
        ts_idx: int,
        seed_q: str,
        seed_a: str,
        seed_fields: Dict[str, List[int]],
        instruction: str,
        timeseries,
        attribute_pool: List[dict],
        metrics: List[str],
        corr_pool,
        rng: Optional[np.random.Generator] = None,
    ):
        self.ts_idx = ts_idx
        self.timeseries = timeseries
        self.attribute_pool = attribute_pool
        self.instruction = instruction
        self.metrics = metrics
        self.corr_pool = list(corr_pool)
        self.fields = seed_fields
        self.rng = rng or np.random.default_rng()
        self.qa = (seed_q, seed_a)

    def _context(self) -> str:
        return attribute_prompt(
            self.timeseries, self.attribute_pool, self.metrics,
            self.fields, self.corr_pool,
        )

    def generate_prompt(self) -> str:
        builder = REWRITE_BUILDERS[int(self.rng.integers(0, len(REWRITE_BUILDERS)))]
        prompt, question_format = builder()
        given = json.dumps({"question": self.qa[0], "answer": self.qa[1]})
        return (
            f"{prompt}\n\n#Context#\n{self._context()}\n\n#Constraints#\n"
            f"{CONSTRAINTS_INSTRUCTION}\n\n#The Given Q&A#\n{given}\n\n"
            f"#Question Format#\n{question_format}\n\n#Generated Q&A#:"
        )

    def generate_comparison_prompt(self, q: str, a: str) -> str:
        given = json.dumps({"question": self.qa[0], "answer": self.qa[1]})
        generated = json.dumps({"question": q, "answer": a})
        body = COMPARISON_INSTRUCTION.replace("<FIRST>", given).replace(
            "<SECOND>", generated
        )
        return f"#Context#\n{self._context()}\n\n#Your Task#\n{body}"

    def to_dataset(self, q: str, a: str) -> dict:
        ts = self.timeseries
        if isinstance(ts, np.ndarray):
            ts = ts.tolist()
        return {
            "input": self.instruction + " " + q,
            "output": a,
            "timeseries": ts,
            "ts_idx": self.ts_idx,
            "fields": sorted(self.fields),
        }


def rewrite_dataset(
    seeds: List[RewritePrompt],
    total_cnt: int,
    llm_client: LLMClient,
    output_file: Optional[str] = None,
) -> List[dict]:
    """Batched rewrite rounds with validity judging (reference:
    generate_rewrite_dataset.py:186-249)."""
    rows: List[dict] = []
    fo = None
    if output_file:
        os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
        fo = open(output_file, "w")
    try:
        frontier = list(seeds)
        while frontier and len(rows) < total_cnt:
            prompts = [s.generate_prompt() for s in frontier]
            raw = llm_client.llm_batch_generate(prompts)
            to_validate: List[Tuple[RewritePrompt, dict]] = []
            val_prompts: List[str] = []
            for state, out in zip(frontier, raw):
                qa = parse_llm_json(out or "")
                if not isinstance(qa, dict) or "question" not in qa or "answer" not in qa:
                    continue
                to_validate.append((state, qa))
                val_prompts.append(
                    state.generate_comparison_prompt(qa["question"], qa["answer"])
                )
            verdicts = llm_client.llm_batch_generate(val_prompts)
            next_frontier: List[RewritePrompt] = []
            for (state, qa), verdict in zip(to_validate, verdicts):
                v = (verdict or "").lower()
                if "valid" in v and "invalid" not in v:
                    row = state.to_dataset(qa["question"], qa["answer"])
                    rows.append(row)
                    if fo:
                        fo.write(json.dumps(row, ensure_ascii=False) + "\n")
                    # Continue rewriting from the accepted version.
                    state.qa = (qa["question"], qa["answer"])
                    next_frontier.append(state)
                    if len(rows) >= total_cnt:
                        break
            frontier = next_frontier
    finally:
        if fo:
            fo.close()
    return rows
