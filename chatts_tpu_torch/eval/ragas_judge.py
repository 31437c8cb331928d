"""LLM answer-correctness judge (RAGAS-style, 2-step keyword matching).

The port's copy of ``chatts_tpu/eval/ragas_judge.py``.

Behavioral port of the reference's forked RAGAS metric
(reference: evaluation/ragas/metric.py:56-310, evaluation/ragas/score.py:22-42):

1. Extract 1-2 ``gt_keywords`` from the ground truth (cached in
   ``data/gt_cache.json`` under a file lock so re-runs are cheap and stable).
2. Ask the LLM which keywords overlap the model answer; fuzzy-match each
   claimed overlap against the gt list with difflib ratio >= 0.6.
3. Score = min(num_ok / num_all, 1.0); any error -> 0.0 with a warning,
   mirroring the reference's fallback.

No langchain/ragas dependency: the LLM is any callable ``prompt -> str``
(e.g. :class:`chatts_tpu_torch.eval.openai_client.OpenAIClient`).
"""
from __future__ import annotations

import difflib
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

from chatts_tpu_torch.utils.json_utils import parse_llm_json

LLMFn = Callable[[str], str]

GT_KEYWORDS_PROMPT = """Given a question and the ground truth, extract the following information:
"gt_keywords": Identify and return a list of keywords or phrases contained in the ground_truth. This list should only include the minimal combination of key points that directly answer the question, avoiding words unrelated to the question as much as possible. Only **1 or 2** keywords are needed in each list, and the keywords should be as concise as possible and **as short as possible**.

Example 1:
question: What protocol does AMF use to ensure correct time?
ground_truth: The role of NTP is to synchronize the time of all clocked devices within the network, ensuring that the clock times of all devices in the network remain basically consistent. Possible applicable network elements: AMF, MME, SGSN
Output: {{"gt_keywords": ["NTP"]}}

Example 2:
question: What is the purpose of MME assigning a TA List to UE?
ground_truth: The purpose of MME assigning a TA List to UE is to manage the location of idle UEs. After MME assigns a TA List to UE, the UE will not initiate a TA update to MME when moving within this TA List.
Output: {{"gt_keywords": ["manage the location of idle UEs"]}}

Now extract for:
question: {question}
ground_truth: {ground_truth}
Output only the JSON object."""

OVERLAP_PROMPT = """Given a question, an answer generated by the model, and the list of ground truth keywords (gt_keywords), extract the following information:
"overlapping_keywords": From the list of "gt_keywords", identify any terms or phrases that also appear in the model's answer. These overlapping keywords indicate the points of agreement or coverage between the model's answer and the ground truth.

Example 1:
question: What powers the sun and what is its primary function?
gt_keywords: ["nuclear fusion", "energy", "light"]
answer: The sun is powered by nuclear fission, and its primary function is to provide light to the solar system.
Output: {{"overlapping_keywords": ["light"]}}

Example 2:
question: What is the boiling point of water?
gt_keywords: ["100 degrees Celsius", "sea level"]
answer: The boiling point of water is 100 degrees Celsius at sea level.
Output: {{"overlapping_keywords": ["100 degrees Celsius", "sea level"]}}

Example 3:
question: What is the capital of France?
gt_keywords: ["Paris"]
answer: The capital of France is Paris.
Output: {{"overlapping_keywords": ["Paris"]}}

Now extract for:
question: {question}
gt_keywords: {gt_keywords}
answer: {answer}
Output only the JSON object."""


class KeywordCache:
    """File-backed ground-truth keyword cache with file locking
    (reference: ragas/metric.py:34-54)."""

    def __init__(self, data_dir: str = "data"):
        self.path = os.path.join(data_dir, "gt_cache.json")
        self.lock_path = self.path.replace(".json", ".lock")
        os.makedirs(data_dir, exist_ok=True)

    def _lock(self):
        try:
            from filelock import FileLock

            return FileLock(self.lock_path)
        except ImportError:  # degrade to no locking
            import contextlib

            return contextlib.nullcontext()

    def get(self, key: str) -> Optional[List[str]]:
        if not os.path.exists(self.path):
            return None
        with self._lock():
            with open(self.path) as f:
                return json.load(f).get(key)

    def put(self, key: str, value: List[str]) -> None:
        with self._lock():
            cache: Dict[str, List[str]] = {key: value}
            if os.path.exists(self.path):
                with open(self.path) as f:
                    cache.update(json.load(f))
            cache[key] = value
            with open(self.path, "w") as f:
                json.dump(cache, f, ensure_ascii=False, indent=4)


class AnswerCorrectnessJudge:
    """2-step keyword-overlap judge, callable as (question, response, label)."""

    def __init__(
        self,
        llm: LLMFn,
        data_dir: str = "data",
        keyword_matching_threshold: float = 0.6,
    ):
        self.llm = llm
        self.cache = KeywordCache(data_dir)
        self.threshold = keyword_matching_threshold

    def _gt_keywords(self, question: str, ground_truth: str) -> List[str]:
        key = (
            json.dumps(question, ensure_ascii=False)
            + "|||"
            + json.dumps(ground_truth, ensure_ascii=False)
        )
        cached = self.cache.get(key)
        if cached is not None:
            return cached
        raw = self.llm(
            GT_KEYWORDS_PROMPT.format(question=question, ground_truth=ground_truth)
        )
        parsed = parse_llm_json(raw) or {}
        keywords = parsed.get("gt_keywords")
        if not isinstance(keywords, list):
            keywords = []
        # Drop keywords that only echo the question (reference:
        # ragas/metric.py:82-86).
        keywords = [
            str(k)
            for k in keywords
            if str(k).lower() not in question.lower()
            or str(k).lower() in ground_truth.lower()
        ]
        self.cache.put(key, keywords)
        return keywords

    def _fuzzy_in(self, keywords: List[str], candidate: str) -> bool:
        return any(
            difflib.SequenceMatcher(None, k, candidate).ratio() >= self.threshold
            for k in keywords
        )

    def __call__(
        self, question: str, response: str, label: str
    ) -> Tuple[float, dict]:
        try:
            gt_keywords = [k.lower() for k in self._gt_keywords(question, label)]
            raw = self.llm(
                OVERLAP_PROMPT.format(
                    question=question,
                    gt_keywords=json.dumps(gt_keywords, ensure_ascii=False),
                    answer=response,
                )
            )
            parsed = parse_llm_json(raw) or {}
            overlapping = parsed.get("overlapping_keywords")
            if not isinstance(overlapping, list):
                overlapping = []
            overlapping = [str(k).lower() for k in overlapping]
            matched = [k for k in overlapping if self._fuzzy_in(gt_keywords, k)]
            detail = {
                "gt_keywords": "|".join(gt_keywords),
                "answer_keywords": "|".join(overlapping),
                "overlapping_keywords": "|".join(matched),
                "num_ok": len(matched),
                "num_all": len(gt_keywords),
            }
            if not gt_keywords:
                return 0.0, detail
            return min(len(matched) / len(gt_keywords), 1.0), detail
        except Exception as err:
            print(
                f"Warning: answer-correctness judge failed ({err}); check the "
                "LLM endpoint / API key. Returning 0.0."
            )
            return 0.0, {"error": str(err)}


def calculate_ragas_score(
    question: str, response: str, label: str, judge: Optional[AnswerCorrectnessJudge] = None
) -> Tuple[float, dict]:
    """Reference-named convenience wrapper (reference: ragas/score.py:22-42)."""
    if judge is None:
        return 0.0, {"error": "no judge configured"}
    return judge(question, response, label)
