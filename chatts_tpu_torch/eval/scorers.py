"""Rule-based QA scorers + batch evaluation.

The port's copy of ``chatts_tpu/eval/scorers.py``: the same numpy code, so a seed
gives the same bits in both packages.

Behavioral port of the reference metric core
(reference: evaluation/evaluate_qa.py:27-573): numbered-answer splitting,
per-ability keyword/number matching with relative-error scores
max(0, 1 - |pred-label|/|label|), set-F1 cluster scorers, and the
categorical/numerical/reason aggregation schema.

Differences by design: ability dispatch is a registry dict (the reference
uses ``eval("evaluate_"+type)``), the LLM judge is an injected callable
(``judge(question, response, label) -> (score, detail)``) so the RAGAS client
(:mod:`chatts_tpu_torch.eval.ragas_judge`) is pluggable and tests can mock it —
mirroring the reference's error->0.0 fallback (ragas/score.py:38-40).
"""
from __future__ import annotations

import json
import multiprocessing
import os
import re
import sys
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

JudgeFn = Callable[[str, str, str], Tuple[float, dict]]


def null_judge(question: str, response: str, label: str) -> Tuple[float, dict]:
    """Fallback judge used when no LLM judge is configured: score 0.0,
    matching the reference's API-error fallback (ragas/score.py:38-40)."""
    return 0.0, {"error": "no judge configured", "label": label, "response": response}


_ABBREVIATIONS = ["max.", "eg.", "Mrs.", "Dr.", "Mr."]


def _protect_abbreviations(text: str) -> str:
    for abbr in _ABBREVIATIONS:
        text = text.replace(abbr, abbr.replace(".", "<DOT>"))
    return text


def split_sentences(text: str) -> List[str]:
    """Split on clause punctuation, protecting common abbreviations and
    decimals (reference: evaluate_qa.py:27-39)."""
    text = _protect_abbreviations(text)
    parts = re.split(r"[.!?。！？,;，；](?!\d)", text)
    return [p.strip().replace("<DOT>", ".") for p in parts if p.strip()]


def split_period_sentences(text: str) -> List[str]:
    """Split on full stops only (reference: evaluate_qa.py:41-53)."""
    text = _protect_abbreviations(text)
    parts = re.split(r"[.。](?!\d)", text)
    return [p.strip().replace("<DOT>", ".") for p in parts if p.strip()]


def match_metric_name(metric: str, sentence: str) -> bool:
    """Case/punctuation-insensitive containment (reference:
    evaluate_qa.py:55-60)."""
    strip = lambda s: re.sub(r"[^一-龥a-zA-Z]", "", s).lower()
    return strip(metric) in strip(sentence)


def _floats(sentence: str) -> List[float]:
    return [float(x) for x in re.findall(r"-?\d+\.?\d*", sentence)]


def _rel_score(pred: float, label: float) -> float:
    return max(0.0, min(1.0, 1.0 - abs(pred - label) / abs(label)))


# ---------------------------------------------------------------------------
# Per-ability scorers.  Each returns
# (categorical list, numerical list, reason list, reason-detail list).
# ---------------------------------------------------------------------------

def evaluate_trend(answer, attribute, cols, judge=null_judge):
    sentences = split_sentences(answer)
    if not sentences:
        return [0.0], [0.0], [], []
    first = sentences[0].lower()
    cate = (
        ("steady" in attribute["type"] and "steady" in sentences[0])
        or ("decrease" in attribute["type"] and "decreas" in first)
        or ("increase" in attribute["type"] and "increas" in first)
    )

    num: List[float] = []
    for sentence in sentences:
        nums = _floats(sentence)
        if not nums:
            continue
        if "start" in sentence:
            if abs(attribute["start"]) < 0.5:
                num.append(1.0 if abs(nums[0]) < 0.5 else 0.0)
            else:
                num.append(_rel_score(nums[0], attribute["start"]))
            break
    else:
        num.append(0.0)

    if attribute["type"] != "keep steady":
        for sentence in sentences:
            nums = _floats(sentence)
            if not nums:
                continue
            if "change value" in sentence or "from left to right" in sentence:
                if abs(attribute["amplitude"]) < 0.5:
                    num.append(1.0 if abs(nums[0]) < 0.5 else 0.0)
                else:
                    num.append(_rel_score(nums[0], attribute["amplitude"]))
                break
        else:
            num.append(0.0)
    return [cate], num, [], []


def evaluate_season(answer, attribute, cols, judge=null_judge):
    sentences = split_sentences(answer)
    if not sentences:
        return [0.0], [0.0], [], []
    first = sentences[0].lower()
    if "no" in attribute["type"]:
        cate = "no periodic" in first
    else:
        cate = "no" not in first and "periodic" in first

    num: List[float] = []
    if attribute["type"] != "no periodic fluctuation":
        for key, label in (("each period", attribute["period"]),
                           ("amplitude", attribute["amplitude"])):
            for sentence in sentences:
                nums = _floats(sentence)
                if not nums:
                    continue
                if key in sentence:
                    num.append(_rel_score(nums[0], label))
                    break
            else:
                num.append(0.0)
    return [cate], num, [], []


def evaluate_noise(answer, attribute, cols, judge=null_judge):
    sentences = split_sentences(answer)
    if not sentences:
        return [0.0], [0.0], [], []
    first = sentences[0].lower()
    if "almost no" in attribute["type"]:
        cate = "no noise" in first
    else:
        cate = "noisy" in first

    num: List[float] = []
    if "noisy" in attribute["type"]:
        for sentence in sentences:
            nums = _floats(sentence)
            if not nums:
                continue
            low = sentence.lower()
            if "standard" in low or "std" in low:
                num.append(_rel_score(nums[0], attribute["std"]))
                break
        else:
            num.append(0.0)
    return [cate], num, [], []


def _match_local_feature(answer: str, feat: dict):
    """Find the answer fact describing this local change; score position
    (64-point gate) and amplitude (reference: evaluate_qa.py:191-223)."""
    matched = False
    pos_score = 0.0
    amp_score = 0.0
    matched_fact = None
    types = feat["type"] if isinstance(feat["type"], list) else [feat["type"]]
    for fact in re.split(r"[;；]", answer):
        sentences = re.split(r"[，。,;；]", fact)
        if not any(t in sentences[0].lower() for t in types):
            continue
        for sentence in sentences:
            nums = _floats(sentence)
            if not nums:
                continue
            low = sentence.lower()
            if "position" in low or "around point" in low:
                if abs(nums[0] - feat["position"]) > 64:
                    continue
                pos_score = _rel_score(nums[0], feat["position"])
                matched = True
            if matched and "amplitude" in low:
                amp_score = _rel_score(nums[0], feat["amplitude"])
        if matched:
            matched_fact = fact
            break
    return matched, pos_score, amp_score, matched_fact


def evaluate_local(answer, attribute, cols, judge=null_judge):
    cate, num = [], []
    for feat in attribute:
        matched, pos_score, amp_score, _ = _match_local_feature(answer, feat)
        cate.append(matched)
        num.extend([pos_score, amp_score])
    return cate, num, [], []


def evaluate_local_inductive(answer, attribute, cols, judge=null_judge):
    cate, num, reason, details = [], [], [], []
    for feat in attribute:
        matched, pos_score, amp_score, fact = _match_local_feature(answer, feat)
        r, d = 0.0, {}
        if matched and fact is not None:
            response = split_period_sentences(fact)[-1]
            r, d = judge(
                "Please analyze the physical meaning of this local fluctuation "
                "in one sentence.",
                response,
                feat["explain"],
            )
            d = dict(d, label=feat["explain"], response=response)
        cate.append(matched)
        num.extend([pos_score, amp_score])
        reason.append(r)
        details.append(d)
    return cate, num, reason, details


def evaluate_shape_correlation_inductive(answer, attribute, cols, judge=null_judge):
    sentences = split_sentences(answer)
    if not sentences:
        return [False], [], [0.0], [{}]
    first = sentences[0].lower()
    cate = ("yes" in first) if attribute["label"] else ("no" in first)
    r, d = judge(
        "Explain why they are correlated/no correlated considering their "
        "physical meaning in one sentence.",
        sentences[-1],
        attribute["explain"],
    )
    return [cate], [], [r], [d]


def _parse_col_pairs(text: str, cols: Sequence[str]) -> set:
    out = set()
    for fact in text.split(";"):
        items = fact.strip().split(",")
        if len(items) == 2:
            for col in cols:
                if match_metric_name(col, items[0].strip()):
                    out.add((col, items[1].strip()))
    return out


def evaluate_local_correlation_inductive(answer, attribute, cols, judge=null_judge):
    sentences = split_period_sentences(answer)
    if not sentences:
        return [False], [], [0.0], [{}]
    first = sentences[0].lower()
    cate = False
    if attribute["label"]:
        if "yes" in first and len(sentences) > 1:
            label_cols = set(map(tuple, attribute["pair"]))
            if label_cols == _parse_col_pairs(sentences[1], cols):
                cate = True
    else:
        cate = "no" in first
    r, d = judge(
        "Explain why they are correlated/no correlated considering their "
        "physical meaning in one sentence.",
        sentences[-1],
        attribute["explain"],
    )
    return [cate], [], [r], [d]


def _set_f1(label_set: set, answer_set: set) -> float:
    tp = len(label_set & answer_set)
    fp = len(answer_set - label_set)
    fn = len(label_set - answer_set)
    if tp + fp + fn == 0:
        return 0.0
    return 2 * tp / (2 * tp + fp + fn)


def evaluate_shape_cluster_inductive(answer, attribute, cols, judge=null_judge):
    sentences = split_period_sentences(answer)
    if not sentences:
        return [0.0], [], [0.0], [{}]
    answer_cols = set()
    for fact in sentences[0].split(","):
        for col in cols:
            if match_metric_name(col, fact.strip()):
                answer_cols.add(col)
    cate = _set_f1(set(attribute["cols"]), answer_cols)
    r, d = judge(
        "Explain why they have similar overall trend considering their "
        "physical meaning in one sentence.",
        sentences[-1],
        attribute["explain"],
    )
    return [cate], [], [r], [d]


def evaluate_local_cluster_inductive(answer, attribute, cols, judge=null_judge):
    sentences = split_period_sentences(answer)
    if not sentences:
        return [0.0], [], [0.0], [{}]
    label_cols = set(zip(attribute["cols"], [i[1] for i in attribute["col_idx"]]))
    answer_cols = _parse_col_pairs(sentences[0], cols)
    cate = _set_f1(label_cols, answer_cols)
    r, d = judge(
        "Explain why they have similar local fluctuations considering their "
        "physical meaning in one sentence.",
        sentences[-1],
        attribute["explain"],
    )
    return [cate], [], [r], [d]


def evaluate_deductive(answer, attribute, cols, judge=null_judge):
    labels = split_sentences(attribute)
    sentences = split_sentences(answer)
    if labels and labels[0].lower().strip() in ("yes", "no"):
        first = sentences[0].lower().strip() if sentences else ""
        score = 1.0 if first == labels[0].lower().strip() else 0.0
        detail = {"label": labels[0], "response": sentences[0] if sentences else ""}
        return [], [], [score], [detail]
    score, detail = judge(
        "According to the previous information, please answer Yes or No and "
        "explain it in detail.",
        answer,
        attribute,
    )
    return [], [], [score], [detail]


def evaluate_causal(answer, attribute, cols, judge=null_judge):
    label = split_sentences(attribute)[0].lower().strip()
    answers = split_sentences(answer)
    choice = answers[0].lower().strip() if answers else ""
    score = 1.0 if match_metric_name(label, choice) else 0.0
    return [], [], [score], [{"label": label, "response": choice}]


def evaluate_mcq2(answer, attribute, cols, judge=null_judge):
    score = 1.0 if match_metric_name(attribute, answer) else 0.0
    return [], [], [score], [{"label": attribute, "response": answer}]


SCORER_REGISTRY: Dict[str, Callable] = {
    "trend": evaluate_trend,
    "season": evaluate_season,
    "noise": evaluate_noise,
    "local": evaluate_local,
    "local_inductive": evaluate_local_inductive,
    "shape_correlation_inductive": evaluate_shape_correlation_inductive,
    "local_correlation_inductive": evaluate_local_correlation_inductive,
    "shape_cluster_inductive": evaluate_shape_cluster_inductive,
    "local_cluster_inductive": evaluate_local_cluster_inductive,
    "deductive": evaluate_deductive,
    "causal": evaluate_causal,
    "MCQ2": evaluate_mcq2,
}


def ability_scorer(ability_type: str) -> Callable:
    key = ability_type.replace("-", "_")
    if key in SCORER_REGISTRY:
        return SCORER_REGISTRY[key]
    if ability_type in SCORER_REGISTRY:
        return SCORER_REGISTRY[ability_type]
    raise KeyError(f"Unknown ability type: {ability_type}")


# ---------------------------------------------------------------------------
# Answer splitting + per-sample evaluation
# ---------------------------------------------------------------------------

_NUMBERED = re.compile(
    r"(?:^|\n).*?\d+\.\s*(.*?)(?=\n.*?\d+\.|$)", re.MULTILINE | re.DOTALL
)


def split_numbered_answers(answer: str, num_questions: int) -> List[str]:
    """Extract numbered sub-answers with the reference's fallback heuristics
    (reference: evaluate_qa.py:443-471)."""
    answer_list = _NUMBERED.findall(answer)
    matched = min(len(answer_list), num_questions)

    if matched < num_questions and matched == 1:
        idx_pos = []
        for idx in range(1, num_questions + 1):
            sub = f"{idx}. "
            if sub in answer:
                idx_pos.append(answer.index(sub))
            else:
                break
        if len(idx_pos) == num_questions:
            idx_pos.append(len(answer))
            answer_list = [
                answer[idx_pos[i] + len(f"{i + 1}. ") : idx_pos[i + 1]]
                for i in range(num_questions)
            ]
    elif num_questions == 1 and matched == 1 and not answer_list[0].strip():
        answer_list[0] = answer.rstrip()
    return answer_list


def evaluate_qa(answer: str, sample: dict, judge: JudgeFn = null_judge) -> dict:
    """Score one generated answer against its labeled sample
    (reference: evaluate_qa.py:442-489)."""
    ability_types = sample["ability_types"]
    num_questions = len(sample["attributes"])
    answer_list = split_numbered_answers(answer, num_questions)
    matched = min(len(answer_list), num_questions)

    result: dict = {}
    for i, ability in enumerate(ability_types):
        scorer = ability_scorer(ability)
        cur_answer = answer_list[i] if i < matched else ""
        cate, num, reason, detail = scorer(
            cur_answer, sample["attributes"][i], sample.get("cols", []), judge
        )
        if ability in result:
            prev = result[ability]
            cate = prev[0] + cate
            num = prev[1] + num
            reason = prev[2] + reason
            detail = prev[3] + detail
        result[ability] = (cate, num, reason, detail)
    return result


def _process_sample(args):
    idx, sample, answer, judge = args
    try:
        return {
            "idx": idx,
            "label": sample.get("answer"),
            "response": answer,
            "evaluation": evaluate_qa(answer, sample, judge),
        }
    except Exception as err:  # reference policy: log and drop the sample
        import traceback

        traceback.print_exc()
        print(f"evaluation error on sample {idx}: {err}")
        return None


def fork_is_safe() -> bool:
    """Whether this process may fork its scoring workers.

    A forked child keeps only the thread that forked it.  A process that holds
    a CUDA context, or runs other threads (the serving engine's loop, the
    LLMClient's workers, an HTTP server), can leave the child waiting on a lock
    that a vanished thread held.  Then the scoring runs on threads instead.
    Torch is looked up in ``sys.modules`` so that asking imports nothing.
    """
    if threading.active_count() > 1:
        return False
    torch = sys.modules.get("torch")
    return torch is None or not torch.cuda.is_initialized()


def evaluate_batch_qa(
    dataset: Sequence[dict],
    generated_answer: Sequence[dict],
    exp: str,
    num_workers: int = 8,
    judge: JudgeFn = null_judge,
    exp_root: str = "exp",
) -> dict:
    """Batch-score a dataset; writes exp/{exp}/detailed_result.json and
    result.json with the reference's schema (reference:
    evaluate_qa.py:516-573).  ``num_workers`` > 1 scores in forked
    processes where :func:`fork_is_safe`, else on threads."""
    by_idx = {item["idx"]: item for item in generated_answer}
    tasks = [
        (idx, dataset[idx], by_idx[idx]["response"], judge)
        for idx in range(len(dataset))
        if idx in by_idx
    ]
    if num_workers > 1:
        if fork_is_safe():
            pool = ProcessPoolExecutor(max_workers=num_workers,
                                       mp_context=multiprocessing.get_context("fork"))
        else:
            pool = ThreadPoolExecutor(max_workers=num_workers)
        with pool:
            results = list(pool.map(_process_sample, tasks))
    else:
        results = [_process_sample(t) for t in tasks]

    detailed = [r for r in results if r is not None]
    ability_result = {"categorical": {}, "numerical": {}, "reason": {}}
    overall = {"categorical": [], "numerical": [], "reason": []}
    for r in detailed:
        for ability, (cate, num, reason, _) in r["evaluation"].items():
            for kind, values in (
                ("categorical", cate),
                ("numerical", num),
                ("reason", reason),
            ):
                ability_result[kind].setdefault(ability, []).extend(values)
                overall[kind].extend(values)

    total_tokens = sum(item.get("num_tokens", 0) for item in generated_answer)

    def mean(v):
        return round(float(np.mean(v)), 4) if len(v) else 0.0

    summary = {
        "detail_categorical": {k: mean(v) for k, v in ability_result["categorical"].items()},
        "detail_numerical": {k: mean(v) for k, v in ability_result["numerical"].items()},
        "detail_reason": {k: mean(v) for k, v in ability_result["reason"].items()},
        "overall_categorical": mean(overall["categorical"]),
        "overall_numerical": mean(overall["numerical"]),
        "overall_reason": mean(overall["reason"]),
        "consumed_tokens": total_tokens,
    }

    out_dir = os.path.join(exp_root, exp)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "detailed_result.json"), "w") as f:
        json.dump(detailed, f, ensure_ascii=False, indent=4, default=str)
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(summary, f, ensure_ascii=False, indent=4)
    return summary
